"""Channel-batched non-coherent M-FSK demodulator.

Algorithm re-derived from the codec2 fsk modem the reference pipes IQ through
(reference utils/fsk.c: fsk_demod_freq_est :438-590, fsk_demod_core :593-915),
re-structured for XLA:

* **Real-valued IQ planes.** IQ is carried as float32 ``[C, 2, T]``
  (re/im planes), not complex64, so every spectral transform is a real
  matmul.  ``complex64`` input is accepted and split at the boundary.
* **DFT as matmul.** The reference's kiss-FFT frequency estimator
  (fsk.c:465-503) becomes one batched matmul against precomputed
  windowed-DFT matrices ``[ndft, ndft]`` (Ndft = fs/(0.1·Rs) rounded to
  2^k, typically 128–1024), run at ``Precision.HIGHEST`` (exact f32, the
  precision the PER gates were validated at).
* **Static shapes.** The reference adapts its per-call sample count
  ``nin = N±Ts/2`` to track the sample clock (fsk.c:724-731).  Here every
  block is a fixed ``Nmem``-sample window gathered by ``dynamic_slice`` at a
  per-channel pointer that advances by ``nin`` — same clock tracking, fixed
  shapes.
* **Batch over channels.** All state (spectral EMA ``Sf``, timing, ppm,
  pointer) has a leading ``[C]`` axis; one ``lax.scan`` over time blocks
  demodulates every channel in lockstep.
* **Tone integration as dense math.** Per-tone downconversion + integrate-
  and-dump at P timing offsets (fsk.c:644-668) becomes: NCO rotate
  (sin/cos), segment partial sums (reshape+reduce), and a P-term
  shifted-slice sum — no per-sample loops.  Only magnitudes are consumed
  downstream, so the reference's carried oscillator phase ``phi_c`` (only
  needed for click-free streaming audio in C) drops out.

Soft-decision conventions match the reference exactly so that frames can be
validated bit-for-bit against the reference decoders:
2FSK: ``sd = |tone0| - |tone1|`` (positive ⇒ bit 0, fsk.c:792);
4FSK: sum form of fsk.c:794-803 (positive ⇒ bit 1).
"""

from dataclasses import dataclass
from functools import partial
import math

import numpy as np
import jax
import jax.numpy as jnp


@dataclass(frozen=True)
class FSKConfig:
    """Static demod parameters (hashable: used as a jit static argument)."""

    fs: int                 # sample rate, Hz
    rs: int                 # symbol rate, baud
    m: int = 2              # tones (2 or 4)
    p: int = 8              # integrate-and-dump offsets per symbol
    nsym: int = 50          # symbols per processing block
    est_min: int = 0        # tone-search window, Hz (may be negative for IQ)
    est_max: int = 0        # 0,0 -> defaults to ±fs/2
    tone_spacing: int = 0   # known tone spacing (Hz) for the mask estimator
    freq_est_type: int = 0  # 0: M-peak picking; 1: mask correlation

    def __post_init__(self):
        assert self.fs % self.rs == 0, "Ts = fs/rs must be integer"
        assert (self.fs // self.rs) % self.p == 0, "Ts/P must be integer"
        assert self.m in (2, 4)
        if self.freq_est_type == 1:
            assert self.tone_spacing > 0, "mask estimator needs tone_spacing"

    # ---- derived sizes (all Python ints: static under jit) ----
    @property
    def ts(self) -> int:            # samples per symbol
        return self.fs // self.rs

    @property
    def tsp(self) -> int:           # samples per timing offset
        return self.ts // self.p

    @property
    def n(self) -> int:             # nominal samples per block
        return self.ts * self.nsym

    @property
    def nmem(self) -> int:          # window memory: N + 2 symbols (fsk.c:149)
        return self.n + 2 * self.ts

    @property
    def ndft(self) -> int:          # est FFT size: bins within 10% of Rs (fsk.c:134-137)
        return int(2 ** math.ceil(math.log2(self.fs / (0.1 * self.rs))))

    @property
    def tc(self) -> float:          # spectral EMA coefficient (fsk.c:148)
        return 0.95 * self.ndft / self.fs

    @property
    def est_space_bins(self) -> int:  # peak blanking half-width (fsk.c:158,463)
        return int((0.75 * self.rs) * self.ndft / self.fs)

    @property
    def numffts(self) -> int:       # FFT hops per block (fsk.c:465)
        return self.n // (self.ndft // 2) - 1

    @property
    def bits_per_symbol(self) -> int:
        return 1 if self.m == 2 else 2

    @property
    def est_range(self):            # (st, en) search bins after fftshift
        emin = self.est_min
        emax = self.est_max
        if emin == 0 and emax == 0:
            emin, emax = -self.fs // 2, self.fs // 2
        st = max(0, (emin * self.ndft) // self.fs + self.ndft // 2)
        en = min(self.ndft, (emax * self.ndft) // self.fs + self.ndft // 2)
        return st, en

    @property
    def block_advance_max(self) -> int:
        return self.n + self.ts // 2


def iq_planes(x) -> jnp.ndarray:
    """Normalize IQ input to float32 [C, 2, T] (re, im planes).

    Accepts complex64 [C, T] / [T], or already-split [C, 2, T].
    Host (numpy) complex input is split on the host into the planes
    layout the device code consumes.
    """
    if np.iscomplexobj(x) and not isinstance(x, jnp.ndarray):
        x = np.atleast_2d(np.asarray(x))
        return jnp.asarray(
            np.stack([x.real, x.imag], axis=1).astype(np.float32))
    if jnp.iscomplexobj(x):
        if x.ndim == 1:
            x = x[None, :]
        return jnp.stack([x.real, x.imag], axis=1).astype(jnp.float32)
    x = jnp.asarray(x)
    assert x.ndim == 3 and x.shape[1] == 2, "real input must be [C, 2, T]"
    # bf16 planes pass through (the channelizer's forced-bf16 output —
    # storage dtype only; demod math upcasts to f32)
    if x.dtype == jnp.bfloat16:
        return x
    return x.astype(jnp.float32)


# Per-channel demod carry: a plain dict pytree with keys
#   sf [C, ndft], timing [C], ppm [C], ptr [C], nin [C].
FSKState = dict


def fsk_init_state(cfg: FSKConfig, channels: int) -> FSKState:
    return dict(
        sf=jnp.zeros((channels, cfg.ndft), jnp.float32),
        timing=jnp.zeros((channels,), jnp.float32),
        ppm=jnp.zeros((channels,), jnp.float32),
        ptr=jnp.full((channels,), cfg.nmem, jnp.int32),
        nin=jnp.full((channels,), cfg.n, jnp.int32),
    )


# ----------------------------------------------------------------------------
# windowed-DFT matrices (host precompute; fftshifted columns)
# ----------------------------------------------------------------------------

def _dft_mats(cfg: FSKConfig):
    """Windowed DFT as two real matmul operands [ndft, ndft]:
    X_re = xr @ Wc + xi @ Ws ;  X_im = xi @ Wc - xr @ Ws
    for X_k = sum_n w_n x_n e^{-2πi n k / N}, columns fftshifted."""
    n = cfg.ndft
    # hann window, symmetric (fsk.c:451: 0.5 - 0.5 cos(2πn/(N-1)))
    idx = np.arange(n)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * idx / (n - 1))
    k = np.concatenate([np.arange(-n // 2, 0), np.arange(0, n // 2)])
    # column order after fftshift: bin b corresponds to freq (b - n/2)
    kcol = np.arange(n) - n // 2
    ang = 2 * np.pi * np.outer(idx, kcol) / n
    wc = (win[:, None] * np.cos(ang)).astype(np.float32)
    ws = (win[:, None] * np.sin(ang)).astype(np.float32)
    return wc, ws


# ----------------------------------------------------------------------------
# frequency estimation
# ----------------------------------------------------------------------------

def _freq_est(cfg: FSKConfig, xw: jnp.ndarray, sf: jnp.ndarray):
    """Update spectral EMA and estimate the M tone frequencies.

    xw: [C, 2, nmem] float32 window;  sf: [C, ndft] EMA carry.
    Returns (f_est [C, M] in Hz, new sf).
    """
    C = xw.shape[0]
    ndft, half = cfg.ndft, cfg.ndft // 2
    nf = cfg.numffts

    # DFT hops over the newest N samples (the reference FFTs the new nin
    # samples only, fsk.c:465-468).
    starts = (cfg.nmem - cfg.n) + np.arange(nf) * half            # [nf]
    wc, ws = _dft_mats(cfg)

    # Exact closed form of the per-hop EMA Sf = Sf*(1-tc) + tc*mag (fsk.c:500)
    tc = cfg.tc
    decay = np.float32((1.0 - tc) ** nf)
    w = (tc * (1.0 - tc) ** (nf - 1 - np.arange(nf))).astype(np.float32)

    # hop windows as static slices (no gather)
    segs = jnp.stack([xw[:, :, int(s):int(s) + ndft]
                      for s in starts], axis=2)                   # [C, 2, nf, ndft]
    xr, xi = segs[:, 0], segs[:, 1]                               # [C, nf, ndft]
    wcj = jnp.asarray(wc)
    wsj = jnp.asarray(ws)
    # Precision: HIGHEST (exact f32) for the DFT and the EMA weighting
    dft = partial(jnp.einsum, "cnd,de->cne",
                  precision=jax.lax.Precision.HIGHEST)
    x_re = dft(xr, wcj) + dft(xi, wsj)
    x_im = dft(xi, wcj) - dft(xr, wsj)
    mag = jnp.sqrt(x_re * x_re + x_im * x_im)                     # [C, nf, ndft]
    sf_new = sf * decay + jnp.einsum("cnd,n->cd", mag, jnp.asarray(w),
                                     precision=jax.lax.Precision.HIGHEST)

    st, en = cfg.est_range
    bins = np.arange(ndft)
    valid = jnp.asarray((bins >= st) & (bins < en))

    if cfg.freq_est_type == 1:
        f_est = _mask_estimate(cfg, sf_new, st, en)
    else:
        f_est = _peak_estimate(cfg, sf_new, valid)
    return f_est, sf_new


def _peak_estimate(cfg: FSKConfig, sf: jnp.ndarray, valid: jnp.ndarray):
    """M peaks with ±est_space blanking, sorted ascending (fsk.c:508-546)."""
    ndft = cfg.ndft
    f_zero = cfg.est_space_bins
    bins = jnp.arange(ndft)
    s = jnp.where(valid[None, :], sf, -1.0)
    peaks = []
    for _ in range(cfg.m):
        imax = jnp.argmax(s, axis=-1)                             # [C]
        peaks.append(imax)
        blank = (bins[None, :] >= imax[:, None] - f_zero) & (
            bins[None, :] < imax[:, None] + f_zero)
        s = jnp.where(blank, 0.0, s)
    freqi = jnp.stack(peaks, axis=-1) - ndft // 2                 # [C, M]
    freqi = jnp.sort(freqi, axis=-1)
    return freqi.astype(jnp.float32) * (cfg.fs / ndft)


def _mask_estimate(cfg: FSKConfig, sf: jnp.ndarray, st: int, en: int):
    """Correlate Sf with a comb at known tone spacing (fsk.c:549-581)."""
    ndft = cfg.ndft
    # comb bin offsets: 0..2 plus round(m*spacing*ndft/fs)-1 .. +1+2
    offs = [0, 1, 2]
    bin_last = 0
    for mm in range(1, cfg.m):
        b = int(round(mm * cfg.tone_spacing * ndft / cfg.fs)) - 1
        offs += [b, b + 1, b + 2]
        bin_last = b
    len_mask = bin_last + 3
    nb = en - len_mask - st
    assert nb > 0, "est range too narrow for mask correlator"
    corr = jnp.zeros((sf.shape[0], nb), jnp.float32)
    for o in set(offs):
        corr = corr + jax.lax.dynamic_slice_in_dim(sf, st + o, nb, axis=1)
    b_max = jnp.argmax(corr, axis=-1) + st                        # [C]
    foff = (b_max - ndft // 2).astype(jnp.float32) * (cfg.fs / ndft)
    m_idx = jnp.arange(cfg.m, dtype=jnp.float32)
    return foff[:, None] + m_idx[None, :] * cfg.tone_spacing


# ----------------------------------------------------------------------------
# block demod core
# ----------------------------------------------------------------------------

def fsk_demod_block(cfg: FSKConfig, xw: jnp.ndarray, state: FSKState,
                    probe: bool = False):
    """Demodulate one window.

    xw: [C, 2, nmem] float32 IQ planes.
    Returns (out dict, new partial state).  out contains:
      soft  [C, nsym*bps] float32 soft decisions (reference sign conventions)
      bits  [C, nsym*bps] uint8 hard bits
      f_est [C, M], ebno_db [C], ppm [C], nin_next [C]
    """
    C = xw.shape[0]
    M, P, nsym = cfg.m, cfg.p, cfg.nsym
    # planes may arrive in bf16 (storage dtype); all demod math is f32 —
    # the upcast fuses into the first consumer, costing no extra HBM pass
    xw = xw.astype(jnp.float32)

    f_est, sf_new = _freq_est(cfg, xw, state["sf"])
    xr, xi = xw[:, 0], xw[:, 1]                                   # [C, nmem]

    # --- tone downconvert + integrate-and-dump (fsk.c:644-668) ---
    # The NCO phase is factored as t = a*tsp + b so e^{-2πi f t} =
    # e^{-2πi f a·tsp} · e^{-2πi f b}: the tsp-integrated micro-mix uses
    # only ``tsp`` trig values per (channel, tone), and the coarse
    # rotation needs trig at ``nps`` points — tsp-fold fewer
    # transcendentals than evaluating cos/sin at every sample.
    # Identical math.
    nps = cfg.nmem // cfg.tsp                                     # = (nsym+2)*P
    k = f_est / np.float32(cfg.fs)                                # [C, M]
    xr2 = xr.reshape(C, 1, nps, cfg.tsp)
    xi2 = xi.reshape(C, 1, nps, cfg.tsp)
    b = jnp.arange(cfg.tsp, dtype=jnp.float32)
    phb = k[:, :, None] * b[None, None, :]
    phb = phb - jnp.floor(phb)                                    # [0, 1)
    angb = (2.0 * np.pi) * phb                                    # [C, M, tsp]
    cb, sb = jnp.cos(angb)[:, :, None, :], jnp.sin(angb)[:, :, None, :]
    ur = (xr2 * cb + xi2 * sb).sum(-1)                            # [C, M, nps]
    ui = (xi2 * cb - xr2 * sb).sum(-1)
    # coarse rotation e^{-2πi f a·tsp}: built as the outer product of
    # two short trig tables (a = a2*Q + r): trig at nA+Q ≈ 2√nps points
    # combined with complex multiplies (a few flops) instead of nps
    # transcendentals.  Same phase, same math.
    Q = max(1, int(np.sqrt(nps)))
    nA = -(-nps // Q)
    aA = jnp.arange(nA, dtype=jnp.float32) * np.float32(Q * cfg.tsp)
    phA = k[:, :, None] * aA[None, None, :]
    phA = phA - jnp.floor(phA)
    angA = (2.0 * np.pi) * phA
    cA, sA = jnp.cos(angA), jnp.sin(angA)                         # [C, M, nA]
    aR = jnp.arange(Q, dtype=jnp.float32) * np.float32(cfg.tsp)
    phR = k[:, :, None] * aR[None, None, :]
    phR = phR - jnp.floor(phR)
    angR = (2.0 * np.pi) * phR
    cR, sR = jnp.cos(angR), jnp.sin(angR)                         # [C, M, Q]
    ca = (cA[:, :, :, None] * cR[:, :, None, :] -
          sA[:, :, :, None] * sR[:, :, None, :]).reshape(C, M, nA * Q)
    sa = (sA[:, :, :, None] * cR[:, :, None, :] +
          cA[:, :, :, None] * sR[:, :, None, :]).reshape(C, M, nA * Q)
    ca, sa = ca[:, :, :nps], sa[:, :, :nps]
    ps_re = ca * ur + sa * ui                                     # [C, M, nps]
    ps_im = ca * ui - sa * ur
    ni = (nsym + 1) * P
    fi_re = ps_re[:, :, 0:ni]
    fi_im = ps_im[:, :, 0:ni]
    for pp in range(1, P):
        fi_re = fi_re + ps_re[:, :, pp:pp + ni]                   # [C, M, ni]
        fi_im = fi_im + ps_im[:, :, pp:pp + ni]

    # --- fine timing from the |.|^2 spectral line at Rs (fsk.c:677-708) ---
    ft1 = jnp.sum(fi_re * fi_re + fi_im * fi_im, axis=1)          # [C, ni]
    rot = np.exp(2j * np.pi / P * np.arange(ni))
    rot_re = jnp.asarray(rot.real.astype(np.float32))
    rot_im = jnp.asarray(rot.imag.astype(np.float32))
    tc_re = jnp.sum(ft1 * rot_re[None, :], axis=-1)
    tc_im = jnp.sum(ft1 * rot_im[None, :], axis=-1)
    norm_timing = jnp.arctan2(tc_im, tc_re) / (2.0 * np.pi)       # [-0.5, 0.5]
    rx_timing = norm_timing * P

    # --- sample clock tracking (fsk.c:713-731) ---
    d_norm = norm_timing - state["timing"]
    appm = 1e6 * d_norm / nsym
    ppm = jnp.where(jnp.abs(d_norm) < 0.2,
                    0.9 * state["ppm"] + 0.1 * appm, state["ppm"])
    nin_next = (cfg.n
                + (norm_timing > 0.25).astype(jnp.int32) * (cfg.ts // 2)
                - (norm_timing < -0.25).astype(jnp.int32) * (cfg.ts // 2))

    # --- resample integrators at the timing estimate (fsk.c:737-757) ---
    # low = floor(rx_timing) only spans [-(P//2+1), P//2], so instead of a
    # per-channel gather take every candidate shift as a static strided
    # slice and select: same numerics, pure elementwise ops.
    low = jnp.floor(rx_timing).astype(jnp.int32)                  # [C]
    fract = rx_timing - low.astype(jnp.float32)
    lo_min, lo_max = -(P // 2 + 1), P // 2
    low = jnp.clip(low, lo_min, lo_max)
    # candidate s: v[c, m, k] = fi[c, m, (k+1)*P + s] for k in [0, nsym)
    fi_re_s = fi_re.reshape(C, M, nsym + 1, P)
    fi_im_s = fi_im.reshape(C, M, nsym + 1, P)

    def shifted(arr_s, s):
        # flat index (k+1)*P + s == [q + k, r] of the [nsym+1, P] view
        q, r = divmod(P + s, P)
        return arr_s[:, :, q:q + nsym, r]
    v_re = jnp.zeros((C, M, nsym), jnp.float32)
    v_im = jnp.zeros((C, M, nsym), jnp.float32)
    vh_re = jnp.zeros((C, M, nsym), jnp.float32)
    vh_im = jnp.zeros((C, M, nsym), jnp.float32)
    for s in range(lo_min, lo_max + 1):
        sel = (low == s)[:, None, None]
        v_re = jnp.where(sel, shifted(fi_re_s, s), v_re)
        v_im = jnp.where(sel, shifted(fi_im_s, s), v_im)
        vh_re = jnp.where(sel, shifted(fi_re_s, s + 1), vh_re)
        vh_im = jnp.where(sel, shifted(fi_im_s, s + 1), vh_im)
    fr = fract[:, None, None]
    v_re = v_re * (1.0 - fr) + vh_re * fr
    v_im = v_im * (1.0 - fr) + vh_im * fr
    tmag = jnp.sqrt(v_re * v_re + v_im * v_im)                    # [C, M, nsym]

    # --- hard bits + soft decisions (fsk.c:760-805) ---
    sym = jnp.argmax(tmag, axis=1)                                # [C, nsym]
    if M == 2:
        bits = sym.astype(jnp.uint8)
        soft = tmag[:, 0, :] - tmag[:, 1, :]                      # + ⇒ bit 0
    else:
        b_hi = ((sym >> 1) & 1).astype(jnp.uint8)
        b_lo = (sym & 1).astype(jnp.uint8)
        bits = jnp.stack([b_hi, b_lo], axis=-1).reshape(C, nsym * 2)
        t0, t1, t2, t3 = tmag[:, 0], tmag[:, 1], tmag[:, 2], tmag[:, 3]
        sd_hi = -t0 - t1 + t2 + t3                                # + ⇒ bit 1
        sd_lo = -t0 + t1 - t2 + t3
        soft = jnp.stack([sd_hi, sd_lo], axis=-1).reshape(C, nsym * 2)

    # --- Eb/N0 estimate (fsk.c:806-833) ---
    mx = jnp.max(tmag, axis=1)                                    # [C, nsym]
    mean_e = jnp.mean(mx, axis=-1)
    var_e = jnp.mean(mx**2, axis=-1) - mean_e**2
    std_e = jnp.sqrt(jnp.maximum(var_e, 0.0))
    ebno_db = -6.0 + 20.0 * jnp.log10((1e-6 + mean_e) / (1e-6 + std_e))

    out = dict(soft=soft, bits=bits, f_est=f_est, ebno_db=ebno_db,
               ppm=ppm, nin_next=nin_next)
    if probe:
        # internal trajectories for modem probing (utils.probe; the
        # functional analogue of modem_probe's fsk.c hooks)
        out["sf"] = sf_new
        out["timing"] = norm_timing
        out["tmag"] = tmag
    new_state = dict(sf=sf_new, timing=norm_timing, ppm=ppm)
    return out, new_state


# ----------------------------------------------------------------------------
# stream demod: scan over blocks
# ----------------------------------------------------------------------------

def fsk_num_blocks(cfg: FSKConfig, t_samples: int) -> int:
    return max(0, (t_samples - cfg.nmem) // cfg.block_advance_max)


@partial(jax.jit, static_argnames=("cfg", "n_blocks", "probe"))
def _fsk_demod_scan(cfg: FSKConfig, x: jnp.ndarray, state: FSKState,
                    n_blocks: int, probe: bool = False):
    """x: [C, 2, T] float32 IQ planes."""
    def body(st, _):
        start = st["ptr"] - cfg.nmem
        win = jax.vmap(
            lambda xc, s: jax.lax.dynamic_slice(xc, (0, s), (2, cfg.nmem))
        )(x, start)
        out, new_partial = fsk_demod_block(cfg, win, st, probe=probe)
        new_state = FSKState(
            sf=new_partial["sf"],
            timing=new_partial["timing"],
            ppm=new_partial["ppm"],
            ptr=st["ptr"] + out["nin_next"],
            nin=out["nin_next"],
        )
        return new_state, out

    state, outs = jax.lax.scan(body, state, None, length=n_blocks)
    return state, outs


@partial(jax.jit, static_argnames=("cfg", "n_blocks", "probe", "slack_ts"))
def _fsk_demod_scan_buffered(cfg: FSKConfig, x: jnp.ndarray,
                             state: FSKState, n_blocks: int,
                             probe: bool = False, slack_ts: int = 8):
    """Gather-free scan variant: the window rides in the carry.

    Instead of a per-channel dynamic slice into the whole [C, 2, T]
    stream (a gather over a large operand), the carry holds a
    [C, 2, nmem + slack] rolling buffer advanced by a SHARED ``n``
    samples per block; each channel's ±ts/2 clock adjustments move only
    its ``off`` pointer within the small buffer, and the window is
    selected from (2*slack_ts+1) static slices by mask.  Numerically
    identical to ``_fsk_demod_scan`` on the off0-shifted stream while the
    accumulated clock drift stays inside ±slack/2.  Beyond the slack the
    pointer WRAPS back toward the slack center by a grid-aligned jump
    (whole symbols when ts is even; multiples of ts//2 when ts is odd —
    see ``_slack_wrap``): a clean multi-step slip per wrap event so the
    demod stays locked and frame decoders re-sync at the next header — instead of the
    sub-symbol clamp slip that would corrupt every following symbol
    under sustained ppm offset.
    The default scan for ``fsk_demod_stream`` and the sharded pipeline.
    """
    half_ts = cfg.ts // 2
    slack = slack_ts * cfg.ts
    w = cfg.nmem + slack
    C = x.shape[0]
    buf0 = x[:, :, :w]
    # every offset must sit on the +-ts//2 adjustment grid (ts may be
    # odd, so slack//2 itself need not be)
    n_steps = slack // half_ts
    off_max = n_steps * half_ts
    # derived from x so the scan carry is device-varying under shard_map
    off0 = (n_steps // 2) * half_ts + (x[:, 0, 0] * 0).astype(jnp.int32)

    def body(carry, b):
        buf, off, st = carry
        win = jnp.zeros((C, 2, cfg.nmem), jnp.float32)
        for k in range(n_steps + 1):
            o = k * half_ts
            win = jnp.where((off == o)[:, None, None],
                            buf[:, :, o:o + cfg.nmem], win)
        out, newp = fsk_demod_block(cfg, win, st, probe=probe)
        chunk = jax.lax.dynamic_slice(x, (0, 0, w + b * cfg.n),
                                      (C, 2, cfg.n))
        buf = jnp.concatenate([buf[:, :, cfg.n:], chunk], axis=2)
        off = off + (out["nin_next"] - cfg.n)
        # slack exhausted -> wrap back toward the buffer CENTER
        # (grid-aligned).  Each wrap is a clean multi-step slip that
        # breaks at most the in-flight frame (decoders re-sync at the
        # next header), so jumping ~slack/2 instead of one step makes
        # wrap events — and the frames they cost — ~4x rarer under
        # sustained ppm offset.
        wrap = _slack_wrap(cfg.ts, half_ts, off_max)
        off = jnp.where(off > off_max, off - wrap, off)
        off = jnp.where(off < 0, off + wrap, off)
        off = jnp.clip(off, 0, off_max)
        new_state = FSKState(sf=newp["sf"], timing=newp["timing"],
                             ppm=newp["ppm"],
                             ptr=st["ptr"] + out["nin_next"],
                             nin=out["nin_next"])
        return (buf, off, new_state), out

    (buf, off, state), outs = jax.lax.scan(
        body, (buf0, off0, state), jnp.arange(n_blocks))
    return state, outs


def _slack_wrap(ts: int, half_ts: int, off_max: int) -> int:
    """Grid-aligned slack-wrap jump (~off_max/2).

    ``off`` only ever moves in +-``half_ts`` steps, so the wrap MUST be
    a multiple of ``half_ts`` or the post-wrap offset falls off the
    masked-window grid and the channel would demodulate zeros forever.
    For even ``ts`` the wrap is additionally a whole number of symbols
    (a clean bit-clock-preserving slip).  For odd ``ts`` whole symbols
    are generally NOT on the half_ts grid (e.g. ts=15, half_ts=7):
    grid alignment wins — the frame decoders re-sync after any slip.
    """
    if ts % 2 == 0:
        return max(ts, (off_max // (2 * ts)) * ts)
    return max(half_ts, (off_max // (2 * half_ts)) * half_ts)


def fsk_num_blocks_buffered(cfg: FSKConfig, t_samples: int,
                            slack_ts: int = 8) -> int:
    w = cfg.nmem + slack_ts * cfg.ts
    return max(0, (t_samples - w) // cfg.n)


def fsk_demod_stream(cfg: FSKConfig, x: jnp.ndarray,
                     state: FSKState | None = None, probe: bool = False,
                     buffered: bool = True):
    """Demodulate IQ: complex64 [C, T] / [T], or float32 planes [C, 2, T].

    Returns (soft [C, total_bits], bits [C, total_bits], stats dict, state).
    Stats arrays are [C, n_blocks] (f_est is [C, n_blocks, M]).  With
    ``probe=True`` stats also carries the internal trajectories ``sf``
    [C, nb, ndft], ``timing`` [C, nb] and ``tmag`` [C, nb, M, nsym]
    (see utils.probe — the modem_probe analogue).  ``buffered`` (the
    default) selects the gather-free rolling-buffer scan (output starts
    slack/2 samples later — frame decoders don't care);
    ``buffered=False`` keeps the plain per-channel dynamic-slice scan.
    """
    squeeze = jnp.iscomplexobj(x) and x.ndim == 1
    x = iq_planes(x)
    C, _, T = x.shape
    if state is None:
        state = fsk_init_state(cfg, C)
    nb = fsk_num_blocks_buffered(cfg, T) if buffered \
        else fsk_num_blocks(cfg, T)
    if nb == 0:
        empty = jnp.zeros((C, 0), jnp.float32)
        return empty, empty.astype(jnp.uint8), {}, state
    if buffered:
        state, outs = _fsk_demod_scan_buffered(cfg, x, state, nb, probe)
    else:
        state, outs = _fsk_demod_scan(cfg, x, state, nb, probe)
    # outs.* are [n_blocks, C, ...] -> concat along time
    soft = jnp.transpose(outs["soft"], (1, 0, 2)).reshape(C, -1)
    bits = jnp.transpose(outs["bits"], (1, 0, 2)).reshape(C, -1)
    stats = dict(
        f_est=jnp.transpose(outs["f_est"], (1, 0, 2)),
        ebno_db=jnp.transpose(outs["ebno_db"], (1, 0)),
        ppm=jnp.transpose(outs["ppm"], (1, 0)),
    )
    if probe:
        stats["sf"] = jnp.transpose(outs["sf"], (1, 0, 2))
        stats["timing"] = jnp.transpose(outs["timing"], (1, 0))
        stats["tmag"] = jnp.transpose(outs["tmag"], (1, 0, 2, 3))
    if squeeze:
        soft, bits = soft[0], bits[0]
    return soft, bits, stats, state
