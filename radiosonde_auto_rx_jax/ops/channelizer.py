"""Polyphase filter-bank channelizer: one wideband capture -> N channels.

Replaces the reference's one-SDR-per-task model and the KA9Q multi-channel
server (reference auto_rx/autorx/ka9q.py: `tune` creates one 48 kHz channel
per sonde, SSRC-addressed): a single 2.4 MHz+ IQ capture is split into N
critically-sampled channels in one pass, and every downstream stage
(detector, demodulators) consumes the ``[N, 2, T/N]`` batch directly.

Device mapping: the polyphase branches are P shifted multiply-accumulates
over real ``[2, M, N]`` planes; the cross-branch DFT is a pair of real
``[N, N]`` matmuls, run at ``Precision.HIGHEST`` (exact f32, never TF32:
the PER gates were validated against exact f32 channel planes).
"""

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from radiosonde_auto_rx_jax.ops.fir import design_lowpass


def _branch_dtype():
    """dtype of the polyphase branch accumulator ``y`` and of the
    channel planes: f32 (the path the CPU tests and PER gates
    validated).  RSX_CHANNELIZER_DTYPE=bfloat16 forces bf16 branches
    (±0.4% quantization, ~-48 dB); the matmul accumulation is f32
    either way."""
    forced = os.environ.get("RSX_CHANNELIZER_DTYPE")
    if forced:
        return jnp.dtype(forced)
    return jnp.dtype(jnp.float32)


def pfb_prototype(n_chan: int, taps_per_branch: int = 12,
                  cutoff_scale: float = 0.5) -> np.ndarray:
    """Prototype lowpass for the bank: cutoff at half the channel spacing
    (critically sampled), length n_chan*taps_per_branch."""
    ntaps = n_chan * taps_per_branch
    h = design_lowpass(cutoff_scale / n_chan, ntaps)
    if len(h) > ntaps:
        h = h[:ntaps]
    elif len(h) < ntaps:
        h = np.concatenate([h, np.zeros(ntaps - len(h), np.float32)])
    return (h * n_chan).astype(np.float32)


def _dft_mats(n):
    k = np.arange(n)
    ang = 2 * np.pi * np.outer(k, k) / n
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _dft_op_combined(n):
    """[2N, 2N] operand computing the complex cross-branch DFT in ONE
    matmul over y laid out [M, (re|im) x N]:

        out[2k,   m] = sum_r cos[r,k]*yr[m,r] + sin[r,k]*yi[m,r]   (= zr_k)
        out[2k+1, m] = sum_r cos[r,k]*yi[m,r] - sin[r,k]*yr[m,r]   (= zi_k)

    Output columns are interleaved (zr_k, zi_k) so the [2N, M] result
    reshapes straight to [N, 2, M] channel planes — no transpose pass,
    and y is read once instead of once per real matmul."""
    cos, sin = _dft_mats(n)
    op = np.zeros((2 * n, 2 * n), np.float32)
    op[:n, 0::2] = cos          # yr rows -> zr cols
    op[n:, 0::2] = sin          # yi rows -> zr cols
    op[:n, 1::2] = -sin         # yr rows -> zi cols
    op[n:, 1::2] = cos          # yi rows -> zi cols
    return op


@partial(jax.jit, static_argnames=("n_chan",))
def _channelize(x, h, n_chan):
    """x: [2, T] wideband planes; h: [P*N] prototype.

    Returns [N, 2, T//N] channel planes; channel k is centered at
    +k*fs/N (k > N/2 ⇒ negative frequencies).
    """
    P = h.shape[0] // n_chan
    T = x.shape[-1] // n_chan * n_chan
    x = x[:, :T]
    M = T // n_chan
    ydt = _branch_dtype()
    # polyphase branches: branch r takes samples x[m*N + r]
    xb = x.reshape(2, M, n_chan).astype(ydt)                 # [2, M, N]
    # prototype branch taps, branch axis REVERSED: with y[m] =
    # Σ_j h[j]·x[mN + (N−1) − j] (a true decimating FIR), the j = pN+s
    # component multiplies x[(m−p)N + r] for r = N−1−s, so branch r's
    # taps are h[pN + (N−1−r)].  The un-reversed form (rounds 1-4)
    # computes a period-N branch-permuted filter instead: exact at
    # every channel CENTER (the parity/golden tests all probe there)
    # but with an in-channel response droop of ~0.6 dB at ±10 kHz and
    # ~4 dB at ±25 kHz off center — discovered round 5 when Weathex's
    # ±25 kHz tones lost 3 dB through the recentered extraction.
    hb = h.reshape(P, n_chan)[:, ::-1].astype(ydt)           # [P, N]
    # branch filtering as P shifted multiply-accumulates along M — the
    # minor dim (N) stays contiguous, so XLA fuses this into one
    # memory-bound elementwise pass
    xp = jnp.pad(xb, ((0, 0), (P - 1, 0), (0, 0)))
    y = xp[:, P - 1:P - 1 + M, :] * hb[0]
    for p in range(1, P):
        y = y + xp[:, P - 1 - p:P - 1 - p + M, :] * hb[p]
    yr, yi = y[0], y[1]                                      # [M, N]
    # cross-branch DFT: z_k = sum_r y_r e^{-2πi rk/N} downconverts
    # +k·fs/N; dots with the [N, N] operand on the LEFT emit the [N, M]
    # channel-major layout directly (no transpose pass).
    # Precision: HIGHEST (exact f32 — TF32 would cost the channel planes
    # ~3 decimal digits ahead of every decode)
    cosm, sinm = _dft_mats(n_chan)
    cosm = jnp.asarray(cosm).astype(ydt)
    sinm = jnp.asarray(sinm).astype(ydt)
    dft = partial(jnp.einsum, "rk,mr->km", preferred_element_type=jnp.float32,
                  precision=lax.Precision.HIGHEST)
    zr = dft(cosm, yr) + dft(sinm, yi)
    zi = dft(cosm, yi) - dft(sinm, yr)
    # channel planes ship in the branch dtype; all consumers compute in
    # f32
    return jnp.stack([zr, zi], axis=1).astype(ydt)           # [N, 2, M]


def channelize(x, n_chan: int, h: np.ndarray | None = None):
    """Wideband IQ (complex [T] or planes [2, T]) -> [N, 2, T//N] channels.

    Channel k is centered at f_k = k*fs/N for k <= N/2, f_k - fs for
    k > N/2; each channel's output rate is fs/N.
    """
    if np.iscomplexobj(x) and not isinstance(x, jnp.ndarray):
        # split host complex on the host into the planes layout
        x = np.asarray(x)
        x = jnp.asarray(np.stack([x.real, x.imag]).astype(np.float32))
    elif jnp.iscomplexobj(x):
        x = jnp.stack([x.real, x.imag]).astype(jnp.float32)
    if h is None:
        h = pfb_prototype(n_chan)
    return _channelize(x, jnp.asarray(h), n_chan)


def channel_freqs(n_chan: int, fs: float) -> np.ndarray:
    """Center frequency (Hz, relative to capture center) per channel."""
    k = np.arange(n_chan)
    f = k * fs / n_chan
    f[k > n_chan // 2] -= fs
    return f


# --------------------------------------------------------------------- #
# Single-channel recentered extraction: the batch-pipeline analogue of
# the reference "tune the SDR to the detected peak" (reference
# auto_rx/autorx/scan.py:1034-1097 quantizes scan peaks to the 10 kHz
# raster and retunes; autorx/sdr_wrappers.py:270-376 builds the retuned
# IQ command).  A fixed PFB grid cannot retune, so off-grid candidates
# are re-extracted from the retained wideband block: rotate by the peak
# frequency, then run ONE branch of the same polyphase bank (channel 0
# of the DFT = the plain branch sum).  At f = k*fs/N this reproduces
# ``_channelize`` output k exactly (the k*m rotation term is integer
# cycles), so recentered rows are drop-in replacements for PFB rows.


def extract_phases(f_hz: float, fs: float, t_samples: int, n_dec: int):
    """Host-side exact phase tables for ``_extract`` (float64 modular
    math — a float32 in-graph NCO drifts ~0.1 cycle over a 1 s wideband
    block, which would smear the FSK tones).

    Returns (ph_m [T//n_dec], ph_r [n_dec]) phase tables in cycles:
    the rotation phase of wideband sample ``m*n_dec + r`` is
    ``ph_m[m] + ph_r[r]`` (mod 1).

    The NCO starts at phase 0 every call: there is deliberately no
    cross-block phase continuity, because every consumer demodulates
    each capture block INDEPENDENTLY (the station's demod restarts per
    block; frames straddling block boundaries are lost either way, the
    same loss the reference takes at any decoder restart) — so a phase
    step at a block seam is never observed by a demod.
    """
    m = np.arange(t_samples // n_dec, dtype=np.float64)
    r = np.arange(n_dec, dtype=np.float64)
    f = float(f_hz) / float(fs)
    ph_m = np.mod(f * n_dec * m, 1.0).astype(np.float32)
    ph_r = np.mod(f * r, 1.0).astype(np.float32)
    return ph_m, ph_r


@partial(jax.jit, static_argnames=("n_dec",))
def _extract(x, h, ph_m, ph_r, n_dec):
    """x: [S, 2, T] wideband planes (one per slot); h: [P*n_dec]
    prototype; ph_m: [S, T//n_dec], ph_r: [S, n_dec] rotation phases
    (cycles).

    Returns [S, 2, T//n_dec] recentered decimated channel planes (branch
    dtype, matching ``_channelize`` rows).  Each slot s rotates its
    wideband stream DOWN by its frequency (e^{-j2πf n}) and decimates
    through the prototype's polyphase branches.
    """
    P = h.shape[0] // n_dec
    T = x.shape[-1] // n_dec * n_dec
    M = T // n_dec
    ydt = _branch_dtype()
    # branch axis reversed — see the derivation in _channelize
    hb = h.reshape(P, n_dec)[:, ::-1].astype(ydt)            # [P, N]
    tau = jnp.float32(2.0 * np.pi)
    cm, sm = jnp.cos(tau * ph_m), jnp.sin(tau * ph_m)        # [S, M]
    cr, sr = jnp.cos(tau * ph_r), jnp.sin(tau * ph_r)        # [S, N]

    def one(x_s, cm_s, sm_s, cr_s, sr_s):
        xb = x_s[:, :T].reshape(2, M, n_dec)                 # [2, M, N]
        # cos/sin of the summed phase via angle addition (M+N
        # transcendentals instead of M*N)
        c = cm_s[:, None] * cr_s[None, :] - sm_s[:, None] * sr_s[None, :]
        s = sm_s[:, None] * cr_s[None, :] + cm_s[:, None] * sr_s[None, :]
        # rotate DOWN by f: (re + j·im)·(c - j·s)
        re = (xb[0] * c + xb[1] * s).astype(ydt)             # [M, N]
        im = (xb[1] * c - xb[0] * s).astype(ydt)
        # branch MAC exactly as _channelize, then the branch SUM
        # (channel-0 DFT row) instead of the cross-branch DFT
        out = []
        for plane in (re, im):
            xp = jnp.pad(plane, ((P - 1, 0), (0, 0)))
            y = xp[P - 1:P - 1 + M, :] * hb[0]
            for p in range(1, P):
                y = y + xp[P - 1 - p:P - 1 - p + M, :] * hb[p]
            out.append(y.sum(axis=-1).astype(ydt))
        return jnp.stack(out)                                # [2, M]

    return jax.vmap(one)(x, cm, sm, cr, sr)                  # [S, 2, M]


def extract_channels(x, fs: float, f_hz_list, n_dec: int,
                     h: np.ndarray | None = None):
    """Wideband IQ planes -> [S, 2, T//n_dec] channels recentered on the
    (possibly off-grid) frequencies ``f_hz_list`` (Hz relative to the
    capture center).  ``x`` is [2, T] (shared across slots) or [S, 2, T]
    (one capture per slot).  ``h`` defaults to the same prototype a
    ``n_dec``-channel PFB would use, so an extraction at a channel
    center matches that PFB channel."""
    if h is None:
        h = pfb_prototype(n_dec)
    x = jnp.asarray(x)
    T = int(x.shape[-1])
    tabs = [extract_phases(f, fs, T, n_dec) for f in f_hz_list]
    ph_m = jnp.asarray(np.stack([t[0] for t in tabs]))
    ph_r = jnp.asarray(np.stack([t[1] for t in tabs]))
    if x.ndim == 2:
        x = jnp.broadcast_to(x[None], (len(f_hz_list),) + x.shape)
    return _extract(x, jnp.asarray(h), ph_m, ph_r, n_dec)
