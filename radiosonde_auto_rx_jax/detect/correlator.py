"""Batched matched-filter correlation over the template bank.

Batched reformulation of the reference's getCorrDFT
(reference scan/dft_detect.c:357-443): the per-type DFT·conj(template)
IDFT per K-block becomes ONE correlation of the FM stream against the
whole bank — ``corr[c, k, t] = sum_i x[c, t+i]·tmpl[k, i]`` — batched over
channels (overlap-save FFT by default; direct and Toeplitz-matmul forms
are kept as references and forced paths).  Every correlation dot runs at
``Precision.HIGHEST``: its scores feed the type decisions.  The reference's normalization
(windowed signal norm over the template length, :427-431) and DC removal
(mean over the last 2L samples, :383-391) become cumsum-based running sums,
so every time position is normalized, not just the per-block max.
"""

import os
from dataclasses import dataclass
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


@dataclass
class Detection:
    name: str
    tn: int
    score: float
    position: int       # sample index of header end
    inverted: bool
    freq_offset: float  # Hz (from FM DC term, if computed)


def _windowed_sums(x, lens):
    """Running sums over trailing windows of per-type lengths.

    x: [C, T]; lens: [K] ints.  Returns sums [C, K, T'] aligned with the
    'valid' correlation positions for a bank padded to Lmax.
    """
    C, T = x.shape
    lmax = int(lens.max())
    nvalid = T - lmax + 1
    x = x.astype(jnp.float32)     # running sums accumulate in f32
    cs = jnp.concatenate(
        [jnp.zeros((C, 1), x.dtype), jnp.cumsum(x, axis=-1)], axis=-1)
    outs = []
    for k in range(len(lens)):
        L = int(lens[k])
        # correlation at valid position t covers x[t : t+L]
        outs.append(cs[:, lens[k]:nvalid + lens[k]] - cs[:, :nvalid])
    return jnp.stack(outs, axis=1)                      # [C, K, nvalid]


def _corr_direct(x, bank):
    """Direct grouped conv: [C,1,T] * [K,1,Lmax] -> [C,K,T']."""
    return jax.lax.conv_general_dilated(
        x[:, None, :], bank[:, None, :], window_strides=(1,),
        padding=[(0, 0)], dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST)


def _corr_fft(x, bank, nfft=4096):
    """Overlap-save FFT cross-correlation, same result as _corr_direct.

    Circular correlation irfft(X · conj(H)) equals the linear one at lags
    [0, nfft-Lmax] when the template is zero-padded to Lmax ≤ nfft, so
    each nfft-frame (hop B = nfft-Lmax+1) yields B valid positions.
    O(K·T·Lmax) MACs become O((K+1)·T·log nfft) — a ~25x flop cut for
    this bank (K=16, Lmax=1280) over the padded grouped conv.
    """
    C, T = x.shape
    K, lmax = bank.shape
    if nfft < 2 * lmax:
        nfft = 1 << int(np.ceil(np.log2(2 * lmax)))
    B = nfft - lmax + 1
    nvalid = T - lmax + 1
    nblk = max(1, -(-nvalid // B))
    pad = (nblk - 1) * B + nfft - T
    xp = jnp.pad(x, ((0, 0), (0, max(pad, 0))))
    frames = jnp.stack(
        [jax.lax.dynamic_slice_in_dim(xp, i * B, nfft, 1)
         for i in range(nblk)], axis=1)                  # [C, nblk, nfft]
    xs = jnp.fft.rfft(frames)                            # [C, nblk, F]
    hs = jnp.conj(jnp.fft.rfft(bank, n=nfft))            # [K, F]
    y = jnp.fft.irfft(xs[:, :, None, :] * hs[None, None], n=nfft)
    corr = y[..., :B].transpose(0, 2, 1, 3).reshape(C, K, nblk * B)
    return corr[:, :, :nvalid]


def _corr_toeplitz(x, bank, block=128):
    """Blocked-Toeplitz correlation: same result as _corr_direct, but the
    stride-``block`` kernel emits K·block output columns per step, so the
    whole bank correlates as one dense [*, B+Lmax-1] x [B+Lmax-1, K·B]
    matmul (RSX_DETECT_CORR=toeplitz).  The output cube keeps the input
    dtype; accumulation is f32 either way.
    """
    C, T = x.shape
    K, lmax = bank.shape
    B = block
    nvalid = T - lmax + 1
    M = -(-nvalid // B)
    xp = jnp.pad(x, ((0, 0), (0, M * B + lmax - 1 - T)))
    # rhs[(k,j), i] = bank[k, i - j] for i-j in [0, lmax)
    w = jax.vmap(lambda h: jnp.stack(
        [jnp.pad(h, (j, B - 1 - j)) for j in range(B)]))(bank)
    rhs = w.reshape(K * B, 1, B + lmax - 1).astype(x.dtype)
    out = jax.lax.conv_general_dilated(
        xp[:, None, :], rhs, window_strides=(B,), padding=[(0, 0)],
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)                 # [C, K*B, M]
    # the [C, K, T'] score cube keeps the stream dtype — accumulation
    # was f32, and the normalization upcasts elementwise
    out = out.astype(x.dtype)
    corr = out.reshape(C, K, B, M).transpose(0, 1, 3, 2).reshape(C, K, M * B)
    return corr[:, :, :nvalid]


# Correlation strategy: overlap-save FFT (the path the CPU tests and PER
# gates validated); RSX_DETECT_CORR=fft|conv|toeplitz forces.
_CORR_METHOD = os.environ.get("RSX_DETECT_CORR", "auto")


def _corr_method():
    if _CORR_METHOD != "auto":
        return _CORR_METHOD
    return "fft"


@partial(jax.jit, static_argnames=("lens_t",))
def _correlate(x, bank, lens_t):
    """x: [C, T] FM stream (f32 or bf16 — see scanner.stream_dtype);
    bank: [K, Lmax].

    Returns (corr [C,K,T'], xnorm [C,K,T'], dc [C,K,T']) at valid
    positions (T' = T-Lmax+1); correlation index t covers x[t:t+L_k].
    Normalization terms always accumulate/evaluate in f32.
    """
    C, T = x.shape
    K, lmax = bank.shape
    lens = np.asarray(lens_t)
    method = _corr_method()
    if method == "toeplitz" and T >= 2 * lmax:
        corr = _corr_toeplitz(x, bank.astype(x.dtype))
    elif method == "fft" and T >= 2 * lmax:
        corr = _corr_fft(x.astype(jnp.float32), bank.astype(jnp.float32))
    else:
        corr = _corr_direct(x.astype(jnp.float32),
                            bank.astype(jnp.float32))
    xf = x.astype(jnp.float32)    # bf16 streams: square/sum in f32
    s1 = _windowed_sums(xf, lens)                       # [C,K,T']
    s2 = _windowed_sums(xf * xf, lens)
    lensf = jnp.asarray(lens, jnp.float32)[None, :, None]
    dc = s1 / lensf
    # norm of (x - dc) over the window; template sums ~0 so corr is
    # DC-corrected via corr - dc*sum(tmpl)
    tsum = jnp.sum(bank, axis=-1)[None, :, None].astype(jnp.float32)
    corr = corr - dc * tsum
    xnorm = jnp.sqrt(jnp.maximum(s2 - lensf * dc * dc, 1e-12))
    # dead-air guard: windows much quieter than the channel (e.g. zero
    # padding) would divide ~0/~0 into garbage scores — zero them out
    rms = jnp.sqrt(jnp.mean(xf * xf, axis=-1))[:, None, None]
    floor = 0.05 * jnp.sqrt(lensf) * rms
    corr = jnp.where(xnorm < floor, 0.0, corr)
    return corr, xnorm, dc


def correlate_bank(x, bank, lens):
    """Normalized correlation scores [C, K, T'] in [-1, 1]."""
    x = jnp.asarray(x, jnp.float32)
    if x.ndim == 1:
        x = x[None, :]
    corr, xnorm, dc = _correlate(x, jnp.asarray(bank), tuple(int(v)
                                                             for v in lens))
    return corr / xnorm, dc


@partial(jax.jit, static_argnames=("lens_t",))
def _correlate_peaks_exact(x, bank, lens_t):
    """Fused correlate + per-(channel, type) peak reduction.

    Only [C, K] peak values/positions/DC (plus the [C] stream mean for
    the frequency-offset estimate) cross to the host instead of the full
    [C, K, T'] score cube — the device->host transfer and the host
    argmax were the round-1 detector bottleneck (35.5 Msps/chip), not the
    correlation itself.
    """
    corr, xnorm, dc = _correlate(x, bank, lens_t)
    score = corr / xnorm
    ipk = jnp.argmax(jnp.abs(score), axis=-1)            # [C, K]
    val = jnp.take_along_axis(score, ipk[..., None], axis=-1)[..., 0]
    dcpk = jnp.take_along_axis(dc, ipk[..., None], axis=-1)[..., 0]
    return (val, ipk.astype(jnp.int32), dcpk,
            jnp.mean(x.astype(jnp.float32), axis=-1))


@partial(jax.jit, static_argnames=("lens_t", "block", "m_chunk",
                                   "positions"))
def _correlate_peaks_blocknorm_scan(x, bank, lens_t, block=128,
                                    m_chunk=128, positions=True):
    """Chunked-scan form of ``_correlate_peaks_blocknorm``: identical
    math (same einsum-Toeplitz correlation, block-granular norms,
    first-occurrence argmax tie-breaking, exact rescore at the peak),
    but the [C, M, K·B] correlation cube never materializes — a
    ``lax.scan`` over M-chunks keeps each chunk's corr/y/score inside
    one fused iteration, cutting the stage's HBM traffic to the input
    re-reads.  Outputs are bit-identical to the monolithic form (gated
    by tests/test_detect.py)."""
    C, T = x.shape
    K, lmax = bank.shape
    lens = np.asarray(lens_t)
    B = block
    nvalid = T - lmax + 1
    M = -(-nvalid // B)
    nbw = -(-(B + lmax - 1) // B)
    W = nbw * B
    Mc = min(m_chunk, M)
    nch = -(-M // Mc)

    w_np = jnp.stack([
        jnp.pad(bank[k], (j, W - lmax - j))
        for k in range(K) for j in range(B)], axis=1)       # [W, K*B]
    Mb = -(-T // B)
    pad_to = max((nch * Mc + nbw) * B, Mb * B)
    xp = jnp.pad(x, ((0, 0), (0, pad_to - T)))
    xb = xp.reshape(C, -1, B)

    # block-granular norm terms (same as the monolithic form), padded
    # over the chunk grid; padded rows can never win (valid=False)
    xf32 = x.astype(jnp.float32)
    xbn = xb[:, :Mb].astype(jnp.float32)
    cs1b = jnp.concatenate([jnp.zeros((C, 1), jnp.float32),
                            jnp.cumsum(xbn.sum(-1), axis=-1)], axis=-1)
    cs2b = jnp.concatenate([jnp.zeros((C, 1), jnp.float32),
                            jnp.cumsum((xbn * xbn).sum(-1), axis=-1)],
                           axis=-1)
    tsum = jnp.sum(bank, axis=-1).astype(jnp.float32)
    rms = jnp.sqrt(jnp.mean(xf32 * xf32, axis=-1))
    m_idx = jnp.arange(M)
    dcs, xns = [], []
    for k in range(K):
        L = int(lens[k])
        lb = min(-(-L // B) + 1, Mb)
        lo = jnp.minimum(m_idx, Mb - lb)
        s1 = jnp.take_along_axis(cs1b, lo[None] + lb, axis=1) - \
            jnp.take_along_axis(cs1b, lo[None], axis=1)
        s2 = jnp.take_along_axis(cs2b, lo[None] + lb, axis=1) - \
            jnp.take_along_axis(cs2b, lo[None], axis=1)
        n = jnp.float32(lb * B)
        dc_a = s1 / n
        dcs.append(dc_a)
        xns.append(jnp.sqrt(jnp.maximum(s2 - n * dc_a * dc_a, 1e-12)))
    dc_all = jnp.pad(jnp.stack(dcs, axis=2),
                     ((0, 0), (0, nch * Mc - M), (0, 0)))   # [C, M', K]
    xn_all = jnp.pad(jnp.stack(xns, axis=2),
                     ((0, 0), (0, nch * Mc - M), (0, 0)),
                     constant_values=1.0)
    lensf_k = jnp.asarray(lens, jnp.float32)[None, :]
    floor_ck = 0.05 * jnp.sqrt(lensf_k) * rms[:, None]      # [C, K]
    wj = w_np.astype(x.dtype)
    karange = jnp.arange(K)

    def body(carry, i):
        m0 = i * Mc
        xwin = jnp.concatenate(
            [jax.lax.dynamic_slice(xb, (0, m0 + k, 0), (C, Mc, B))
             for k in range(nbw)], axis=-1)                  # [C, Mc, W]
        corr = jnp.einsum("cmw,wo->cmo", xwin, wj,
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)
        corr = corr.astype(x.dtype).reshape(C, Mc, K, B)
        dc_c = jax.lax.dynamic_slice(dc_all, (0, m0, 0), (C, Mc, K))
        xn_c = jax.lax.dynamic_slice(xn_all, (0, m0, 0), (C, Mc, K))
        t_pos = (m0 + jnp.arange(Mc))[:, None] * B + jnp.arange(B)
        valid = t_pos < nvalid                               # [Mc, B]
        y = jnp.abs(corr - (dc_c[..., None] *
                            tsum[None, None, :, None]).astype(corr.dtype))
        y = jnp.where(valid[None, :, None, :], y, -1.0)
        y_best = jnp.max(y, axis=-1)                         # [C, Mc, K]
        score = y_best.astype(jnp.float32) / xn_c
        score = jnp.where(xn_c < floor_ck[:, None, :], 0.0, score)
        score = jnp.where((t_pos[:, 0] < nvalid)[None, :, None],
                          score, -jnp.inf)
        if not positions:
            best = carry
            return jnp.maximum(best, score.max(axis=1)), None
        best, t_pk, corr_pk = carry
        j_best = jnp.argmax(y, axis=-1).astype(jnp.int32)
        m_loc = jnp.argmax(score, axis=1)                    # [C, K]
        s_loc = jnp.max(score, axis=1)
        j_loc = jnp.take_along_axis(j_best, m_loc[:, None, :],
                                    axis=1)[:, 0]
        corr_loc = jnp.take_along_axis(
            corr.reshape(C, Mc * K * B),
            m_loc * (K * B) + karange[None, :] * B + j_loc,
            axis=-1).astype(jnp.float32)
        t_loc = ((m0 + m_loc) * B + j_loc).astype(jnp.int32)
        upd = s_loc > best
        # dc/xn at the peak are NOT carried: the exact-rescore tail
        # recomputes them from cumsums at t_pk
        return (jnp.where(upd, s_loc, best),
                jnp.where(upd, t_loc, t_pk),
                jnp.where(upd, corr_loc, corr_pk)), None

    xm = jnp.mean(xf32, axis=-1)
    # carry inits derive from x so they carry its varying manual axes
    # when this runs inside a shard_map (sharded confirm/prescreen)
    var0 = 0.0 * xf32[:, :1]                                # [C, 1]
    if not positions:
        best0 = jnp.full((C, K), -jnp.inf, jnp.float32) + var0
        best, _ = jax.lax.scan(body, best0, jnp.arange(nch))
        zero = jnp.zeros((C, K), jnp.float32)
        return best, zero.astype(jnp.int32), zero, xm
    carry0 = (jnp.full((C, K), -jnp.inf, jnp.float32) + var0,
              jnp.zeros((C, K), jnp.int32) + var0.astype(jnp.int32),
              jnp.zeros((C, K), jnp.float32) + var0)
    (best, t_pk, corr_pk), _ = jax.lax.scan(
        body, carry0, jnp.arange(nch))

    # exact per-position rescore at the peak (identical tail to the
    # monolithic form)
    cs1 = jnp.concatenate([jnp.zeros((C, 1), jnp.float32),
                           jnp.cumsum(xf32, axis=-1)], axis=-1)
    cs2 = jnp.concatenate([jnp.zeros((C, 1), jnp.float32),
                           jnp.cumsum(xf32 * xf32, axis=-1)], axis=-1)
    lensj = jnp.asarray(lens, jnp.int32)[None, :]
    s1p = jnp.take_along_axis(cs1, t_pk + lensj, axis=1) - \
        jnp.take_along_axis(cs1, t_pk, axis=1)
    s2p = jnp.take_along_axis(cs2, t_pk + lensj, axis=1) - \
        jnp.take_along_axis(cs2, t_pk, axis=1)
    lensf = lensj.astype(jnp.float32)
    dc_pk = s1p / lensf
    xn_pk = jnp.sqrt(jnp.maximum(s2p - lensf * dc_pk * dc_pk, 1e-12))
    floor = 0.05 * jnp.sqrt(lensf) * rms[:, None]
    val = (corr_pk - dc_pk * tsum[None, :]) / xn_pk
    val = jnp.where(xn_pk < floor, 0.0, val)
    return val, t_pk, dc_pk, xm


@partial(jax.jit, static_argnames=("lens_t", "block", "rescore",
                                   "positions"))
def _correlate_peaks_blocknorm(x, bank, lens_t, block=128, rescore=True,
                               positions=True):
    """Peak reduction with block-granular normalization + exact rescore.

    The exact path materializes per-position windowed-sum cubes
    ([C, K, T'] f32 x2 plus several elementwise passes) just to pick one
    argmax per (channel, type) — measured as the dominant detect-stage
    HBM traffic.  Here the raw correlation is ONE dense matmul (the
    einsum-Toeplitz form: overlapped B-sample frames x a banded
    [W, K*B] operand — measured ~1.7x the conv-form Toeplitz of
    ``_corr_toeplitz`` at detector geometry), the signal norm/DC used
    for the argmax are computed once per ``block`` output columns, and
    (``rescore=True``) the peak is re-scored with the EXACT
    per-position normalization of ``_correlate`` evaluated at the peak
    only, so reported scores are exact.  Only the argmax uses the
    approximation, whose window over-coverage (≤ B/L extra samples, a
    ~5-10% uniform score underestimate) shifts the picked peak at most
    between near-equal positions — absorbed by the header re-read
    confirmation (headcmp) exactly like the reference's block-max
    search (reference scan/dft_detect.c getCorrDFT :357-443 normalizes
    only its per-K-block maximum).  ``rescore=False`` (the prescreen)
    returns the approximate peak score and skips the sample-granular
    cumsums entirely.
    """
    C, T = x.shape
    K, lmax = bank.shape
    lens = np.asarray(lens_t)
    B = block
    nvalid = T - lmax + 1
    M = -(-nvalid // B)
    nbw = -(-(B + lmax - 1) // B)       # window span in B-blocks
    W = nbw * B

    # einsum-Toeplitz: rhs[w, k*B+j] = bank[k, w-j] (w-j in [0, lmax));
    # frames xwin[c, m] cover x[m*B : m*B + W] so out[c, m, k*B+j] is
    # the raw correlation at position t = m*B + j
    w_np = jnp.stack([
        jnp.pad(bank[k], (j, W - lmax - j))
        for k in range(K) for j in range(B)], axis=1)       # [W, K*B]
    Mb = -(-T // B)
    pad_to = max((M + nbw) * B, Mb * B)
    xp = jnp.pad(x, ((0, 0), (0, pad_to - T)))
    xb = xp.reshape(C, -1, B)
    xwin = jnp.concatenate([xb[:, i:i + M] for i in range(nbw)], axis=-1)
    corr = jnp.einsum("cmw,wo->cmo", xwin, w_np.astype(x.dtype),
                      precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=jnp.float32)
    corr = corr.astype(x.dtype).reshape(C, M, K, B)

    # block-granular norm terms: one value per output column m, shared
    # across the B in-block offsets
    xf32 = x.astype(jnp.float32)
    xbn = xb[:, :Mb].astype(jnp.float32)
    bs1 = xbn.sum(-1)
    bs2 = (xbn * xbn).sum(-1)
    cs1b = jnp.concatenate([jnp.zeros((C, 1), jnp.float32),
                            jnp.cumsum(bs1, axis=-1)], axis=-1)
    cs2b = jnp.concatenate([jnp.zeros((C, 1), jnp.float32),
                            jnp.cumsum(bs2, axis=-1)], axis=-1)
    tsum = jnp.sum(bank, axis=-1).astype(jnp.float32)      # [K]
    m_idx = jnp.arange(M)
    rms = jnp.sqrt(jnp.mean(xf32 * xf32, axis=-1))         # [C]
    # valid-position mask: t = m*B + j < nvalid
    t_pos = (m_idx[:, None] * B + jnp.arange(B)[None, :])  # [M, B]
    valid = t_pos < nvalid
    # per-type block norms are cheap ([C, M] cumsum gathers); the heavy
    # per-position work is ONE fused |corr - dc·tsum| argmax pass over
    # the corr cube.  xn is constant across the B in-block offsets, so
    # dividing by it cannot move the in-block argmax — normalization
    # applies only to the gathered per-block winners [C, M, K], never to
    # a per-position f32 score cube (the previous per-type normalize
    # loop materialized K such [C, M, B] cubes and dominated the
    # detect stage's HBM traffic).
    dcs, xns = [], []
    for k in range(K):
        L = int(lens[k])
        lb = min(-(-L // B) + 1, Mb)                       # cover t..t+L+B
        lo = jnp.minimum(m_idx, Mb - lb)
        s1 = jnp.take_along_axis(cs1b, lo[None] + lb, axis=1) - \
            jnp.take_along_axis(cs1b, lo[None], axis=1)    # [C, M]
        s2 = jnp.take_along_axis(cs2b, lo[None] + lb, axis=1) - \
            jnp.take_along_axis(cs2b, lo[None], axis=1)
        n = jnp.float32(lb * B)
        dc_a = s1 / n
        dcs.append(dc_a)
        xns.append(jnp.sqrt(jnp.maximum(s2 - n * dc_a * dc_a, 1e-12)))
    dc_all = jnp.stack(dcs, axis=2)                        # [C, M, K]
    xn_all = jnp.stack(xns, axis=2)
    lensf_k = jnp.asarray(lens, jnp.float32)[None, :]      # [1, K]
    floor_ck = 0.05 * jnp.sqrt(lensf_k) * rms[:, None]     # [C, K]
    tsum_b = tsum[None, None, :, None]
    # invalid tail positions score -1 < |any valid| >= 0, so the argmax
    # always lands on a valid position (every block has >= 1 valid j).
    # y stays in the stream dtype: this pass re-reads the whole corr
    # cube and the in-block argmax it feeds is already block-granular;
    # winners are re-scored exactly below (f32) before any threshold
    # decision
    y = jnp.abs(corr - (dc_all[..., None] * tsum_b).astype(corr.dtype))
    y = jnp.where(valid[None, :, None, :], y, -1.0)
    xm = jnp.mean(xf32, axis=-1)
    if not positions:
        # screening mode (prescreen.template_ratios): callers use only
        # |score| vs threshold — skip the argmax reduce and every
        # gather; the max pass is the single fused read of the corr cube
        y_best = jnp.max(y, axis=-1)                       # [C, M, K]
        score = y_best / xn_all
        score = jnp.where(xn_all < floor_ck[:, None, :], 0.0, score)
        val_abs = jnp.max(score, axis=1)                   # [C, K]
        zero = jnp.zeros_like(val_abs)
        return val_abs, zero.astype(jnp.int32), zero, xm
    j_best = jnp.argmax(y, axis=-1).astype(jnp.int32)      # [C, M, K]
    y_best = jnp.max(y, axis=-1)
    score = y_best / xn_all
    score = jnp.where(xn_all < floor_ck[:, None, :], 0.0, score)
    m_pk = jnp.argmax(score, axis=1)                       # [C, K]
    j_pk = jnp.take_along_axis(j_best, m_pk[:, None, :], axis=1)[:, 0]
    dc_a_pk = jnp.take_along_axis(dc_all, m_pk[:, None, :], axis=1)[:, 0]
    xn_pk_b = jnp.take_along_axis(xn_all, m_pk[:, None, :], axis=1)[:, 0]
    t_pk = (m_pk * B + j_pk).astype(jnp.int32)
    # signed block-norm score at the winner: one tiny [C, K] gather from
    # the corr cube (the rescore-path indexing pattern)
    corr_pk_b = jnp.take_along_axis(
        corr.reshape(C, M * K * B),
        (m_pk * (K * B) + jnp.arange(K)[None, :] * B + j_pk),
        axis=-1).astype(jnp.float32)
    val_a = (corr_pk_b - dc_a_pk * tsum[None, :]) / xn_pk_b
    val_a = jnp.where(xn_pk_b < floor_ck, 0.0, val_a)
    if not rescore:
        return val_a, t_pk, dc_a_pk, xm

    # gather the raw correlation at the peaks: corr[c, m_pk, k, j_pk]
    flat = corr.reshape(C, M * K * B)
    gidx = (m_pk * (K * B) + jnp.arange(K)[None, :] * B + j_pk)
    corr_pk = jnp.take_along_axis(flat, gidx, axis=-1).astype(jnp.float32)

    # exact per-position rescore at the peak (same math as _correlate)
    cs1 = jnp.concatenate([jnp.zeros((C, 1), jnp.float32),
                           jnp.cumsum(xf32, axis=-1)], axis=-1)
    cs2 = jnp.concatenate([jnp.zeros((C, 1), jnp.float32),
                           jnp.cumsum(xf32 * xf32, axis=-1)], axis=-1)
    lensj = jnp.asarray(lens, jnp.int32)[None, :]
    s1p = jnp.take_along_axis(cs1, t_pk + lensj, axis=1) - \
        jnp.take_along_axis(cs1, t_pk, axis=1)
    s2p = jnp.take_along_axis(cs2, t_pk + lensj, axis=1) - \
        jnp.take_along_axis(cs2, t_pk, axis=1)
    lensf = lensj.astype(jnp.float32)
    dc_pk = s1p / lensf
    xn_pk = jnp.sqrt(jnp.maximum(s2p - lensf * dc_pk * dc_pk, 1e-12))
    floor = 0.05 * jnp.sqrt(lensf) * rms[:, None]
    val = (corr_pk - dc_pk * tsum[None, :]) / xn_pk
    val = jnp.where(xn_pk < floor, 0.0, val)
    return val, t_pk, dc_pk, xm


# Peak-search strategy: the fully exact per-position cube (the path the
# CPU tests and PER gates validated); RSX_DETECT_PEAKS=exact|blocknorm
# forces the block-granular argmax + exact rescore.
_PEAKS_METHOD = os.environ.get("RSX_DETECT_PEAKS", "auto")


def _peaks_method():
    if _PEAKS_METHOD != "auto":
        return _PEAKS_METHOD
    return "exact"


def _correlate_peaks(x, bank, lens_t, rescore=True):
    if _peaks_method() == "exact" or x.shape[-1] < 2 * bank.shape[-1]:
        return _correlate_peaks_exact(x, bank, lens_t)
    if rescore:
        # chunked-scan form: bit-identical outputs, no materialized
        # correlation cube (the blocknorm stage's dominant HBM traffic)
        return _correlate_peaks_blocknorm_scan(x, bank, lens_t)
    return _correlate_peaks_blocknorm(x, bank, lens_t, rescore=rescore)


def _headcmp(x_c, spec, start, fs, inverted, dc):
    """Re-read header bits at symbol centers and count errors
    (reference headcmp, dft_detect.c:866-901)."""
    spb = fs / spec.sps
    idx = (start + (np.arange(len(spec.header)) + 0.5) * spb).astype(int)
    idx = idx[idx < len(x_c)]
    if len(idx) < len(spec.header):
        return len(spec.header)
    bits = (x_c[idx] - dc) > 0
    want = np.array([c == "1" for c in spec.header])
    if inverted:
        want = ~want
    return int(np.sum(bits != want))


def _frm_m10_m20(x_c, spec, start, fs, inverted, dc):
    """Disambiguate M10 vs M20 by decoding the frame length/type bytes
    right after the header (reference frm_M10, dft_detect.c:932-965).

    Returns "M10", "M20", or None (bytes implausible)."""
    from radiosonde_auto_rx_jax.models.m10 import (
        STD_FLEN_M10, STD_FLEN_M20, TYPE_M10, TYPE_M10PLUS, TYPE_M20,
        TYPE_M2K2, pairs_to_bits, diff_decode)
    from radiosonde_auto_rx_jax.demod.framing import bits_to_bytes_be
    spb = fs / spec.sps
    n_raw = 2 * 8 * 2                       # two bytes of raw pair bits
    idx = (start + (np.arange(n_raw) + 0.5) * spb).astype(int)
    idx = idx[idx < len(x_c)]
    if len(idx) < n_raw:
        return None
    raw = ((x_c[idx] - dc) > 0).astype(np.uint8)
    if inverted:
        raw = 1 - raw
    by = bits_to_bytes_be(diff_decode(pairs_to_bits(raw), b0=0))
    flen, ftype = int(by[0]), int(by[1])
    if ftype == TYPE_M20 or flen == STD_FLEN_M20:
        return "M20"
    if ftype in (TYPE_M10, TYPE_M10PLUS, TYPE_M2K2) or flen == STD_FLEN_M10:
        return "M10"
    return "M10"      # header matched; default like the reference


def _imet_subtype(x_c, pos, fs, wideband=False):
    """Resolve the shared iMet AFSK preamble to a concrete variant by
    tone power (reference dft_detect.c:1542-1607): accumulate ~1 s of
    FM-audio spectrum after the preamble and compare the 2200 Hz and
    2400 Hz data-tone powers.  2200 Hz dominant (and above the 800 Hz
    reference band) -> iMet-4 family (IMET1RS on wideband captures);
    2400 Hz dominant -> iMet-1 AB, which the reference drops to avoid
    blocking MRZ detection.

    Returns "IMET4" | "IMET1RS" | None (drop).
    """
    seg = x_c[pos:pos + int(fs)]
    if len(seg) < fs // 4:           # too little audio to vote on
        return None
    n_dft = 1024
    nseg = len(seg) // n_dft
    sp = np.abs(np.fft.rfft(
        seg[:nseg * n_dft].reshape(nseg, n_dft), axis=-1)).sum(axis=0)
    df = fs / n_dft
    if int(2500 / df) >= len(sp):
        return None
    m = max(1, int(50.0 / df))

    def band_power(f_hz):
        b = int(f_hz / df + 0.5)
        lo = max(0, b - m // 4)
        return float(sp[lo:lo + m].sum())

    pow2200, pow2400, pow800 = (band_power(f) for f in (2200, 2400, 800))
    if pow2200 > pow2400 and pow2200 > pow800:
        return "IMET1RS" if wideband else "IMET4"
    return None


def decide_from_peaks(val_a, ipk_a, dc_a, xm, specs, lens, chan,
                      fm_gain_hz=None, max_det=1, fs=48000,
                      wideband=False):
    """Host decision loop over per-(channel, type) correlation peaks:
    threshold -> header re-read confirmation (headcmp) -> M10/M20 and
    iMet subtype disambiguation -> Detection list per channel
    (reference scan/dft_detect.c:866-965,1509-1607).

    ``chan(c)`` lazily returns channel ``c``'s conditioned FM stream as
    float32 — shared by the single-device detector (detect_types) and
    the sharded station step's confirmation pass
    (parallel/station_step.py ShardedStationStep.confirm)."""
    C = val_a.shape[0]
    out = []
    for c in range(C):
        dets = []
        for k, spec in enumerate(specs):
            ipk = int(ipk_a[c, k])
            val = float(val_a[c, k])
            if abs(val) >= spec.thres:
                herrs = _headcmp(np.asarray(chan(c)), spec, ipk, fs,
                                 val < 0, float(dc_a[c, k]))
                if herrs > spec.herrs:
                    continue
                off = 0.0
                if fm_gain_hz is not None:
                    # frequency offset from the stream mean: headers are
                    # not DC-balanced, so the whole dwell (payload
                    # averages out) beats the header window
                    off = float(xm[c]) * fm_gain_hz
                name = spec.name
                if name == "M10":
                    sub = _frm_m10_m20(chan(c), spec, ipk + int(lens[k]),
                                       fs, val < 0, float(dc_a[c, k]))
                    if sub is not None:
                        name = sub
                elif name == "IMETafsk":
                    sub = _imet_subtype(chan(c), ipk + int(lens[k]), fs,
                                        wideband)
                    if sub is None:
                        continue        # 2400 Hz dominant: not iMet-4/1RS
                    name = sub
                tn = {"IMET4": 26, "IMET1RS": 28,
                      "M20": 6}.get(name, spec.tn)
                dets.append(Detection(
                    name=name, tn=tn, score=abs(val),
                    position=ipk + int(lens[k]),
                    inverted=val < 0, freq_offset=off))
        dets.sort(key=lambda d: d.score, reverse=True)
        out.append(dets[:max_det] if max_det else dets)
    return out


def detect_types(x, bank, lens, specs, fm_gain_hz=None, max_det=1,
                 fs=48000, wideband=False):
    """Detect sonde types in FM stream(s).

    x: [T] or [C, T] float32 FM discriminator output (≈ normalized
    instantaneous frequency).  Returns per channel a list of Detection
    sorted by score (reference emits the best type, dft_detect.c:1612-1666).
    Candidates are confirmed by re-reading the header bits at the detected
    position and bounding the bit errors (reference headcmp + herrs,
    dft_detect.c:866-901,1509-1524).
    ``fm_gain_hz``: scale from FM units to Hz for the frequency-offset
    estimate (reference df = dc/(2*FM_GAIN*decM), :438-442).
    """
    single = np.ndim(x) == 1
    xj = jnp.asarray(x)
    if not jnp.issubdtype(xj.dtype, jnp.floating):
        xj = xj.astype(jnp.float32)
    if xj.ndim == 1:
        xj = xj[None, :]
    val_a, ipk_a, dc_a, xm = _correlate_peaks(
        xj, jnp.asarray(bank).astype(xj.dtype),
        tuple(int(v) for v in lens))
    # only [C, K] peak stats cross to the host; the FM streams stay on
    # device and are fetched lazily per channel, only when a candidate
    # clears its threshold (rare: most scan channels are noise)
    val_a, ipk_a, dc_a, xm = (np.asarray(v) for v in
                              (val_a, ipk_a, dc_a, xm))
    _cache = {}

    def chan(c):
        if c not in _cache:
            # host re-read path: always fetch f32 (streams may be bf16)
            _cache[c] = np.asarray(xj[c].astype(jnp.float32))
        return _cache[c]

    out = decide_from_peaks(val_a, ipk_a, dc_a, xm, specs, lens, chan,
                            fm_gain_hz=fm_gain_hz, max_det=max_det,
                            fs=fs, wideband=wideband)
    return out[0] if single else out
