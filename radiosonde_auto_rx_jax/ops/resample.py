"""Polyphase rational resampler — the ``tsrc`` equivalent.

The reference shells out to libsamplerate for non-integer rate ratios
(reference utils/tsrc.c:60-77, used for the M10 96k->48.08k chain,
auto_rx/test/README.md:13-22).  Here the same windowed-sinc polyphase
structure runs as one dense matmul: for a rational ratio L/M every
output sample n is

    y[n] = sum_j x[base_n - j] * h[j*L + p_n],   n*M = base_n*L + p_n

and (base_n, p_n) repeat exactly with period L outputs / M inputs, so
outputs come L at a time from input frames of hop M —
``y[b, :] = frames[b, :] @ W`` with a host-built banded weight matrix
``W [M+taps, L]``.  Frames are shifted reshaped views (no gather) and
the only constant is W (a few MB at worst) — no O(T·taps) index
constants in the program and no gather.  The matmul runs at
``Precision.HIGHEST`` (exact f32, never TF32).
"""

from fractions import Fraction
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp


def rational_ratio(fs_in: float, fs_out: float, max_den: int = 5000):
    """(L, M) with fs_out/fs_in ~= L/M, denominator bounded."""
    fr = Fraction(fs_out / fs_in).limit_denominator(max_den)
    return fr.numerator, fr.denominator


@lru_cache(maxsize=None)
def _poly_bank(l_up: int, m_down: int, taps_per_phase: int):
    """Polyphase bank [L, taps] of the windowed-sinc prototype (gain L)."""
    n = taps_per_phase * l_up
    cutoff = 0.47 / max(l_up, m_down)        # of the upsampled rate
    t = np.arange(n) - (n - 1) / 2.0
    h = 2 * cutoff * np.sinc(2 * cutoff * t)
    h *= np.blackman(n)
    # decompose: bank[p, j] = h[j*L + p]
    bank = np.zeros((l_up, taps_per_phase), np.float32)
    for p in range(l_up):
        row = h[p::l_up]
        bank[p, :len(row)] = row
    # unity DC gain per phase row -> flat gain across fractional delays
    bank /= bank.sum(axis=1, keepdims=True).clip(1e-9)
    return bank


@lru_cache(maxsize=None)
def _block_weights(l_up: int, m_down: int, taps_per_phase: int):
    """Banded weight matrix W [win, L] with
    y[b*L + p] = sum_i x[b*M + i_min + i] * W[i, p], plus (i_min, win).
    """
    half = taps_per_phase // 2
    bank = _poly_bank(l_up, m_down, taps_per_phase)       # [L, taps]
    p = np.arange(l_up, dtype=np.int64)
    base0 = (p * m_down) // l_up + half                   # [L]
    phase0 = (p * m_down) % l_up
    i_min = int(base0.min()) - taps_per_phase + 1
    i_max = int(base0.max())
    win = i_max - i_min + 1
    w = np.zeros((win, l_up), np.float32)
    for pp in range(l_up):
        j = np.arange(taps_per_phase)
        w[base0[pp] - j - i_min, pp] = bank[phase0[pp], j]
    return w, i_min, win


@partial(jax.jit, static_argnames=("l_up", "m_down", "taps_per_phase"))
def _resample(x, l_up, m_down, taps_per_phase):
    t_in = x.shape[-1]
    n_out = (t_in - taps_per_phase) * l_up // m_down
    w, i_min, win = _block_weights(l_up, m_down, taps_per_phase)
    n_blk = -(-n_out // l_up)
    # frame b covers x[b*M + i_min : b*M + i_min + win]; edge-replicate
    # padding reproduces the index clip of the per-output formulation
    pad_l = max(0, -i_min)                                # i_min <= 0
    nq = -(-win // m_down)
    need = (n_blk - 1 + nq) * m_down                      # xs length used
    pad_r = max(0, need + i_min - t_in)
    xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad_l, pad_r)],
                 mode="edge")
    xs = xp[..., i_min + pad_l:]                          # start at i_min
    tile = xs[..., :(n_blk - 1 + nq) * m_down]
    tile = tile.reshape(tile.shape[:-1] + (n_blk - 1 + nq, m_down))
    frames = jnp.concatenate(
        [tile[..., q:q + n_blk, :] for q in range(nq)], axis=-1)
    frames = frames[..., :win]                            # [.., n_blk, win]
    wj = jnp.asarray(w)
    mm = partial(jnp.einsum, "...bw,wp->...bp",
                 precision=jax.lax.Precision.HIGHEST)
    if jnp.iscomplexobj(frames):
        y = jax.lax.complex(mm(frames.real, wj), mm(frames.imag, wj))
    else:
        y = mm(frames, wj, preferred_element_type=jnp.float32)
    y = y.reshape(y.shape[:-2] + (n_blk * l_up,))
    return y[..., :n_out]


def resample(x, fs_in: float, fs_out: float, taps_per_phase: int = 16,
             max_den: int = 5000):
    """Resample along the last axis; works on [..., T] float or complex
    planes [..., 2, T].  Returns [..., floor((T-taps)*L/M)] samples at
    fs_out.  Identity ratios pass through untouched."""
    l_up, m_down = rational_ratio(fs_in, fs_out, max_den)
    if l_up == m_down:
        return jnp.asarray(x)
    return _resample(jnp.asarray(x, jnp.float32) if not
                     jnp.iscomplexobj(x) else x, l_up, m_down,
                     taps_per_phase)


def resample_planes(x, fs_in: float, fs_out: float, **kw):
    """[C, 2, T] or [2, T] float32 planes -> resampled planes."""
    return resample(jnp.asarray(x, jnp.float32), fs_in, fs_out, **kw)
