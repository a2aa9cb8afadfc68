"""FIR filter design and channel-batched filtering.

Design matches the reference's windowed-sinc Blackman lowpass
(reference demod/mod/demod_mod.c:555-587, scan/dft_detect.c lowpass_init);
execution is re-derived as batched convolution over ``[C, T]`` blocks via
``lax.conv_general_dilated`` or its blocked-Toeplitz matmul form.  Every
conv runs at ``Precision.HIGHEST`` (exact f32, never TF32): these filters
sit on the decode path the PER gates were validated on.  A streaming variant carries the
``taps-1`` tail between blocks — that tail is exactly the halo exchanged
between time shards in the sequence-parallel layout (see parallel/halo.py).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def design_lowpass(cutoff_norm: float, taps: int) -> np.ndarray:
    """Blackman-windowed sinc lowpass.

    Args:
        cutoff_norm: cutoff as a fraction of the sample rate (0 < f < 0.5).
        taps: number of taps; rounded up to odd.

    Matches reference demod/mod/demod_mod.c:555-587 (coefficients 1-norm
    normalised, Blackman window 7938/18608 - 9240/18608 cos + 1430/18608 cos).
    """
    if taps % 2 == 0:
        taps += 1
    taps = max(taps, 1)
    n = np.arange(taps, dtype=np.float64)
    if taps > 1:
        w = (
            7938 / 18608.0
            - 9240 / 18608.0 * np.cos(2 * np.pi * n / (taps - 1))
            + 1430 / 18608.0 * np.cos(4 * np.pi * n / (taps - 1))
        )
    else:
        w = np.ones(1)
    x = 2.0 * cutoff_norm * (n - (taps - 1) / 2)
    h = 2.0 * cutoff_norm * np.sinc(x)
    ws = w * h
    ws /= ws.sum()
    return ws.astype(np.float32)


def design_lowpass_for_transition(cutoff_norm: float, transition_norm: float) -> np.ndarray:
    """Lowpass with taps sized from the transition bandwidth (taps ~= 4/tbw),
    the reference's sizing rule (scan/dft_detect.c:1056-1060)."""
    taps = int(4.0 / max(transition_norm, 1e-6))
    if taps % 2 == 0:
        taps += 1
    return design_lowpass(cutoff_norm, taps)


def _conv_same(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """'same'-length convolution of real/complex [C, T] with real taps [K].

    Zero-phase alignment: output[t] = sum_k h[k] * x[t + k - (K-1)//2].
    Complex inputs are filtered as two real planes (XLA convs are real).
    """
    if jnp.iscomplexobj(x):
        re = _conv_same(x.real, h)
        im = _conv_same(x.imag, h)
        return jax.lax.complex(re, im)
    C, T = x.shape
    K = h.shape[0]
    lhs = x[:, None, :]                      # [C, 1, T]  (N, C, W)
    rhs = h[::-1][None, None, :].astype(x.dtype)  # [1, 1, K]  (O, I, W)
    pad = ((K - 1) // 2, K - 1 - (K - 1) // 2)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding=[pad],
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :]


@partial(jax.jit, static_argnames=())
def fir_filter(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Filter [C, T] (or [T]) by taps h, 'same' length, group-delay aligned."""
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    y = _conv_same(x, h)
    return y[0] if squeeze else y


def _toeplitz_rows(h: jnp.ndarray, block: int, stride: int = 1
                   ) -> jnp.ndarray:
    """[K] taps -> [block, stride*(block-1)+K] rows w[j, i] = h[i - j*stride].

    Stacking a filter into `block` shifted copies turns a 1-output-column
    FIR conv into a dense [*, K+B-1] x [K+B-1, B] matmul with B output
    columns instead of one, for a (B+K-1)/K flop overhead.  ``stride`` spaces
    the rows so the matmul emits every stride-th output sample (fused
    filter + decimate).
    """
    B = block
    return jnp.stack([jnp.pad(h, (j * stride, (B - 1 - j) * stride))
                      for j in range(B)])


def fir_filter_block(x: jnp.ndarray, hs: jnp.ndarray, block: int = 256,
                     stride: int = 1):
    """Matmul-dense FIR: filter [C, T] by a bank ``hs`` [F, K] -> [C, F, T'].

    Output matches ``fir_filter`` ('same' length, group-delay aligned) for
    each row of ``hs`` to f32 matmul accumulation order.  Implemented as a
    stride-``block`` conv whose kernel emits a full block of output
    samples per filter, i.e. a blocked-Toeplitz matmul.

    ``stride`` > 1 emits every stride-th output sample (T' = ceil(T/stride)),
    fusing the decimation into the same matmul — the filtered stream never
    hits HBM at the full rate.
    """
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    if hs.ndim == 1:
        hs = hs[None, :]
    C, T = x.shape
    F, K = hs.shape
    B = block
    S = int(stride)
    Tout = -(-T // S)
    M = -(-Tout // B)
    d = (K - 1) // 2
    # _conv_same computes y[t] = sum_k xpad[t+k] * h[K-1-k]
    hf = hs[:, ::-1]
    xp = jnp.pad(x, ((0, 0), (d, (K - 1 - d) + (M * B * S - T))))
    w = jax.vmap(lambda h: _toeplitz_rows(h, B, S))(hf)
    rhs = w.reshape(F * B, 1, S * (B - 1) + K).astype(x.dtype)
    out = jax.lax.conv_general_dilated(
        xp[:, None, :], rhs, window_strides=(B * S,), padding=[(0, 0)],
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST)                # [C, F*B, M]
    y = out.reshape(C, F, B, M).transpose(0, 1, 3, 2).reshape(C, F, M * B)
    y = y[:, :, :Tout]
    return y[0] if squeeze else y


def fir_filter_streaming(x_block: jnp.ndarray, h: jnp.ndarray, tail: jnp.ndarray):
    """Causal streaming FIR: returns (y_block, new_tail).

    ``tail`` is the last K-1 input samples of the previous block
    ([C, K-1]); the returned block is time-aligned with the input block
    delayed by the filter group delay (K-1)/2 relative to a 'same' filter.
    This is the single-device form of overlap-save; across time shards the
    tail becomes a ppermute halo (parallel/halo.py).
    """
    K = h.shape[0]
    xx = jnp.concatenate([tail, x_block], axis=-1)     # [C, K-1+T]
    if jnp.iscomplexobj(xx):
        re = _conv_valid(xx.real, h)
        im = _conv_valid(xx.imag, h)
        y = jax.lax.complex(re, im)
    else:
        y = _conv_valid(xx, h)
    new_tail = xx[:, -(K - 1):] if K > 1 else xx[:, :0]
    return y, new_tail


def _conv_valid(x: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    C, T = x.shape
    K = h.shape[0]
    lhs = x[:, None, :]
    rhs = h[::-1][None, None, :].astype(x.dtype)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, window_strides=(1,), padding=[(0, 0)],
        dimension_numbers=("NCW", "OIW", "NCW"),
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[:, 0, :]


def decimate(x: jnp.ndarray, factor: int, h: np.ndarray | None = None) -> jnp.ndarray:
    """Lowpass + M:1 decimation of [C, T] → [C, T//M].

    Mirrors the reference's decimate stage (demod/mod/demod_mod.c:734-755,
    scan/dft_detect.c:1021-1062) but strided-conv based so XLA fuses the
    filter and the downsample into one pass.
    """
    if factor == 1:
        return x
    if h is None:
        # cutoff at 0.45 of the output Nyquist, transition 0.1 of output rate
        h = design_lowpass_for_transition(0.45 / factor, 0.1 / factor)
    hj = jnp.asarray(h)
    K = hj.shape[0]
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]

    def strided(xr):
        lhs = xr[:, None, :]
        rhs = hj[::-1][None, None, :].astype(xr.dtype)
        pad = ((K - 1) // 2, K - 1 - (K - 1) // 2)
        out = jax.lax.conv_general_dilated(
            lhs, rhs, window_strides=(factor,), padding=[pad],
            dimension_numbers=("NCW", "OIW", "NCW"),
            precision=jax.lax.Precision.HIGHEST,
        )
        return out[:, 0, :]

    if jnp.iscomplexobj(x):
        y = jax.lax.complex(strided(x.real), strided(x.imag))
    else:
        y = strided(x)
    return y[0] if squeeze else y
