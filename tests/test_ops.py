"""DSP primitive ops: filter design, filtering, FM discriminator, mixer."""

import numpy as np
import jax.numpy as jnp

from radiosonde_auto_rx_jax.ops import (
    design_lowpass, fir_filter, fir_filter_streaming, decimate,
    freq_shift, fm_discriminate,
)


def test_lowpass_response():
    h = design_lowpass(0.1, 101)
    assert abs(h.sum() - 1.0) < 1e-6
    w = np.fft.rfftfreq(4096)
    H = np.abs(np.fft.rfft(h, 4096))
    assert np.all(H[w < 0.05] > 0.97)         # passband
    assert np.all(H[w > 0.16] < 0.01)         # stopband


def test_fir_filter_matches_numpy(rng):
    h = design_lowpass(0.1, 31)
    x = rng.standard_normal((3, 256)).astype(np.float32)
    y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(h)))
    for c in range(3):
        ref = np.convolve(x[c], h, mode="same")
        np.testing.assert_allclose(y[c], ref, atol=1e-5)


def test_fir_filter_complex(rng):
    h = design_lowpass(0.2, 21)
    x = (rng.standard_normal((2, 128)) + 1j * rng.standard_normal((2, 128))
         ).astype(np.complex64)
    y = np.asarray(fir_filter(jnp.asarray(x), jnp.asarray(h)))
    ref = np.stack([np.convolve(x[c], h, mode="same") for c in range(2)])
    np.testing.assert_allclose(y, ref, atol=1e-5)


def test_streaming_fir_equals_batch(rng):
    """Block-streamed filtering with carried tails == one-shot filtering:
    the invariant the time-shard halo exchange relies on."""
    h = jnp.asarray(design_lowpass(0.15, 33))
    K = h.shape[0]
    x = rng.standard_normal((2, 512)).astype(np.float32)
    full = np.asarray(fir_filter(jnp.asarray(x), h))
    tail = jnp.zeros((2, K - 1), jnp.float32)
    outs = []
    for b in range(4):
        blk = jnp.asarray(x[:, b * 128:(b + 1) * 128])
        y, tail = fir_filter_streaming(blk, h, tail)
        outs.append(np.asarray(y))
    stream = np.concatenate(outs, axis=-1)
    # streaming output is causal: delayed by (K-1)//2 vs 'same'
    d = (K - 1) // 2
    np.testing.assert_allclose(stream[:, d:], full[:, :-d], atol=1e-5)


def test_decimate_tone(rng):
    fs = 96000
    t = np.arange(8 * 4096) / fs
    x = np.exp(2j * np.pi * 1000 * t).astype(np.complex64)[None, :]
    y = np.asarray(decimate(jnp.asarray(x), 2))
    assert y.shape[-1] == x.shape[-1] // 2
    # tone passes with ~unit gain
    mid = y[0, 1000:-1000]
    assert abs(np.mean(np.abs(mid)) - 1.0) < 0.05
    # and advances at the decimated rate
    ph = np.angle(mid[1:] * np.conj(mid[:-1]))
    np.testing.assert_allclose(np.mean(ph), 2 * np.pi * 1000 / 48000, rtol=1e-3)


def test_freq_shift_moves_tone():
    fs = 48000
    t = np.arange(4096) / fs
    x = np.exp(2j * np.pi * 5000 * t).astype(np.complex64)
    y = np.asarray(freq_shift(jnp.asarray(x), -5000 / fs))
    ph = np.angle(y[1:] * np.conj(y[:-1]))
    assert np.abs(np.mean(ph)) < 1e-3  # shifted to DC


def test_fm_discriminator_tone():
    fs = 48000
    f = 3000.0
    t = np.arange(2048) / fs
    z = np.exp(2j * np.pi * f * t).astype(np.complex64)
    s = np.asarray(fm_discriminate(jnp.asarray(z)))
    # s = gain * 2*pi*f/fs / pi = gain * 2f/fs (reference demod_mod.c:773)
    np.testing.assert_allclose(s[10:], 0.8 * 2 * f / fs, atol=1e-4)


def test_fir_filter_block_matches_fir_filter(rng):
    """Blocked-Toeplitz FIR (matmul-dense path) == plain conv FIR, including
    filter banks, odd lengths, and T < block."""
    from radiosonde_auto_rx_jax.ops.fir import fir_filter_block

    x = jnp.asarray(rng.standard_normal((4, 1000)).astype(np.float32))
    hs = jnp.stack([jnp.asarray(design_lowpass(c, 97))
                    for c in (0.05, 0.1, 0.2)])
    y = np.asarray(fir_filter_block(x, hs))
    assert y.shape == (4, 3, 1000)
    for f in range(3):
        ref = np.asarray(fir_filter(x, hs[f]))
        np.testing.assert_allclose(y[:, f], ref, atol=1e-5)
    # short input (T < block) and 1-D squeeze
    xs = x[0, :50]
    ref = np.asarray(fir_filter(xs, hs[0]))
    np.testing.assert_allclose(
        np.asarray(fir_filter_block(xs, hs[0])[0]), ref, atol=1e-5)
