"""Plain-JAX spectral stages against NumPy FFT references: the Welch PSD
(dense windowed-DFT matmul) and the demod's frequency estimator."""

import numpy as np
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.demod.fsk import FSKConfig, _freq_est
from radiosonde_auto_rx_jax.detect.psd import _welch


def _hann(n):
    k = np.arange(n)
    return 0.5 - 0.5 * np.cos(2 * np.pi * k / (n - 1))


def _welch_ref(z, nfft, hop):
    """float64 Welch: hann windows every ``hop`` samples, fftshifted,
    normalized as _welch (window power 1)."""
    win = _hann(nfft)
    win = win / np.sqrt(np.sum(win ** 2) / nfft)
    nseg = (z.shape[-1] - nfft) // hop + 1
    segs = np.stack([z[:, s * hop:s * hop + nfft] for s in range(nseg)],
                    axis=1)
    X = np.fft.fftshift(np.fft.fft(segs * win, axis=-1), axes=-1)
    return (np.abs(X) ** 2).mean(axis=1) / nfft


@pytest.mark.parametrize("nfft", [64, 128, 256, 512, 1024, 2048])
def test_welch_matches_numpy_fft(nfft):
    rng = np.random.default_rng(nfft)
    T = 8 * nfft + nfft // 2
    t = np.arange(T)
    z = (rng.standard_normal((2, T)) + 1j * rng.standard_normal((2, T))
         ) * 0.1
    z[0] += np.exp(2j * np.pi * 0.123 * t)        # a tone over the floor
    planes = np.stack([z.real, z.imag], axis=1).astype(np.float32)
    got = np.asarray(_welch(jnp.asarray(planes), nfft))
    ref = _welch_ref(planes[:, 0] + 1j * planes[:, 1].astype(np.float64),
                     nfft, nfft // 2)
    # exact f32 (Precision.HIGHEST): error ~1e-7 of the peak bin
    assert np.abs(got - ref).max() <= 1e-5 * ref.max()
    assert np.abs(10 * np.log10(got / ref)).max() < 0.01


@pytest.mark.parametrize("m,spacing,mask", [(2, 2400, 0), (4, 1200, 1)])
def test_freq_est_matches_numpy_fft(m, spacing, mask):
    """_freq_est's spectral EMA equals a NumPy FFT of the same hann
    windows, and its tone estimates land on the transmitted tones."""
    cfg = FSKConfig(fs=48000, rs=1200, m=m, p=8, nsym=100,
                    est_min=-8000, est_max=8000,
                    tone_spacing=spacing if mask else 0,
                    freq_est_type=mask)
    rng = np.random.default_rng(m)
    f1 = -1800.0
    syms = rng.integers(0, m, cfg.nmem // cfg.ts + 1)
    f = np.repeat(f1 + syms * spacing, cfg.ts)[:cfg.nmem]
    z = np.exp(2j * np.pi * np.cumsum(f) / cfg.fs)
    z += (rng.standard_normal(cfg.nmem) +
          1j * rng.standard_normal(cfg.nmem)) * 0.05
    xw = np.stack([z.real, z.imag])[None].astype(np.float32)
    f_est, sf = _freq_est(cfg, jnp.asarray(xw),
                          jnp.zeros((1, cfg.ndft), jnp.float32))

    ndft, half = cfg.ndft, cfg.ndft // 2
    starts = (cfg.nmem - cfg.n) + np.arange(cfg.numffts) * half
    zz = xw[0, 0] + 1j * xw[0, 1].astype(np.float64)
    mag = np.abs(np.fft.fftshift(np.fft.fft(
        np.stack([zz[s:s + ndft] for s in starts]) * _hann(ndft),
        axis=-1), axes=-1))
    tc = cfg.tc
    w = tc * (1.0 - tc) ** (cfg.numffts - 1 - np.arange(cfg.numffts))
    sf_ref = (mag * w[:, None]).sum(axis=0)
    np.testing.assert_allclose(np.asarray(sf)[0], sf_ref,
                               rtol=1e-4, atol=1e-4 * sf_ref.max())
    tones = f1 + np.arange(m) * spacing
    bin_hz = cfg.fs / ndft
    assert np.abs(np.sort(np.asarray(f_est)[0]) - tones).max() <= bin_hz
