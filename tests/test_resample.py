"""Polyphase rational resampler (tsrc equivalent)."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.ops.resample import (rational_ratio, resample,
                                                 resample_planes)


def test_rational_ratio():
    assert rational_ratio(96000, 48080) == (601, 1200)
    assert rational_ratio(48000, 48000) == (1, 1)
    l, m = rational_ratio(48000, 48080)
    assert abs(l / m - 48080 / 48000) < 1e-9


def _tone_snr(y, f, fs):
    """SNR of y against a best-fit complex tone at f (dB)."""
    t = np.arange(len(y)) / fs
    ref = np.exp(2j * np.pi * f * t)
    a = np.vdot(ref, y) / len(y)
    resid = y - a * ref
    return (10 * np.log10(np.abs(a) ** 2 /
                          max(np.mean(np.abs(resid) ** 2), 1e-20)),
            np.abs(a))


@pytest.mark.parametrize("fs_out", [48080, 50000, 44100])
def test_tone_preserved(fs_out):
    fs_in, f0 = 48000, 3500.0
    t = np.arange(48000) / fs_in
    x = np.stack([np.cos(2 * np.pi * f0 * t),
                  np.sin(2 * np.pi * f0 * t)]).astype(np.float32)
    y = np.asarray(resample_planes(x, fs_in, fs_out))
    yc = y[0] + 1j * y[1]
    yc = yc[100:-100]                     # trim filter edges
    snr, amp = _tone_snr(yc, f0, fs_out)
    assert snr > 45, f"resampled tone SNR {snr:.1f} dB"
    assert abs(amp - 1.0) < 0.02


def test_identity_passthrough():
    x = np.random.default_rng(0).standard_normal((2, 1000)).astype(np.float32)
    y = np.asarray(resample(x, 48000, 48000))
    np.testing.assert_array_equal(y, x)


def test_batched_matches_single(rng):
    x = rng.standard_normal((3, 2, 4000)).astype(np.float32)
    y_all = np.asarray(resample_planes(x, 96000, 48080))
    y_one = np.asarray(resample_planes(x[1], 96000, 48080))
    np.testing.assert_allclose(y_all[1], y_one, rtol=1e-6)
    assert y_all.shape[-1] == int((4000 - 16) * 601 / 1200)


def test_m10_chain_via_resampler(rng):
    """M10-style 9616 Bd stream demods cleanly after 48k->48.08k
    resampling (Ts becomes exactly 5).

    Resampling preserves REAL-TIME baud rate, so the on-air signal is
    synthesized at true 9616 Bd (integer Ts of 5 at 48080 Hz), then
    resampled down to the 48 kHz capture rate — the reverse of the
    production path — before the production 48k->48.08k resample."""
    import jax.numpy as jnp
    from radiosonde_auto_rx_jax.demod import FSKConfig, fsk_demod_stream
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn
    fs0, fs1, rs = 48000, 48080, 9616
    tx = rng.integers(0, 2, 6000).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, fs1, rs, 2, 0.0, 9616), 14.0, fs1, rs)
    x_air = np.stack([iq.real, iq.imag]).astype(np.float32)
    x0 = resample_planes(x_air, fs1, fs0)      # the 48 kHz channel
    x1 = resample_planes(np.asarray(x0), fs0, fs1)
    cfg = FSKConfig(fs=fs1, rs=rs, m=2, p=5, nsym=96,
                    est_min=-10000, est_max=10000)
    soft, bits, stats, _ = fsk_demod_stream(cfg, jnp.asarray(x1)[None])
    bits = np.asarray(bits)[0]
    best = 1.0
    for off in range(200):
        n = min(len(bits), len(tx) - off)
        if n > 100:
            best = min(best, float(np.mean(bits[:n] != tx[off:off + n])))
    assert best < 0.01, f"BER {best:.3f}"
