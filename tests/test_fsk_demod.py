"""FSK demod core: bit recovery, batching, noise performance."""

import numpy as np
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.demod.fsk import (
    FSKConfig, fsk_demod_stream, fsk_init_state)
from radiosonde_auto_rx_jax.demod.modulate import fsk_mod, gfsk_mod, add_awgn


def _ber(tx_bits, rx_bits, max_shift=16):
    """Best-alignment BER: demod output leads/lags by an a-priori-unknown
    couple of symbols (window fill + timing), so slide ±max_shift."""
    best = 1.0
    n = min(len(rx_bits), len(tx_bits)) - max_shift
    for off in range(0, max_shift):
        best = min(best, np.mean(np.asarray(tx_bits)[off:off + n] != np.asarray(rx_bits)[:n]))
        best = min(best, np.mean(np.asarray(rx_bits)[off:off + n] != np.asarray(tx_bits)[:n]))
    return best


RS41_CFG = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                     est_min=-5000, est_max=5000,
                     tone_spacing=5000, freq_est_type=1)


def test_2fsk_clean_bits(rng):
    cfg = RS41_CFG
    tx = rng.integers(0, 2, size=6000)
    iq = fsk_mod(tx, cfg.fs, cfg.rs, 2, f1=-2500, tone_spacing=5000)
    soft, bits, stats, _ = fsk_demod_stream(cfg, jnp.asarray(iq))
    rx = np.asarray(bits)
    assert len(rx) > 4000
    assert _ber(tx, rx) < 1e-3
    # soft sign convention: positive ⇒ bit 0 (reference fsk.c:792)
    sx = np.asarray(soft)
    assert np.mean((sx < 0) == rx.astype(bool)) > 0.999


def test_2fsk_peak_estimator(rng):
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000)
    tx = rng.integers(0, 2, size=6000)
    iq = fsk_mod(tx, cfg.fs, cfg.rs, 2, f1=-2500, tone_spacing=5000)
    _, bits, stats, _ = fsk_demod_stream(cfg, jnp.asarray(iq))
    assert _ber(tx, np.asarray(bits)) < 1e-3
    f = np.asarray(stats["f_est"])[0, -1]
    assert abs(f[0] - (-2500)) < 400 and abs(f[1] - 2500) < 400


def test_4fsk_clean_bits(rng):
    cfg = FSKConfig(fs=48000, rs=2400, m=4, p=5, nsym=100,
                    est_min=-10000, est_max=10000)
    tx = rng.integers(0, 2, size=4000)
    iq = fsk_mod(tx, cfg.fs, cfg.rs, 4, f1=-3600, tone_spacing=2400)
    soft, bits, _, _ = fsk_demod_stream(cfg, jnp.asarray(iq))
    rx = np.asarray(bits)
    assert _ber(tx, rx) < 1e-3
    # 4FSK soft convention: positive ⇒ bit 1 (reference fsk.c:794-803)
    sx = np.asarray(soft)
    assert np.mean((sx >= 0) == rx.astype(bool)) > 0.999


def test_channel_batching_matches_single(rng):
    cfg = RS41_CFG
    txs = [rng.integers(0, 2, size=4500) for _ in range(3)]
    iqs = [fsk_mod(t, cfg.fs, cfg.rs, 2, f1=-2500 + 300 * i, tone_spacing=5000)
           for i, t in enumerate(txs)]
    tmin = min(len(q) for q in iqs)
    batch = jnp.asarray(np.stack([q[:tmin] for q in iqs]))
    _, bits_b, _, _ = fsk_demod_stream(cfg, batch)
    for i, q in enumerate(iqs):
        _, bits_1, _, _ = fsk_demod_stream(cfg, jnp.asarray(q[:tmin]))
        np.testing.assert_array_equal(np.asarray(bits_b)[i], np.asarray(bits_1))


@pytest.mark.parametrize("ebno_db,max_ber", [(12.0, 2e-3), (9.0, 3e-2)])
def test_2fsk_noise_ber(rng, ebno_db, max_ber):
    """Non-coherent 2FSK theory: BER = 0.5*exp(-EbN0/2) ⇒ 0.9% @ 9 dB,
    0.018% @ 12 dB. Allow slack for sync/estimation losses."""
    cfg = RS41_CFG
    tx = rng.integers(0, 2, size=24000)
    iq = fsk_mod(tx, cfg.fs, cfg.rs, 2, f1=-2500, tone_spacing=5000)
    iq = add_awgn(iq, ebno_db, cfg.fs, cfg.rs, 1, rng)
    _, bits, _, _ = fsk_demod_stream(cfg, jnp.asarray(iq))
    assert _ber(tx, np.asarray(bits)) < max_ber


def test_gfsk_freq_offset(rng):
    """GFSK with a 2 kHz carrier offset still demodulates (the FM-chain
    failure mode the fsk estimator fixes; reference test notes
    2019-04-26_fsk_demod.md)."""
    cfg = RS41_CFG
    tx = rng.integers(0, 2, size=9000)
    iq = gfsk_mod(tx, cfg.fs, cfg.rs, 2, f_centre=2000, tone_spacing=4800,
                  bt=0.5)
    iq = add_awgn(iq, 15.0, cfg.fs, cfg.rs, 1, rng)
    _, bits, _, _ = fsk_demod_stream(cfg, jnp.asarray(iq))
    assert _ber(tx, np.asarray(bits)) < 5e-3
