"""modem_probe equivalent: probe buffers + demod internal trajectories."""

import numpy as np
import jax.numpy as jnp

from radiosonde_auto_rx_jax.utils import probe


def test_probe_disabled_noop():
    probe.enable(False)
    probe.reset()
    probe.probe_samp("x", np.ones(4))
    assert probe.names() == []
    probe.enable(True)
    try:
        probe.probe_samp("x", np.ones(4))
        probe.probe_samp("x", np.zeros(2))
        assert probe.probe_stream("x").shape == (6,)
    finally:
        probe.enable(False)
        probe.reset()


def test_dump_npz(tmp_path):
    probe.enable(True)
    try:
        probe.reset()
        probe.probe_samp("fsk_sf", np.arange(8.0).reshape(2, 4))
        out = probe.dump(str(tmp_path / "probe.npz"))
        data = np.load(out)
        assert data["fsk_sf"].shape == (2, 4)
    finally:
        probe.enable(False)
        probe.reset()


def test_demod_probe_internals(rng):
    from radiosonde_auto_rx_jax.demod import FSKConfig, fsk_demod_stream
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=50,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    tx = rng.integers(0, 2, 2000)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 5000), 12.0, 48000, 4800)
    soft, bits, stats, _ = fsk_demod_stream(cfg, jnp.asarray(iq)[None],
                                            probe=True)
    nb = stats["ebno_db"].shape[1]
    assert stats["sf"].shape == (1, nb, cfg.ndft)
    assert stats["timing"].shape == (1, nb)
    assert stats["tmag"].shape == (1, nb, 2, cfg.nsym)
    # sf should show two tone humps at +-2500 Hz after a few blocks
    sf = np.asarray(stats["sf"])[0, -1]
    bins = (np.argsort(sf)[-8:] - cfg.ndft // 2) * cfg.fs / cfg.ndft
    assert any(abs(b + 2500) < 800 for b in bins)
    assert any(abs(b - 2500) < 800 for b in bins)
    # registry ingestion
    probe.enable(True)
    try:
        probe.reset()
        probe.capture_demod_internals(stats)
        assert "fsk_sf" in probe.names()
    finally:
        probe.enable(False)
        probe.reset()
