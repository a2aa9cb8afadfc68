"""Buffered (gather-free) demod scan variant: equivalence + drift."""

import numpy as np
import jax.numpy as jnp

from radiosonde_auto_rx_jax.demod.fsk import (FSKConfig, fsk_init_state,
                                              fsk_num_blocks,
                                              fsk_num_blocks_buffered,
                                              _fsk_demod_scan,
                                              _fsk_demod_scan_buffered)
from radiosonde_auto_rx_jax.demod.modulate import add_awgn, gfsk_mod


def _cfg(nsym=50):
    return FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=nsym,
                     est_min=-5000, est_max=5000, tone_spacing=5000,
                     freq_est_type=1)


def _sig(rng, c, t, ppm=0.0):
    fs_eff = 48000 * (1 + ppm * 1e-6)
    out = []
    tx = []
    for ci in range(c):
        bits = rng.integers(0, 2, int(t / 10) + 2)
        iq = add_awgn(gfsk_mod(bits, 48000, 4800, 2, 0.0, 5000),
                      14.0, 48000, 4800, rng=rng)
        out.append(np.stack([iq.real, iq.imag])[:, :t])
        tx.append(bits)
    return np.stack(out).astype(np.float32), tx


def test_buffered_matches_plain(rng):
    """While drift stays inside the slack, the buffered scan is
    bit-identical to the plain scan on the slack//2-shifted stream."""
    cfg = _cfg()
    slack_ts = 8
    half = cfg.ts // 2
    shift = (slack_ts * cfg.ts // half // 2) * half   # grid-snapped off0
    C, T = 4, 48000
    x, _ = _sig(rng, C, T + shift)
    xb = jnp.asarray(x)
    xp = jnp.asarray(x[:, :, shift:])
    nb = min(fsk_num_blocks(cfg, T),
             fsk_num_blocks_buffered(cfg, T + shift, slack_ts))
    s0 = fsk_init_state(cfg, C)
    _, outs_p = _fsk_demod_scan(cfg, xp, s0, nb)
    _, outs_b = _fsk_demod_scan_buffered(cfg, xb, s0, nb,
                                         slack_ts=slack_ts)
    np.testing.assert_array_equal(np.asarray(outs_b["bits"]),
                                  np.asarray(outs_p["bits"]))
    np.testing.assert_allclose(np.asarray(outs_b["soft"]),
                               np.asarray(outs_p["soft"]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(outs_b["f_est"]),
                               np.asarray(outs_p["f_est"]))


def test_buffered_decodes_clean_ber(rng):
    cfg = _cfg()
    C, T = 2, 96000
    x, tx = _sig(rng, C, T)
    nb = fsk_num_blocks_buffered(cfg, T)
    s0 = fsk_init_state(cfg, C)
    _, outs = _fsk_demod_scan_buffered(cfg, jnp.asarray(x), s0, nb)
    bits = np.asarray(outs["bits"]).transpose(1, 0, 2).reshape(C, -1)
    for ci in range(C):
        best = 1.0
        for off in range(120):
            n = min(bits.shape[1], len(tx[ci]) - off)
            if n > 1000:
                best = min(best, float(
                    np.mean(bits[ci, :n] != tx[ci][off:off + n])))
        assert best < 0.01, f"ch{ci} BER {best}"


def test_buffered_drift_beyond_slack_relocks(rng):
    """Adversarial clock drift: a sample-rate offset large enough to walk
    the off pointer past the ±slack/2 clamp must DEGRADE GRACEFULLY —
    the clamp causes a re-lock glitch, after which the BER recovers
    (this is the promotion gate for making the buffered scan the
    default: no silent corruption beyond the slack budget)."""
    cfg = _cfg()
    # ~2000 ppm clock offset: drift = 2e-3 * 48000 ≈ 96 samples/s;
    # slack/2 = 40 samples is exhausted in <0.5 s of the 4 s stream.
    # Generate at nominal 4800 Bd, then resample the waveform to model
    # the sonde clock running fast.
    ppm = 2000.0
    T = 4 * 48000
    bits = rng.integers(0, 2, T // 10 + 200)
    iq0 = add_awgn(gfsk_mod(bits, 48000, 4800, 2, 0.0, 5000),
                   16.0, 48000, 4800, rng=rng)
    tt = np.arange(T) * (1 + ppm * 1e-6)
    iq = (np.interp(tt, np.arange(len(iq0)), iq0.real)
          + 1j * np.interp(tt, np.arange(len(iq0)), iq0.imag))
    x = np.stack([iq.real, iq.imag])[None].astype(np.float32)

    nb = fsk_num_blocks_buffered(cfg, T)
    s0 = fsk_init_state(cfg, 1)
    _, outs = _fsk_demod_scan_buffered(cfg, jnp.asarray(x), s0, nb)
    got = np.asarray(outs["bits"]).transpose(1, 0, 2).reshape(1, -1)[0]

    # per-block BER against the tx bits: find each block's best local
    # alignment; early blocks must be clean, post-clamp blocks must
    # RECOVER to clean within a few blocks of the glitch
    nsym = cfg.nsym
    bers = []
    for b in range(nb):
        run = got[b * nsym:(b + 1) * nsym]
        best = 1.0
        center = int(b * nsym * (1 + ppm * 1e-6))
        for off in range(max(0, center - 60), center + 60):
            seg = bits[off:off + nsym]
            if len(seg) == nsym:
                best = min(best, float(np.mean(run != seg)))
        bers.append(best)
    bers = np.array(bers)
    assert bers[1] < 0.02, f"early block BER {bers[1]:.3f}"
    # after the clamp point the demod must get back to a clean lock
    assert bers[-2:].max() < 0.1, \
        f"no re-lock after slack exhaustion: tail BERs {bers[-4:]}"


def test_wrap_frame_loss_rate_under_sustained_ppm():
    """Sustained moderate clock offset: slack wraps must be RARE (the
    wrap jumps back to the buffer center — ~slack/2 symbols — so a
    75 ppm offset over a 100 s stream costs only a few wrap events, not
    one per symbol of drift).  Counted end-to-end: RS41 frames through
    demod + decode at high SNR, ≥95% delivered."""
    import dataclasses
    from radiosonde_auto_rx_jax.tools import per_harness as ph
    from radiosonde_auto_rx_jax.demod import fsk_demod_stream
    rng = np.random.default_rng(7)
    case = ph.CASES["RS41"](60, rng, None)
    casep = dataclasses.replace(case, ppm=75.0)
    iq = ph._make_iq(casep, 30.0, np.random.default_rng(8))
    soft, bits, _, _ = fsk_demod_stream(case.cfg, iq)
    telems = case.decode(np.asarray(bits), np.asarray(soft))
    rx = {t.get("frame") for t in telems} & case.tx_ids
    assert len(rx) >= 57, f"{len(rx)}/60 frames under 75 ppm"


def test_slack_wrap_stays_on_offset_grid():
    """The slack wrap must be a multiple of half_ts for EVERY ts — an
    off-grid wrap leaves the buffered scan's masked window select
    matching nothing, silently demodulating zeros (round-4 review:
    2*ts is off-grid whenever ts is odd and ts//2 > 2)."""
    from radiosonde_auto_rx_jax.demod.fsk import _slack_wrap
    for ts in range(2, 64):
        half = max(1, ts // 2)
        off_max = (8 * ts // half) * half
        w = _slack_wrap(ts, half, off_max)
        assert w % half == 0, (ts, half, w)
        assert 0 < w <= off_max, (ts, half, w, off_max)
        if ts % 2 == 0:
            assert w % ts == 0                 # whole-symbol slip kept
