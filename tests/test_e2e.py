"""End-to-end tests: synthetic IQ -> FSK demod -> frame decoder -> telemetry.

Mirrors the reference's signal-level regression harness
(reference auto_rx/test/test_demod.py) with synthetic GFSK in place of the
recorded-capture corpus; demod chain parameters follow the per-type table
in reference auto_rx/autorx/decode.py:846-1476.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.demod import FSKConfig, fsk_demod_stream
from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn


def _run_chain(tx_bits, fs, rs, cfg, ebno_db=14.0, spacing=5000):
    idle = np.tile(np.array([1, 0], np.uint8), 200)
    tx = np.concatenate([idle, tx_bits, idle])
    iq = add_awgn(gfsk_mod(tx, fs, rs, 2, 0.0, spacing), ebno_db, fs, rs)
    soft, bits, stats, _ = fsk_demod_stream(cfg, jnp.asarray(iq))
    return np.asarray(bits), np.asarray(soft)


def test_iq_to_dfm_telemetry():
    """DFM: 50 kHz IQ at 2500 Bd raw Manchester (decode.py:1036-1073)."""
    from radiosonde_auto_rx_jax.models.dfm import DFMDecoder, \
        encode_flight_bits
    raw = encode_flight_bits(sn=21012345, lat=51.3, lon=6.88)
    cfg = FSKConfig(fs=50000, rs=2500, m=2, p=10, nsym=125,
                    est_min=-5000, est_max=5000)
    bits, soft = _run_chain(raw, 50000, 2500, cfg)
    # fsk_demod soft: + => bit 0; dfm09mod --softin wants + => 1 (the -i flag)
    telems = DFMDecoder().decode_bits(bits, -soft)
    assert telems and telems[-1]["id"] == "DFM-21012345"
    assert abs(telems[-1]["lat"] - 51.3) < 1e-5


def test_iq_to_rs41_telemetry():
    """RS41: 48 kHz IQ at 4800 Bd (decode.py:869-913)."""
    from radiosonde_auto_rx_jax.models.rs41 import (
        RS41Decoder, encode_frame, frame_to_bits, make_calibytes)
    cal = make_calibytes()
    frames = [encode_frame(frame_nb=100 + i, sonde_id="S1234567",
                           week=2150, tow_ms=(86400 * 2 + 3600) * 1000
                           + i * 1000, lat=47.5, lon=15.2, alt=23456.0,
                           calibytes=cal, calfr=i % 51)
              for i in range(3)]
    tx_bits = np.concatenate([frame_to_bits(f) for f in frames])
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    bits, soft = _run_chain(tx_bits, 48000, 4800, cfg)
    telems = RS41Decoder().decode_bits(bits)
    assert telems, "no RS41 telemetry"
    t = telems[-1]
    assert t["id"] == "S1234567"
    assert abs(t["lat"] - 47.5) < 1e-4


def test_iq_to_lms6_telemetry():
    """LMS6: 48 kHz IQ at 4800 Bd raw (decode.py:1173-1208); conv->
    Viterbi -> RS -> frame.  First block is demod warm-up."""
    from radiosonde_auto_rx_jax.models.lms6 import (
        LMS6Decoder, blocks_to_raw_bits, encode_block, encode_frame)
    frames = [encode_frame(frnr=100 + i, tow_ms=210600500 + i * 1000,
                           fill_seed=i) for i in range(3)]
    raw = blocks_to_raw_bits([encode_block(f) for f in frames])
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-10000, est_max=10000)
    bits, soft = _run_chain(raw, 48000, 4800, cfg, spacing=4800)
    telems = LMS6Decoder().decode_bits(bits, -soft)
    assert len(telems) >= 2, f"only {len(telems)} LMS6 frames decoded"
    assert telems[-1]["id"] == "LMS6-7123456"


def test_iq_to_m10_telemetry():
    """M10: 48.08 kHz IQ at 9616 Bd raw pairs (decode.py:1089-1130)."""
    from radiosonde_auto_rx_jax.models.m10 import (
        M10Decoder, encode_frame_m10, frame_to_raw_bits)
    frame = encode_frame_m10(lat=48.2, lon=16.4, alt=12345.6)
    raw = np.concatenate([frame_to_raw_bits(frame),
                          np.zeros(40, np.uint8),
                          frame_to_raw_bits(frame)])
    cfg = FSKConfig(fs=48080, rs=9616, m=2, p=5, nsym=240,
                    est_min=-10000, est_max=10000)
    bits, soft = _run_chain(raw, 48080, 9616, cfg, ebno_db=16.0,
                            spacing=10000)
    telems = M10Decoder().decode_bits(bits, -soft)
    assert telems, "no M10 telemetry"
    assert abs(telems[-1]["lat"] - 48.2) < 1e-4


def test_iq_to_rs92_telemetry():
    """RS92: 48 kHz IQ at 4800 Bd raw Manchester (decode.py RS92 FM chain);
    raw-pseudorange GPS navigation against a synthetic constellation."""
    from radiosonde_auto_rx_jax.models.rs92 import (
        RS92Decoder, encode_flight_bits, make_test_ephemeris)
    ephs = make_test_ephemeris()
    raw = encode_flight_bits(n_frames=2, ephs=ephs, lat=-34.95, lon=138.52,
                             alt=12000.0)
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000, tone_spacing=4800,
                    freq_est_type=1)
    bits, soft = _run_chain(raw, 48000, 4800, cfg, spacing=4800)
    telems = RS92Decoder(ephemeris=ephs).decode_bits(bits)
    assert telems, "no RS92 telemetry"
    t = telems[-1]
    assert t["id"] == "R1234567"
    assert abs(t["lat"] + 34.95) < 5e-4
    assert abs(t["lon"] - 138.52) < 5e-4
