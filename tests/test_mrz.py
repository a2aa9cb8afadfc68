"""MRZ codec tests: CRC16, frame round-trip, JSON parity vs mp3h1mod."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models.mrz import (
    MRZDecoder, crc16_rev, encode_flight_bits, encode_frame,
    frame_to_raw_bits)
from tests import oracle


def test_crc16_rev():
    # standard CRC16/MODBUS test vector: "123456789" -> 0x4B37
    assert crc16_rev(b"123456789") == 0x4B37


def test_flight_roundtrip():
    raw = encode_flight_bits(snC=30112, snD=21055, lat=55.75, lon=37.62,
                             alt=15000.0)
    telems = MRZDecoder().decode_bits(raw)
    assert telems, "no telemetry decoded"
    t = telems[-1]
    assert t["type"] == "MRZ"
    assert t["id"] == "MRZ-30112-21055"
    assert abs(t["lat"] - 55.75) < 2e-5
    assert abs(t["lon"] - 37.62) < 2e-5
    assert abs(t["alt"] - 15000.0) < 0.5
    assert t["datetime"].startswith("2021-06-15T12:30:")
    assert abs(t["temp"] + 20.5) < 0.01
    assert abs(t["humidity"] - 55.0) < 0.01
    assert t["sats"] == 9


def test_bad_crc_rejected():
    f = encode_frame(0xC, 12, 0, 0, 55.0, 37.0, 1000.0, cfg32=1234)
    f[10] ^= 0xFF
    raw = frame_to_raw_bits(f)
    dec = MRZDecoder()
    assert dec.decode_bits(raw) == []
    assert dec.snC == 0  # cfg not accepted from bad frame


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference():
    binp = oracle.binary("mp3h1mod")
    if binp is None:
        pytest.skip("could not build mp3h1mod")
    raw = encode_flight_bits(snC=30112, snD=21055, lat=55.75, lon=37.62,
                             alt=15000.0)
    lead = np.zeros(100, dtype=np.uint8)
    stream = np.concatenate([lead, raw, lead])
    soft = stream.astype(np.float32) * 2 - 1
    ref = oracle.run_json(f"{binp} --json --ptu --softin", soft.tobytes())
    ours = MRZDecoder().decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[-1], ours[-1]
    for k in ("id", "lat", "lon", "alt", "vel_h", "vel_v", "heading",
              "sats", "frame", "datetime"):
        if k in r:
            assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
    for k in ("temp", "humidity"):
        if k in r:
            assert abs(o.get(k, -9999) - r[k]) < 0.11


def test_soft_combining_beats_second_bit():
    """Dual-symbol Manchester1 soft integration (mp3h1mod.c:1208)."""
    rng = np.random.default_rng(9)
    raw = encode_flight_bits(snC=30112, snD=21055, lat=55.75, lon=37.62,
                             alt=15000.0)
    soft = raw.astype(np.float32) * 2.0 - 1.0
    idx = np.flatnonzero(np.arange(len(raw)) % 2 == 1)
    idx = idx[idx > 100]
    bad = rng.choice(idx, size=int(0.06 * len(idx)), replace=False)
    soft[bad] = -0.2 * (raw[bad] * 2.0 - 1.0)
    hard = (soft >= 0).astype(np.uint8)
    assert MRZDecoder().decode_bits(hard) == []
    telems = MRZDecoder().decode_bits(hard, soft)
    assert telems and telems[-1]["id"] == "MRZ-30112-21055"
