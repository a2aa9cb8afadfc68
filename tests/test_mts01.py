"""MTS01 codec tests: CRC, CSV parsing round-trip, parity vs mts01mod."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models.mts01 import (
    MTS01Decoder, crc16_re, encode_frame, frame_to_bits)
from tests import oracle


def test_roundtrip():
    frame = encode_frame(sid="T1234567", frnr=321, lat=46.2044, lon=6.1432,
                         alt=2345.0)
    telems = MTS01Decoder().decode_bits(frame_to_bits(frame))
    assert telems, "no telemetry decoded"
    t = telems[0]
    assert t["type"] == "MTS01"
    assert t["id"] == "MTS01-T1234567"
    assert t["frame"] == 321
    assert t["datetime"] == "2023-05-17T10:45:30.000Z"
    assert abs(t["lat"] - 46.2044) < 1e-5
    assert abs(t["lon"] - 6.1432) < 1e-5
    assert abs(t["alt"] - 2345.0) < 0.01
    assert t["batt"] == 2.9
    assert "temp" in t


def test_bad_crc_rejected():
    frame = encode_frame()
    frame[20] ^= 0xFF
    assert MTS01Decoder().decode_bits(frame_to_bits(frame)) == []


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference():
    binp = oracle.binary("mts01mod")
    if binp is None:
        pytest.skip("could not build mts01mod")
    frame = encode_frame()
    bits = frame_to_bits(frame)
    lead = np.zeros(100, dtype=np.uint8)
    stream = np.concatenate([lead, bits, lead])
    soft = stream.astype(np.float32) * 2 - 1
    ref = oracle.run_json(f"{binp} --json --softin", soft.tobytes())
    ours = MTS01Decoder().decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[0], ours[0]
    for k in ("id", "lat", "lon", "alt", "vel_h", "heading", "frame",
              "datetime", "batt"):
        if k in r:
            assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
    if "temp" in r:
        assert abs(o.get("temp", -9999) - r["temp"]) < 0.11
