"""M10/M20 codec tests: checksum, differential framing, round-trips, and
JSON parity vs the reference m10mod/m20mod binaries."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models.m10 import (
    M10Decoder, M20Decoder, RAW_HEADER, bits_to_bytes_be, bytes_to_bits_be,
    check_m10, diff_decode, diff_encode, encode_frame_m10, encode_frame_m20,
    frame_to_raw_bits, gps2date, pairs_to_bits)
from tests import oracle


def test_diff_roundtrip(rng):
    data = rng.integers(0, 2, 500).astype(np.uint8)
    b = diff_encode(data, b0=0)
    assert np.array_equal(diff_decode(b, b0=0), data)


def test_diff_polarity_invariant(rng):
    data = rng.integers(0, 2, 500).astype(np.uint8)
    b = diff_encode(data, b0=0)
    # inverting all b-bits except b[-1]-reference leaves data nearly intact
    d2 = diff_decode(b ^ 1, b0=1)
    assert np.array_equal(d2, data)


def test_bytes_bits_roundtrip(rng):
    by = rng.integers(0, 256, 64).astype(np.uint8)
    assert np.array_equal(bits_to_bytes_be(bytes_to_bits_be(by)), by)


def test_gps2date():
    # 2019-04-30 is GPS week 2051 day 2
    assert gps2date(2051, 2 * 86400) == (2019, 4, 30)
    assert gps2date(2050, 4 * 86400 + 3600) == (2019, 4, 25)


def test_m10_roundtrip():
    frame = encode_frame_m10(week=2050, tow_ms=388815000, lat=48.2,
                             lon=16.4, alt=12345.6)
    raw = frame_to_raw_bits(frame)
    telems = M10Decoder().decode_bits(raw)
    assert telems, "no telemetry decoded"
    t = telems[0]
    assert t["type"] == "M10"
    assert abs(t["lat"] - 48.2) < 1e-5
    assert abs(t["lon"] - 16.4) < 1e-5
    assert abs(t["alt"] - 12345.6) < 0.001
    assert t["sats"] == 9
    assert t["subtype"] == "0x9F"
    assert "temp" in t and "humidity" in t and "batt" in t


def test_m10_bad_checksum_rejected():
    frame = encode_frame_m10()
    frame[0x10] ^= 0xFF
    raw = frame_to_raw_bits(frame)
    assert M10Decoder().decode_bits(raw) == []


def test_m20_roundtrip():
    frame = encode_frame_m20(week=2150, gpssec=388815, lat=52.1, lon=13.3,
                             alt=8000.25)
    raw = frame_to_raw_bits(frame)
    telems = M20Decoder().decode_bits(raw)
    assert telems, "no telemetry decoded"
    t = telems[0]
    assert t["type"] == "M20"
    assert abs(t["lat"] - 52.1) < 1e-5
    assert abs(t["lon"] - 13.3) < 1e-5
    assert abs(t["alt"] - 8000.25) < 0.001
    assert t["subtype"] == "0x20"
    assert "pressure" in t


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
@pytest.mark.parametrize("which", ["m10", "m20"])
def test_parity_vs_reference(which):
    binp = oracle.binary(f"{which}mod")
    if binp is None:
        pytest.skip(f"could not build {which}mod")
    if which == "m10":
        frame = encode_frame_m10()
        ours = M10Decoder().decode_bits(frame_to_raw_bits(frame))
        flags = "--json --ptu -vvv --softin"
    else:
        frame = encode_frame_m20()
        ours = M20Decoder().decode_bits(frame_to_raw_bits(frame))
        flags = "--json --ptu -vvv --softin"
    raw = frame_to_raw_bits(frame, pad_bytes=30)
    lead = np.zeros(100, dtype=np.uint8)
    stream = np.concatenate([lead, raw, lead])
    soft = stream.astype(np.float32) * 2 - 1
    ref = oracle.run_json(f"{binp} {flags}", soft.tobytes())
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[0], ours[0]
    for k in ("id", "lat", "lon", "alt", "vel_h", "vel_v", "heading",
              "frame", "datetime", "subtype", "rawid", "batt"):
        if k in r:
            assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
    for k in ("temp", "humidity", "pressure"):
        if k in r:
            assert abs(o.get(k, -9999) - r[k]) < 0.11, \
                f"mismatch {k}: ours={o.get(k)} ref={r[k]}"
