"""iMet-54 codec tests: 8N1/interleave/Hamming plumbing, CRC, round-trip,
and JSON parity vs the reference imet54mod binary."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models.imet54 import (
    HAM_LUT, HEADER, IMet54Decoder, crc32ok, crc32_fix, de8n1, deinter64,
    en8n1, encode_frame, encode_raw_bits, hamming_decode_byte)
from tests import oracle


def test_8n1_roundtrip(rng):
    bits = rng.integers(0, 2, 8 * 30).astype(np.uint8)
    assert np.array_equal(de8n1(en8n1(bits)), bits)


def test_deinter64_self_inverse(rng):
    bits = rng.integers(0, 2, 64 * 5).astype(np.uint8)
    assert np.array_equal(deinter64(deinter64(bits)), bits)


def test_hamming_lut_roundtrip(rng):
    for nib in range(16):
        cw = HAM_LUT[nib]
        cwb = ((cw >> np.arange(8)) & 1).astype(np.uint8)
        n, err = hamming_decode_byte(cwb)
        assert (n, err) == (nib, 0)
        # single-bit error correction
        for j in range(8):
            bad = cwb.copy()
            bad[j] ^= 1
            n, err = hamming_decode_byte(bad)
            assert n == nib and err == 1


def test_crc_fix():
    frame = encode_frame()
    assert crc32ok(frame)
    bad = frame.copy()
    bad[10] ^= 1
    assert not crc32ok(bad)


def test_roundtrip():
    frame = encode_frame(sn=54001234, hh=12, mm=30, ss=15.0,
                         lat=51.5, lon=7.25, alt=12000.5, T=-35.2)
    raw = encode_raw_bits(frame)
    telems = IMet54Decoder().decode_bits(raw)
    assert telems, "no telemetry decoded"
    t = telems[0]
    assert t["type"] == "IMET5"
    assert t["id"] == "IMET5-54001234"
    assert t["datetime"] == "12:30:15.000Z"
    assert abs(t["lat"] - 51.5) < 2e-5
    assert abs(t["lon"] - 7.25) < 2e-5
    assert abs(t["alt"] - 12000.5) < 0.11
    assert t["subtype"] == "iMet-54"
    assert abs(t["temp"] + 35.2) < 0.11
    assert "humidity" in t


def test_single_bit_errors_corrected(rng):
    frame = encode_frame()
    raw = encode_raw_bits(frame)
    # flip a few payload bits (not in header, not start/stop): Hamming absorbs
    for _ in range(3):
        idx = 40 + 10 * rng.integers(4, 100) + rng.integers(1, 9)
        raw[idx] ^= 1
    telems = IMet54Decoder().decode_bits(raw)
    assert telems and telems[0]["id"] == "IMET5-54001234"


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference():
    binp = oracle.binary("imet54mod")
    if binp is None:
        pytest.skip("could not build imet54mod")
    frame = encode_frame(sn=54001234, lat=51.5, lon=7.25, alt=12000.5)
    raw = encode_raw_bits(frame)
    lead = np.zeros(200, dtype=np.uint8)
    stream = np.concatenate([lead, raw, np.ones(400, dtype=np.uint8)])
    soft = stream.astype(np.float32) * 2 - 1
    ref = oracle.run_json(f"{binp} --json --ecc --ptu --softin",
                          soft.tobytes())
    ours = IMet54Decoder().decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[0], ours[0]
    for k in ("id", "lat", "lon", "alt", "frame", "datetime", "subtype"):
        assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
    for k in ("temp", "humidity"):
        if k in r:
            assert abs(o.get(k, -9999) - r[k]) < 0.11
