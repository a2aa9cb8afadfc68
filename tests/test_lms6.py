"""LMS6 codec tests: conv/Viterbi, RS(255,223) block, frame round-trip,
and JSON parity vs the reference lms6Xmod binary."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.ecc.viterbi import conv_encode, viterbi_decode
from radiosonde_auto_rx_jax.models.lms6 import (
    BLK_SYNCBITS, LMS6Decoder, RAW_HEADER, blocks_to_raw_bits, crc16_0,
    encode_block, encode_frame)
from tests import oracle


def test_viterbi_roundtrip(rng):
    bits = rng.integers(0, 2, 1000).astype(np.uint8)
    raw = conv_encode(bits)
    soft = raw.astype(np.float64) * 2 - 1 + rng.normal(0, 0.5, 2 * len(bits))
    dec = viterbi_decode(soft)
    assert np.array_equal(dec, bits)


def test_crc16():
    assert crc16_0(b"123456789") == 0x31C3  # CRC-16/XMODEM check value


def test_block_roundtrip():
    frame = encode_frame(sn=712345, frnr=1234, lat=44.5, lon=-72.6,
                         alt=16000.0)
    raw = blocks_to_raw_bits([encode_block(frame)])
    telems = LMS6Decoder().decode_bits(raw)
    assert telems, "no telemetry decoded"
    t = telems[0]
    assert t["type"] == "LMS"
    assert t["id"] == "LMS6-712345"
    assert t["frame"] == 1234
    assert abs(t["lat"] - 44.5) < 1e-5
    assert abs(t["lon"] + 72.6) < 1e-5
    assert abs(t["alt"] - 16000.0) < 0.01
    assert t["subtype"] == "LMS6-403"


def test_noisy_viterbi_rs(rng):
    frame = encode_frame()
    raw = blocks_to_raw_bits([encode_block(frame)])
    soft = raw.astype(np.float64) * 2 - 1 + rng.normal(0, 0.6, len(raw))
    telems = LMS6Decoder().decode_bits((soft >= 0).astype(np.uint8),
                                       soft.astype(np.float32))
    assert telems, "no telemetry decoded from noisy stream"


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference():
    binp = oracle.binary("lms6Xmod")
    if binp is None:
        pytest.skip("could not build lms6Xmod")
    frames = [encode_frame(sn=712345, frnr=1234 + i, tow_ms=210600500
                           + i * 1000, lat=44.5, lon=-72.6, alt=16000.0)
              for i in range(3)]
    raw = blocks_to_raw_bits([encode_block(f) for f in frames])
    lead = np.zeros(300, dtype=np.uint8)
    stream = np.concatenate([lead, raw, lead])
    soft = stream.astype(np.float32) * 2 - 1
    ref = oracle.run_json(f"{binp} --json --ecc --vit2 --softin",
                          soft.tobytes())
    ours = LMS6Decoder().decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    refmap = {t["frame"]: t for t in ref}
    ourmap = {t["frame"]: t for t in ours}
    common = set(refmap) & set(ourmap)
    assert common, f"no common frames: ref={list(refmap)} ours={list(ourmap)}"
    for fr in common:
        r, o = refmap[fr], ourmap[fr]
        for k in ("id", "lat", "lon", "alt", "vel_h", "vel_v", "heading",
                  "datetime", "gpstow", "subtype"):
            if k in r:
                assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
