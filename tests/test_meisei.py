"""Meisei codec tests: BCH block plumbing, biphase-S, iMS-100 round-trip,
and JSON parity vs the reference meisei100mod binary."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.ecc.bch import bch_decode, bch_encode, N, K
from radiosonde_auto_rx_jax.models.meisei import (
    HEADER_049DCE, MeiseiDecoder, RAW_HEADER, biphase_s_decode,
    biphase_s_encode, block_decode, block_encode, encode_subframes_ims100,
    frames_to_raw_bits, get_w16)
from tests import oracle


def test_bch_roundtrip(rng):
    data = rng.integers(0, 2, K).astype(np.uint8)
    cw = bch_encode(data)
    dec, ne = bch_decode(cw)
    assert ne == 0 and np.array_equal(dec, cw)
    for nerr in (1, 2):
        bad = cw.copy()
        bad[rng.choice(N, nerr, replace=False)] ^= 1
        dec, ne = bch_decode(bad)
        assert ne == nerr and np.array_equal(dec, cw)


def test_block_roundtrip(rng):
    w0, w1 = 0x1234, 0xBEEF
    blk = block_encode(w0, w1)
    dec, errors = block_decode(blk)
    assert errors == 0
    sub = np.concatenate([np.zeros(24, np.uint8), dec])
    assert get_w16(sub, 0) == w0
    assert get_w16(sub, 1) == w1
    # correct up to 2 bit errors
    bad = blk.copy()
    bad[[3, 17]] ^= 1
    dec, errors = block_decode(bad)
    assert errors == 2 and np.array_equal(dec, blk)


def test_biphase_s(rng):
    bits = rng.integers(0, 2, 100).astype(np.uint8)
    raw = biphase_s_encode(bits, level0=0)
    assert np.array_equal(biphase_s_decode(raw), bits)
    # polarity invariant
    assert np.array_equal(biphase_s_decode(raw ^ 1), bits)


def test_ims100_roundtrip():
    frames = [encode_subframes_ims100(c, sn=2304123.0, lat=36.1,
                                      lon=140.08, alt=12000.0)
              for c in (16, 17)]
    raw = frames_to_raw_bits(frames)
    dec = MeiseiDecoder(ref_year=2023)
    telems = dec.decode_bits(raw)
    assert telems, "no telemetry decoded"
    t = telems[0]
    assert t["type"] == "MEISEI"
    assert t["subtype"] == "IMS100"
    assert t["id"] == "IMS100-2304123"
    assert abs(t["lat"] - 36.1) < 2e-5
    assert abs(t["lon"] - 140.08) < 2e-5
    assert abs(t["alt"] - 12000.0) < 0.01
    assert t["datetime"] == "2023-05-17T11:22:33.500Z"
    assert "vel_v" in t


def test_ims100_bit_errors(rng):
    frames = [encode_subframes_ims100(c) for c in (16, 17)]
    raw = frames_to_raw_bits(frames)
    # flip a few payload raw-bit PAIRS (biphase: one decoded-bit error each)
    for _ in range(3):
        j = rng.integers(60, len(raw) // 2 - 10)
        raw[2 * j] ^= 1
    telems = MeiseiDecoder(ref_year=2023).decode_bits(raw)
    assert telems, "no telemetry with correctable errors"


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference():
    binp = oracle.binary("meisei100mod")
    if binp is None:
        pytest.skip("could not build meisei100mod")
    frames = [encode_subframes_ims100(c, sn=2304123.0, lat=36.1,
                                      lon=140.08, alt=12000.0)
              for c in (16, 17, 18, 19)]
    raw = frames_to_raw_bits(frames)
    lead = np.zeros(150, dtype=np.uint8)
    stream = np.concatenate([lead, raw, lead])
    soft = stream.astype(np.float32) * 2 - 1
    ref = oracle.run_json(f"{binp} --json --ecc --ptu --softin",
                          soft.tobytes())
    ours = MeiseiDecoder().decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[0], ours[0]
    for k in ("id", "lat", "lon", "alt", "vel_h", "heading", "frame",
              "datetime", "subtype"):
        if k in r:
            assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
    if "vel_v" in r:
        assert o.get("vel_v") == r["vel_v"]
