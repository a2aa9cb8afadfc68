"""Weathex codec tests: checksum, bitfield packing, PN9, parity vs
weathex301d."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models.weathex import (
    WeathexDecoder, WeathexPN9Decoder, encode_frame, frame_to_bits, xor8sum)
from tests import oracle


def _stream(pn9=False, sn=30112233, cnt=777, **kw):
    f1 = encode_frame(1, sn=sn, cnt=cnt, pn9=pn9)
    f2 = encode_frame(2, sn=sn, cnt=cnt, pn9=pn9, **kw)
    gap = np.zeros(30, dtype=np.uint8)
    return np.concatenate([frame_to_bits(f1), gap, frame_to_bits(f2), gap])


def test_roundtrip():
    bits = _stream(lat=3.15, lon=101.7, alt=12345.6)
    telems = WeathexDecoder().decode_bits(bits)
    assert telems, "no telemetry decoded"
    t = telems[0]
    assert t["type"] == "WXR301"
    assert t["id"] == "WXR-30112233"
    assert t["frame"] == 777
    assert t["datetime"] == "10:20:30Z"
    assert abs(t["lat"] - 3.15) < 2e-5
    assert abs(t["lon"] - 101.7) < 2e-5
    assert abs(t["alt"] - 12345.6) < 0.1


def test_pn9_roundtrip():
    bits = _stream(pn9=True)
    telems = WeathexPN9Decoder().decode_bits(bits)
    assert telems and telems[0]["subtype"] == "WXR_PN9"


def test_checksum_rejects():
    f2 = encode_frame(2)
    f2[20] ^= 0xFF
    d = WeathexDecoder()
    d.sub1 = (30112233, 777, True)
    bits = frame_to_bits(f2)
    assert d.decode_bits(bits) == []


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
@pytest.mark.parametrize("pn9", [False, True])
def test_parity_vs_reference(pn9):
    binp = oracle.binary("weathex301d")
    if binp is None:
        pytest.skip("could not build weathex301d")
    bits = _stream(pn9=pn9, lat=3.15, lon=101.7, alt=12345.6)
    lead = np.zeros(100, dtype=np.uint8)
    stream = np.concatenate([lead, bits, lead])
    soft = stream.astype(np.float32) * 2 - 1
    flag = "--pn9 " if pn9 else ""
    ref = oracle.run_json(f"{binp} --json {flag}--softin", soft.tobytes())
    dec = WeathexPN9Decoder() if pn9 else WeathexDecoder()
    ours = dec.decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[0], ours[0]
    for k in ("id", "lat", "lon", "alt", "frame", "datetime", "type"):
        if k in r:
            assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
