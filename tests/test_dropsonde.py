"""RD94/RD41 dropsonde codec tests + parity vs rd94rd41drop."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models.dropsonde import (
    DropsondeDecoder, chksum16, crc16, encode_frame_rd94, f32_rd94,
    f32_rd94_encode, frames_to_raw_bits)
from tests import oracle


def test_f32_rd94_roundtrip():
    frame = np.zeros(10, dtype=np.uint8)
    for v in (-48.2, 0.5, 320.75, 1013.25):
        frame[0:4] = f32_rd94_encode(v)
        assert abs(f32_rd94(frame, 0) - v) < abs(v) * 1e-6 + 1e-6


def test_chksum16():
    assert chksum16(b"abcde") == chksum16(b"abcde")
    assert chksum16(b"abcde") != chksum16(b"abcdf")


def test_rd94_roundtrip():
    frame = encode_frame_rd94(lat=13.5, lon=121.0, alt=9000.0)
    raw = frames_to_raw_bits([frame])
    telems = DropsondeDecoder().decode_bits(raw)
    assert telems, "no telemetry decoded"
    t = telems[0]
    assert t["type"] == "RD94"
    assert t["frame"] == 321
    assert abs(t["lat"] - 13.5) < 2e-5
    assert abs(t["lon"] - 121.0) < 2e-5
    assert abs(t["alt"] - 9000.0) < 0.5
    assert t["sats"] == 9
    assert abs(t["temp"] + 48.2) < 0.11
    assert abs(t["pressure"] - 320.5) < 0.01


def test_bad_checksum_rejected():
    frame = encode_frame_rd94()
    frame[30] ^= 0xFF
    raw = frames_to_raw_bits([frame])
    assert DropsondeDecoder().decode_bits(raw) == []


def _wav_from_bits(path, bits, sps=5, fs=48000):
    """NRZ square-wave FM-audio WAV (16-bit mono) from raw bits."""
    import struct
    samples = (np.repeat(bits.astype(np.int16) * 2 - 1, sps)
               * 12000).astype("<i2")
    data = samples.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, fs, fs * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    path.write_bytes(hdr + data)


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference(tmp_path):
    binp = oracle.binary("rd94rd41drop")
    if binp is None:
        pytest.skip("could not build rd94rd41drop")
    frames = [encode_frame_rd94(frnr=321 + i) for i in range(3)]
    raw = frames_to_raw_bits(frames)
    lead = np.tile(np.array([1, 0], np.uint8), 100)
    stream = np.concatenate([lead, raw, lead])
    soft = stream.astype(np.float32) * 2 - 1
    ref = oracle.run_json(f"{binp} --json --softin", soft.tobytes())
    ours = DropsondeDecoder().decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    refmap = {t["frame"]: t for t in ref}
    ourmap = {t["frame"]: t for t in ours}
    common = set(refmap) & set(ourmap)
    assert common
    for fr in common:
        r, o = refmap[fr], ourmap[fr]
        for k in ("id", "lat", "lon", "alt", "vel_h", "vel_v", "heading",
                  "sats", "datetime", "type"):
            if k in r:
                assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
        for k in ("temp", "humidity", "pressure"):
            if k in r:
                assert abs(o.get(k, -9999) - r[k]) < 0.11
