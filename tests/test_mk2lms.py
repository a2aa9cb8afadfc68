"""MK2A / LMS6-1680 codec tests incl. JSON parity vs mk2a1680mod."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models.mk2lms import (
    MK2LMSDecoder, encode_flight_bits, encode_frame_54, encode_frame_4d,
    frame_to_raw_bits)
from tests import oracle

LAT, LON, ALT = 44.5, -72.6, 15000.0
VNEU = (5.0, 3.0, -4.0)
SID = 801234567


def test_flight_roundtrip():
    raw = encode_flight_bits(sid32=SID, n_frames=3, lat=LAT, lon=LON,
                             alt=ALT, vel_neu=VNEU)
    dec = MK2LMSDecoder()
    telems = dec.decode_bits(raw)
    assert len(telems) == 3
    t = telems[-1]
    assert t["type"] == "LMS"
    assert t["subtype"] == "MK2A"
    assert t["id"] == f"LMS6-{SID}"
    assert abs(t["lat"] - LAT) < 2e-7 * 360
    assert abs(t["lon"] - LON) < 2e-7 * 360
    assert abs(t["alt"] - ALT) < 1e-3
    assert abs(t["vel_h"] - np.hypot(*VNEU[:2])) < 0.01
    assert abs(t["vel_v"] - VNEU[2]) < 0.01
    assert t["datetime"] == "12:00:07.000Z"   # tow advances 1 s per frame


def test_id_required_before_json():
    f54 = encode_frame_54(sid32=SID, lat=LAT, lon=LON, alt=ALT)
    dec = MK2LMSDecoder()
    # telemetry frame without a preceding 0x4D full-ID frame: no JSON
    assert dec.decode_bits(frame_to_raw_bits(f54)) == []
    dec.decode_bits(frame_to_raw_bits(encode_frame_4d(sid32=SID)))
    assert dec.id == SID
    out = dec.decode_bits(frame_to_raw_bits(f54))
    assert out and out[0]["id"] == f"LMS6-{SID}"


def test_bad_crc_rejected():
    f = encode_frame_54(sid32=SID)
    f[10] ^= 0xFF
    dec = MK2LMSDecoder()
    dec.id = SID
    assert dec.decode_bits(frame_to_raw_bits(f)) == []


def test_duplicate_frame_suppressed():
    raw = frame_to_raw_bits(encode_frame_54(sid32=SID, frnr=7))
    dec = MK2LMSDecoder()
    dec.id = SID
    assert len(dec.decode_bits(np.concatenate([raw, raw]))) == 1


def test_inverted_stream():
    raw = encode_flight_bits(sid32=SID, n_frames=1, lat=LAT, lon=LON,
                             alt=ALT) ^ 1
    telems = MK2LMSDecoder().decode_bits(raw)
    assert telems and abs(telems[0]["lat"] - LAT) < 1e-4


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference():
    binp = oracle.binary("mk2a1680mod")
    if binp is None:
        pytest.skip("could not build mk2a1680mod")
    raw = encode_flight_bits(sid32=SID, n_frames=3, lat=LAT, lon=LON,
                             alt=ALT, vel_neu=VNEU)
    lead = np.tile(np.array([0, 1], np.uint8), 300)
    stream = np.concatenate([lead, raw, lead])
    # mk2a1680mod FM-audio mode: synthesize s16 wav at 96160 Hz so each
    # 9616 Bd bit is exactly 10 samples, lowpassed to ~12 kHz so the
    # header correlator (tuned for band-limited FM audio) locks.
    fs = 96160
    spb = fs // 9616
    audio = np.repeat(stream.astype(np.float32) * 2 - 1, spb)
    spec = np.fft.rfft(audio)
    spec[np.fft.rfftfreq(len(audio), 1 / fs) > 12000] = 0
    audio = np.fft.irfft(spec, len(audio))
    pcm = (audio * 12000).astype("<i2")
    import struct
    hdr = (b"RIFF" + struct.pack("<I", 36 + pcm.nbytes) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, fs, fs * 2, 2, 16)
           + b"data" + struct.pack("<I", pcm.nbytes))
    ref = oracle.run_json(f"{binp} --json --crc", hdr + pcm.tobytes())
    ours = MK2LMSDecoder().decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[-1], ours[-1]
    for k in ("id", "frame", "datetime", "lat", "lon", "alt",
              "vel_h", "vel_v", "heading", "subtype"):
        if k in r:
            if isinstance(r[k], float):
                assert abs(r[k] - o[k]) < 1e-3, k
            else:
                assert r[k] == o[k], k
