"""iMet-1/4 AFSK codec tests + audio-domain demod + parity vs imet4iq."""

import numpy as np
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.models.imet4 import (
    IMet4Decoder, afsk_demod_config, afsk_modulate, bits_8n1_decode,
    bytes_8n1_encode, crc16_1d0f, encode_eptu_packet, encode_frame_bits,
    encode_gps_packet)
from tests import oracle


def test_crc16_1d0f():
    # CRC-16/AUG-CCITT check value
    assert crc16_1d0f(b"123456789") == 0xE5CC


def test_8n1_roundtrip(rng):
    data = rng.integers(0, 255, 40).astype(np.uint8)  # avoid 0xFF sync
    bits = bytes_8n1_encode(data)
    out = bits_8n1_decode(bits)
    assert np.array_equal(out, data)


def test_frame_roundtrip():
    bits = encode_frame_bits([encode_gps_packet(lat=1.23456, lon=103.9876,
                                                alt=7000),
                              encode_eptu_packet(frame=345, T=-12.34)])
    telems = IMet4Decoder().decode_bits(bits)
    assert telems, "no telemetry decoded"
    t = telems[0]
    assert t["type"] == "IMET"
    assert t["frame"] == 345
    assert abs(t["lat"] - 1.23456) < 1e-5
    assert abs(t["lon"] - 103.9876) < 1e-4
    assert t["alt"] == 7000
    assert t["datetime"] == "11:22:33Z"
    assert abs(t["temp"] + 12.34) < 0.01
    assert abs(t["pressure"] - 320.55) < 0.01


def test_bad_crc_rejected():
    gps = encode_gps_packet()
    gps[5] ^= 0xFF
    bits = encode_frame_bits([gps, encode_eptu_packet()])
    assert IMet4Decoder().decode_bits(bits) == []   # GPS invalid -> no JSON


def test_afsk_audio_demod():
    """Bell-202 audio -> FSK engine (real input) -> bits -> telemetry."""
    from radiosonde_auto_rx_jax.demod.fsk import fsk_demod_stream
    rng = np.random.default_rng(2)
    frame = encode_frame_bits([encode_gps_packet(), encode_eptu_packet()],
                              sync_bits=80)
    idle = rng.integers(0, 2, 150).astype(np.uint8)
    tail = rng.integers(0, 2, 500).astype(np.uint8)
    tx = np.concatenate([idle, frame, tail])
    audio = afsk_modulate(tx, fs=48000)
    audio += rng.normal(0, 0.05, len(audio)).astype(np.float32)
    planes = np.stack([audio, np.zeros_like(audio)])[None]   # [1, 2, T]
    cfg = afsk_demod_config(48000)
    soft, bits, stats, _ = fsk_demod_stream(cfg, jnp.asarray(planes))
    # tone order: sym 0 = 1200 Hz = bit 1
    rx = 1 - np.asarray(bits)[0]
    telems = IMet4Decoder().decode_bits(rx)
    assert telems and telems[0]["frame"] == 345


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference(tmp_path):
    binp = oracle.binary("imet4iq")
    if binp is None:
        pytest.skip("could not build imet4iq")
    import struct
    pkts = [encode_gps_packet(), encode_eptu_packet()]
    # the reference only flushes a frame when the next header arrives —
    # send several repetitions
    tx = np.concatenate([np.ones(100, np.uint8)] +
                        [encode_frame_bits(pkts, sync_bits=60)
                         for _ in range(4)])
    audio = afsk_modulate(tx, fs=48000)
    samples = (audio * 12000).astype("<i2")
    data = samples.tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 48000, 96000, 2, 16)
    hdr += b"data" + struct.pack("<I", len(data))
    wav = tmp_path / "imet4.wav"
    wav.write_bytes(hdr + data)
    ref = oracle.run_json(f"{binp} --json {wav}")
    ours = IMet4Decoder().decode_bits(tx)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[0], ours[0]
    for k in ("frame", "lat", "lon", "alt", "sats", "temp", "humidity",
              "pressure", "batt", "datetime"):
        assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
