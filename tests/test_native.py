"""Native host-runtime tests: conversion parity, ring buffer semantics,
header correlation parity vs the NumPy framing path."""

import os
import threading

import numpy as np
import pytest

from radiosonde_auto_rx_jax import native
from radiosonde_auto_rx_jax.demod import framing
from radiosonde_auto_rx_jax.sources import iq_source

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="native runtime not built")


# --- IQ conversion parity vs the NumPy fallbacks --------------------------

def _numpy_cu8(buf):
    raw = np.frombuffer(buf, dtype=np.uint8)
    x = (raw.astype(np.float32) - 127.5) / 128.0
    return np.ascontiguousarray(x.reshape(-1, 2).T)


def test_cu8_parity(rng):
    buf = rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    np.testing.assert_allclose(native.cu8_to_planes(buf), _numpy_cu8(buf),
                               rtol=0, atol=0)


def test_cs16_parity(rng):
    raw = rng.integers(-32768, 32768, 2048, dtype=np.int16)
    got = native.cs16_to_planes(raw.tobytes())
    want = np.ascontiguousarray(
        (raw.astype(np.float32) / 32768.0).reshape(-1, 2).T)
    np.testing.assert_allclose(got, want, rtol=0, atol=0)
    assert got.dtype == np.float32 and got.shape == (2, 1024)


def test_f32c_parity(rng):
    raw = rng.standard_normal(512).astype(np.float32)
    got = native.f32c_to_planes(raw.tobytes())
    np.testing.assert_array_equal(got, raw.reshape(-1, 2).T)


def test_s16_to_f32(rng):
    raw = rng.integers(-32768, 32768, 777, dtype=np.int16)
    np.testing.assert_allclose(native.s16_to_f32(raw.tobytes()),
                               raw.astype(np.float32) / 32768.0)


def test_iq_source_uses_native(rng):
    # iq_source dispatches to the native converter when available
    buf = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    np.testing.assert_array_equal(iq_source.cu8_to_planes(buf),
                                  _numpy_cu8(buf))


# --- ring buffer ----------------------------------------------------------

def test_ringbuffer_inprocess_roundtrip(rng):
    data = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    with native.RingBuffer(capacity=1 << 14) as rb:  # smaller than payload
        def producer():
            for i in range(0, len(data), 4096):
                rb.write(data[i:i + 4096])
            rb.close_write()
        t = threading.Thread(target=producer)
        t.start()
        got = rb.read_exact(len(data), timeout_ms=10_000)
        t.join()
        assert got == data
        assert rb.eof and rb.available() == 0
        assert rb.total_in() == len(data)


def test_ringbuffer_fd_pump(rng):
    data = rng.integers(0, 256, 250_000, dtype=np.uint8).tobytes()
    r, w = os.pipe()
    with native.RingBuffer(capacity=1 << 15) as rb:
        rb.start_pump(r)
        def writer():
            with os.fdopen(w, "wb") as f:
                f.write(data)
        t = threading.Thread(target=writer)
        t.start()
        got = rb.read_exact(len(data), timeout_ms=10_000)
        t.join()
        assert got == data
        # EOF after pipe close + drain
        assert rb.read(1, timeout_ms=2000) == b""
        assert rb.eof
    os.close(r)


def test_ringbuffer_timeout():
    r, w = os.pipe()
    try:
        with native.RingBuffer(capacity=1 << 12) as rb:
            rb.start_pump(r)
            assert rb.read(16, timeout_ms=50) == b""   # nothing yet
            assert not rb.eof
    finally:
        os.close(w)
        os.close(r)


def test_pumped_reader_stream(rng):
    data = rng.integers(0, 256, 64_000, dtype=np.uint8).tobytes()
    r, w = os.pipe()
    with os.fdopen(w, "wb") as fw:
        fw.write(data)
    reader = native.PumpedReader(os.fdopen(r, "rb"), capacity=1 << 14)
    try:
        assert reader.read(1000) == data[:1000]
        assert reader.read(len(data) - 1000) == data[1000:]
        assert reader.read(10) == b""
    finally:
        reader.close()


def test_open_pumped_passthrough_for_bytesio():
    import io
    s = io.BytesIO(b"abc")
    assert iq_source.open_pumped(s) is s


# --- header correlation ---------------------------------------------------

def _plant(rng, n, header01, positions, flips_at=()):
    bits = rng.integers(0, 2, n).astype(np.uint8)
    for p in positions:
        bits[p:p + len(header01)] = header01
    for p, k in flips_at:
        idx = rng.choice(len(header01), size=k, replace=False)
        bits[p + idx] ^= 1
    return bits


def test_bitcorr_parity_with_numpy(rng):
    hdr = framing.header_bits("00001000011011010101001110001000"
                              "01000100011010010100100000011111")
    h01 = (hdr > 0).astype(np.uint8)
    bits = _plant(rng, 20_000, h01, [123, 5000, 19_000 - len(h01)],
                  flips_at=[(5000, 2)])
    pos, err = native.find_headers(bits, h01, max_errors=3)
    assert 123 in pos and 5000 in pos
    # exact parity with the NumPy correlator over every offset
    score = framing.correlate_bits(bits, hdr)
    want = np.flatnonzero(score >= len(hdr) - 3)
    np.testing.assert_array_equal(np.sort(pos), want)
    for p, e in zip(pos, err):
        assert score[p] == len(hdr) - e


def test_find_frame_starts_native_matches_fallback(rng, monkeypatch):
    header = "10100110011001101010011001100110"
    h01 = (framing.header_bits(header) > 0).astype(np.uint8)
    bits = _plant(rng, 8000, h01, [50, 2000, 6000], flips_at=[(2000, 1)])
    native_starts = framing.find_frame_starts(bits, header, max_errors=2)
    monkeypatch.setattr(framing, "_native", lambda: None)
    fallback_starts = framing.find_frame_starts(bits, header, max_errors=2)
    np.testing.assert_array_equal(native_starts, fallback_starts)
    assert 50 + len(h01) in native_starts


def test_bitcorr_unaligned_offsets(rng):
    # hit positions straddling every shift mod 64
    h01 = rng.integers(0, 2, 80).astype(np.uint8)
    for t in [0, 1, 63, 64, 65, 127, 300]:
        bits = rng.integers(0, 2, 600).astype(np.uint8)
        bits[t:t + 80] = h01
        pos, err = native.find_headers(bits, h01, max_errors=0)
        assert t in pos


def test_soft_to_bits(rng):
    soft = rng.standard_normal(1000).astype(np.float32)
    np.testing.assert_array_equal(native.soft_to_bits(soft),
                                  (soft > 0).astype(np.uint8))
    np.testing.assert_array_equal(native.soft_to_bits(soft, invert=True),
                                  (soft <= 0).astype(np.uint8))
