"""Double-buffered block prefetch in the station capture loop.

The capture source overlaps IO with device compute via a reader thread
(SURVEY §2.3 host-side async driver; the reference gets this overlap from
its per-task subprocess pipelines, reference autorx/decode.py:1602-2002).
These tests pin the semantics: block order and values identical to
synchronous reads, capture-center tagging, EOF, and retune flushing."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.station.main import BlockSource, parse_args


def _write_cs16(path, n_samples, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(-2000, 2000, size=2 * n_samples, dtype=np.int16)
    path.write_bytes(data.tobytes())
    return data


def _mk(tmp_path, n_blocks=3, extra=100, block_s=0.01, fs=48000):
    block = int(fs * block_s)
    path = tmp_path / "capture.cs16"
    _write_cs16(path, n_blocks * block + extra)
    args = parse_args(["--replay", str(path), "--block-seconds",
                       str(block_s), "--center", "402.5"])
    return BlockSource({"capture_rate": fs}, args), path, block


def test_replay_blocks_match_sync_reads(tmp_path):
    src, path, block = _mk(tmp_path)
    # synchronous ground truth
    from radiosonde_auto_rx_jax.sources.iq_source import IQStreamSource
    ref = IQStreamSource(open(path, "rb"), fmt="cs16", block_samples=block)
    want = []
    while True:
        b = ref.read_block()
        if b is None:
            break
        want.append(np.asarray(b))

    got = []
    while True:
        center, b = src.read_block()
        if b is None:
            break
        assert center == pytest.approx(402.5e6)
        got.append(np.asarray(b))
    src.close()

    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        # BlockSource ships native-width int16 planes; the 1/32768
        # wire scale (exact power of two) is applied on-device —
        # value-identical to the synchronous f32 conversion
        assert g.dtype == np.int16
        np.testing.assert_array_equal(
            g.astype(np.float32) / 32768.0, w)


def test_eof_is_sticky(tmp_path):
    src, _, _ = _mk(tmp_path, n_blocks=1, extra=0)
    _, b = src.read_block()
    assert b is not None
    for _ in range(3):
        _, b = src.read_block()
        assert b is None
    src.close()


def test_replay_ignores_retune(tmp_path):
    src, _, _ = _mk(tmp_path, n_blocks=2)
    src.retune(404.0e6)
    center, b = src.read_block()
    assert b is not None and center == pytest.approx(402.5e6)
    src.close()


def test_retune_restarts_capture_and_retags(tmp_path, monkeypatch):
    """SDR path: retune kills the capture process, drops queued blocks
    from the old center, and new blocks carry the new tag."""
    fs, block_s = 48000, 0.01
    block = int(fs * block_s)
    path = tmp_path / "sdr.cs16"
    raw = _write_cs16(path, 4 * block)

    import radiosonde_auto_rx_jax.sources.sdr_wrappers as sw
    calls = []

    def fake_cmd(sdr_type, freq, fs_, **kw):
        calls.append(freq)
        return f"cat {path} |"

    monkeypatch.setattr(sw, "get_sdr_iq_cmd", fake_cmd)
    args = parse_args(["--block-seconds", str(block_s),
                       "--center", "402.5"])
    src = BlockSource({"capture_rate": fs, "sdr_type": "RTLSDR"}, args)
    center, b1 = src.read_block()
    assert center == pytest.approx(402.5e6) and b1 is not None

    src.retune(404.0e6)
    center, b2 = src.read_block()
    assert center == pytest.approx(404.0e6) and b2 is not None
    # capture restarted: the first post-retune block is the file's FIRST
    # block again (fresh cat), not a continuation
    first = raw[:2 * block].reshape(-1, 2).T
    np.testing.assert_array_equal(np.asarray(b2), first)
    assert calls == [402.5e6, 404.0e6]
    src.close()
