"""Bit-stream framing: header correlation, bit packing, frame extraction.

Replaces the reference's per-sample circular header buffers
(demod/mod/demod_mod.c find_header :1533, find_softbinhead :1740) with
array-wide correlation: one correlation pass over the whole soft-bit stream
finds every frame start at once (vectorizable over channels on device; numpy
here on the host frame plane).
"""

import numpy as np


def _native():
    try:
        from radiosonde_auto_rx_jax import native
        return native if native.available() else None
    except ImportError:
        return None


def header_bits(header_str: str) -> np.ndarray:
    """'0101...' -> int8 array of ±1 (1 -> +1, 0 -> -1)."""
    b = np.frombuffer(header_str.encode(), dtype=np.uint8) - ord("0")
    return (b.astype(np.int8) * 2 - 1)


def correlate_bits(bits01: np.ndarray, header_pm1: np.ndarray) -> np.ndarray:
    """Sliding match count of hard bits [T] against a ±1 header [H].

    Returns score[t] = #matching bits for the header aligned at t
    (length T-H+1).
    """
    x = bits01.astype(np.int32) * 2 - 1
    h = header_pm1.astype(np.int32)
    corr = np.correlate(x, h, mode="valid")
    return (corr + len(h)) // 2


def find_frame_starts(bits01: np.ndarray, header_str: str,
                      max_errors: int = 3, min_spacing: int | None = None):
    """Positions (bit index of first payload bit AFTER the header) where the
    header matches with <= max_errors bit errors.

    Mirrors hdb.thb = 1 - 3.1/len thresholding (reference rs41mod.c:2857).
    Consecutive detections within min_spacing keep only the best.
    """
    h = header_bits(header_str)
    nat = _native()
    if nat is not None and len(bits01) >= len(h):
        # popcount path: XOR packed 64-bit words with early exit
        hits, errs = nat.find_headers(bits01, (h > 0).astype(np.uint8),
                                      max_errors)
        score_at = dict(zip(hits.tolist(), (len(h) - errs).tolist()))
        score = None
    else:
        score_full = correlate_bits(bits01, h)
        hits = np.flatnonzero(score_full >= len(h) - max_errors)
        score = score_full
    if len(hits) == 0:
        return np.array([], dtype=np.int64)
    if min_spacing is None:
        min_spacing = len(h)

    def best(cluster):
        if score is not None:
            return cluster[int(np.argmax(score[cluster]))]
        return max(cluster, key=lambda p: score_at[p])

    # greedy NMS: keep best score in each cluster
    out = []
    cluster = [hits[0]]
    for p in hits[1:]:
        if p - cluster[-1] <= min_spacing:
            cluster.append(p)
        else:
            out.append(best(cluster))
            cluster = [p]
    out.append(best(cluster))
    return np.asarray(out, dtype=np.int64) + len(h)


def bits_to_bytes_le(bits01: np.ndarray) -> np.ndarray:
    """Pack bits to bytes, LSB-first within each byte
    (reference rs41mod.c bits2byte :224-234)."""
    n = (len(bits01) // 8) * 8
    b = bits01[:n].reshape(-1, 8).astype(np.uint8)
    weights = (1 << np.arange(8)).astype(np.uint8)
    return (b * weights).sum(axis=1).astype(np.uint8)


def bits_to_bytes_be(bits01: np.ndarray) -> np.ndarray:
    """Pack bits to bytes, MSB-first within each byte."""
    n = (len(bits01) // 8) * 8
    b = bits01[:n].reshape(-1, 8).astype(np.uint8)
    weights = (1 << np.arange(7, -1, -1)).astype(np.uint8)
    return (b * weights).sum(axis=1).astype(np.uint8)


def bytes_to_bits_le(data: np.ndarray) -> np.ndarray:
    """Unpack bytes to bits, LSB-first (encoder fixture direction)."""
    data = np.asarray(data, dtype=np.uint8)
    return ((data[:, None] >> np.arange(8)[None, :]) & 1
            ).reshape(-1).astype(np.uint8)


def bytes_to_bits_be(data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, dtype=np.uint8)
    return ((data[:, None] >> np.arange(7, -1, -1)[None, :]) & 1
            ).reshape(-1).astype(np.uint8)


def extract_frame_bits(bits01: np.ndarray, start: int, n_bits: int,
                       soft: np.ndarray | None = None):
    """Slice one frame's bits (zero-padded if the stream ends early).

    Returns (frame_bits [n_bits], frame_soft [n_bits] or None).
    """
    end = min(start + n_bits, len(bits01))
    fb = np.zeros(n_bits, dtype=np.uint8)
    fb[: end - start] = bits01[start:end]
    fs = None
    if soft is not None:
        fs = np.zeros(n_bits, dtype=np.float32)
        fs[: end - start] = soft[start:end]
    return fb, fs
