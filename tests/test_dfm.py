"""DFM codec tests: Hamming(8,4), interleaving, frame round-trip, and
bit-exact telemetry parity with the reference dfm09mod binary."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models.dfm import (
    CODEWORDS, DFMDecoder, HEADER, RAW_HEADER, bits2val, deinterleave,
    encode_flight_bits, encode_frame, fl24, fl24_encode, hamming_decode,
    hamming_encode, interleave, manchester_decode, manchester_encode,
    val2bits)
from tests import oracle


def test_hamming_roundtrip(rng):
    nibs = rng.integers(0, 16, size=13)
    stream = hamming_encode(nibs)
    cw = deinterleave(stream, 13)
    dec, nerr, fail = hamming_decode(cw)
    assert not fail and nerr == 0
    got = [bits2val(dec[i], 4) for i in range(13)]
    assert got == list(nibs)


def test_hamming_corrects_single_bit_errors(rng):
    nibs = rng.integers(0, 16, size=7)
    stream = hamming_encode(nibs)
    # flip one bit in each codeword (via interleaved positions)
    cw = deinterleave(stream, 7)
    for i in range(7):
        cw[i, rng.integers(0, 8)] ^= 1
    dec, nerr, fail = hamming_decode(cw)
    assert not fail and nerr == 7
    assert [bits2val(dec[i], 4) for i in range(7)] == list(nibs)


def test_hamming_soft_two_bit_correction(rng):
    nib = 0b1010
    cw = ((CODEWORDS[nib])[None, :]).astype(np.uint8).copy()
    cw[0, 1] ^= 1
    cw[0, 5] ^= 1
    soft = (2.0 * CODEWORDS[nib] - 1.0)[None, :] * 2.0  # true soft values
    dec, nerr, fail = hamming_decode(cw, soft)
    assert not fail
    assert bits2val(dec[0], 4) == nib


def test_fl24_roundtrip():
    for v in [0.25, 1.0, 123.5, 5000.0, 220e3 / 44.0]:
        assert abs(fl24(fl24_encode(v)) - v) < v * 1e-4 + 1e-6


def test_manchester_header():
    hdr = np.array([int(c) for c in RAW_HEADER], dtype=np.uint8)
    dec = manchester_decode(hdr, variant=2)
    assert "".join(str(b) for b in dec) == HEADER
    re = manchester_encode(dec, variant=2)
    assert np.array_equal(re, hdr)


def test_flight_roundtrip():
    raw = encode_flight_bits(sn=21012345, lat=51.3, lon=6.88, alt=10000.0,
                             vel_h=5.2, heading=180.0, vel_v=-3.5)
    dec = DFMDecoder()
    telems = dec.decode_bits(raw)
    assert telems, "no telemetry decoded"
    t = telems[-1]
    assert t["type"] == "DFM"
    assert t["id"] == "DFM-21012345"
    assert abs(t["lat"] - 51.3) < 1e-6
    assert abs(t["lon"] - 6.88) < 1e-6
    assert abs(t["alt"] - 10000.0) < 0.01
    assert abs(t["vel_h"] - 5.2) < 0.01
    assert abs(t["heading"] - 180.0) < 0.01
    assert abs(t["vel_v"] + 3.5) < 0.01
    assert t["subtype"].startswith("0xA")
    assert t["datetime"] == "2018-06-01T12:30:15.000Z"
    assert "temp" in t


def test_flight_with_bit_errors(rng):
    raw = encode_flight_bits()
    # pepper 0.2% random bit flips — Hamming should absorb most
    flips = rng.random(raw.shape) < 0.002
    noisy = raw ^ flips.astype(np.uint8)
    soft = (noisy.astype(np.float32) * 2 - 1)
    telems = DFMDecoder().decode_bits(noisy, soft)
    assert telems, "no telemetry decoded with 0.2% bit errors"


def test_inverted_polarity():
    raw = encode_flight_bits() ^ 1
    telems = DFMDecoder().decode_bits(raw)
    assert telems and telems[-1]["id"] == "DFM-21012345"


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference():
    """Feed the same raw bit stream to dfm09mod --softin and compare."""
    binp = oracle.binary("dfm09mod")
    if binp is None:
        pytest.skip("could not build dfm09mod")
    raw = encode_flight_bits(sn=21012345, lat=51.3, lon=6.88, alt=10000.0)
    # softin: float32 soft bits, +1 => bit 1? dfm09mod reads f32 soft bits
    lead = np.zeros(200, dtype=np.uint8)
    bits = np.concatenate([lead, raw, lead])
    soft = (bits.astype(np.float32) * 2 - 1)
    ref = oracle.run_json(f"{binp} --ecc -vv --json --dist --auto --softin",
                          soft.tobytes())
    ours = DFMDecoder().decode_bits(bits)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[-1], ours[-1]
    for k in ("id", "lat", "lon", "alt", "vel_h", "vel_v", "heading",
              "sats", "frame", "datetime"):
        assert o[k] == r[k], f"mismatch {k}: ours={o[k]} ref={r[k]}"
    if "temp" in r:
        assert abs(o.get("temp", -999) - r["temp"]) < 0.11


def test_header_corruption_recovered_by_continuation():
    """A frame whose own header is destroyed must still decode: each
    header hit seeds NFRMS consecutive frame reads at the frame stride
    (dfm09mod.c nfrms=8, :1656-1714)."""
    raw = encode_flight_bits(n_cycles=3)
    stride = 2 * 280
    # wreck the raw headers of frames 1..6 (>2-bit errors kills
    # find_frame_starts for them); they sit inside frame 0's NFRMS=8
    # continuation window and must still decode
    noisy = raw.copy()
    for k in range(1, 7):
        noisy[k * stride:k * stride + 12] ^= 1
    telems = DFMDecoder().decode_bits(noisy)
    assert telems and telems[-1]["id"] == "DFM-21012345"


def test_manchester_soft_combining_beats_second_bit():
    """With soft values, both Manchester halves are integrated
    (s = s2 - s1, dfm09mod.c:1685): a weakly-wrong second half is
    overridden by a strongly-right first half."""
    rng = np.random.default_rng(11)
    raw = encode_flight_bits(n_cycles=3)
    soft = raw.astype(np.float32) * 2.0 - 1.0
    # corrupt 8% of SECOND halves (outside the headers) to a weakly
    # wrong value; first halves stay confident
    n_frames = len(raw) // (2 * 280)
    protected = np.zeros(len(raw), bool)
    for p in range(0, len(raw), 2 * 280):
        protected[p:p + 32] = True
    idx = np.flatnonzero((np.arange(len(raw)) % 2 == 1) & ~protected)
    bad = rng.choice(idx, size=int(0.08 * len(idx)), replace=False)
    soft[bad] = -0.2 * (raw[bad] * 2.0 - 1.0)
    hard = (soft >= 0).astype(np.uint8)
    # hard second-bit slicing alone fails on this stream
    assert not DFMDecoder().decode_bits(hard)
    # combined-soft decoding recovers it
    telems = DFMDecoder().decode_bits(hard, soft)
    assert telems and telems[-1]["id"] == "DFM-21012345"
