"""ECC layer: GF tables, RS(255,231)/RS(255,223) decode, CRC16."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.ecc.gf import GF256_RS, GF256_CCSDS, GF64_BCH
from radiosonde_auto_rx_jax.ecc.rs import RS255_231, RS255_223_CCSDS
from radiosonde_auto_rx_jax.ecc.crc import crc16_ccitt


def test_gf256_tables():
    gf = GF256_RS
    assert gf.exp[0] == 1 and gf.exp[1] == 2
    assert gf.exp[8] == 0x1D  # X^8 = X^4+X^3+X^2+1 mod f
    a = np.arange(1, 256)
    np.testing.assert_array_equal(gf.mul(a, gf.inv(a)), np.ones(255))
    # distributivity spot check
    rng = np.random.default_rng(0)
    x, y, z = rng.integers(0, 256, (3, 100))
    np.testing.assert_array_equal(gf.mul(x, y ^ z), gf.mul(x, y) ^ gf.mul(x, z))


def test_gf_ccsds_beta():
    gf = GF256_CCSDS
    # beta = alpha^11, beta^ip = alpha with ip = 116 (bch_ecc_mod.c:766)
    assert (11 * 116) % 255 == 1
    a = np.arange(1, 256)
    np.testing.assert_array_equal(gf.mul(a, gf.inv(a)), np.ones(255))


@pytest.mark.parametrize("code", [RS255_231, RS255_223_CCSDS],
                         ids=["RS(255,231)", "RS(255,223)ccsds"])
def test_rs_encode_roundtrip(code, rng):
    msg = rng.integers(0, 256, (4, code.k))
    cw = code.encode(msg)
    assert np.all(code.syndromes(cw) == 0)
    n = code.decode(cw.copy())
    assert np.all(n == 0)


@pytest.mark.parametrize("code", [RS255_231, RS255_223_CCSDS],
                         ids=["RS(255,231)", "RS(255,223)ccsds"])
@pytest.mark.parametrize("nerr", [1, 5, "t"])
def test_rs_corrects_errors(code, rng, nerr):
    ne = code.t if nerr == "t" else nerr
    B = 6
    msg = rng.integers(0, 256, (B, code.k))
    cw = code.encode(msg)
    bad = cw.copy()
    for r in range(B):
        pos = rng.choice(code.n, size=ne, replace=False)
        bad[r, pos] ^= rng.integers(1, 256, size=ne)
    n = code.decode(bad)
    np.testing.assert_array_equal(n, np.full(B, ne))
    np.testing.assert_array_equal(bad, cw)


def test_rs_detects_uncorrectable(rng):
    code = RS255_231
    msg = rng.integers(0, 256, (2, code.k))
    cw = code.encode(msg)
    bad = cw.copy()
    pos = rng.choice(code.n, size=code.t + 3, replace=False)
    bad[0, pos] ^= rng.integers(1, 256, size=code.t + 3)
    n = code.decode(bad.copy())
    assert n[0] == -1 and n[1] == 0


def test_rs_erasures(rng):
    """2*errors + erasures <= 2t: t errors + t erasures should decode
    with erasure hints where errors alone would fail."""
    code = RS255_231
    msg = rng.integers(0, 256, (3, code.k))
    cw = code.encode(msg)
    bad = cw.copy()
    t = code.t
    n_extra = 5
    era = np.zeros((3, t + n_extra), dtype=np.int64)
    for r in range(3):
        pos = rng.choice(code.n, size=t + n_extra, replace=False)
        bad[r, pos] ^= rng.integers(1, 256, size=t + n_extra)
        era[r] = pos  # tell the decoder where (a superset strategy)
    # erase all corrupted positions: rho = t+5, errors beyond = 0,
    # need rho <= 2t = 24: ok (17)
    n = code.decode(bad, erase_pos=era,
                    n_era=np.full(3, t + n_extra, dtype=np.int64))
    assert np.all(n >= 0)
    np.testing.assert_array_equal(bad, cw)


def test_rs_mixed_batch(rng):
    """Rows with different error counts (incl. failures) decode independently."""
    code = RS255_231
    msg = rng.integers(0, 256, (4, code.k))
    cw = code.encode(msg)
    bad = cw.copy()
    counts = [0, 3, 12, 20]  # 20 > t -> fail
    for r, ne in enumerate(counts):
        if ne:
            pos = rng.choice(code.n, size=ne, replace=False)
            bad[r, pos] ^= rng.integers(1, 256, size=ne)
    n = code.decode(bad)
    assert list(n[:3]) == [0, 3, 12]
    assert n[3] == -1
    np.testing.assert_array_equal(bad[:3], cw[:3])


def test_crc16_known_value():
    # CRC16-CCITT-FALSE of ascii "123456789" is 0x29B1
    data = np.frombuffer(b"123456789", dtype=np.uint8)
    assert crc16_ccitt(data) == 0x29B1


def test_crc16_batched(rng):
    data = rng.integers(0, 256, (5, 30)).astype(np.uint8)
    batched = crc16_ccitt(data)
    for r in range(5):
        assert batched[r] == crc16_ccitt(data[r])


def test_native_viterbi_matches_numpy():
    """The C ACS loop must make identical decisions to the numpy
    reference implementation (same trellis, metric differs only by a
    per-step constant)."""
    from radiosonde_auto_rx_jax import native
    from radiosonde_auto_rx_jax.ecc import viterbi as V
    if not native.available():
        pytest.skip("native runtime not built")
    rng = np.random.default_rng(5)
    data = rng.integers(0, 2, 2000)
    noisy = (V.conv_encode(data).astype(np.float64) * 2 - 1
             + rng.normal(0, 0.6, 4000))
    a = native.viterbi_k7(noisy)
    avail = native.available
    try:
        native.available = lambda: False   # force the numpy path
        b = V.viterbi_decode(noisy)
    finally:
        native.available = avail
    assert (a == b).all()


def test_rs_encode_matches_long_division():
    """Vectorized basis-remainder encode == straight polynomial division
    (checked via zero syndromes and a known-answer round trip)."""
    from radiosonde_auto_rx_jax.ecc.rs import RS255_231, RS255_223_CCSDS
    rng = np.random.default_rng(6)
    for code in (RS255_231, RS255_223_CCSDS):
        msg = rng.integers(0, 256, (4, code.k))
        cw = code.encode(msg)
        assert not code.syndromes(cw).any()
        # corrupt t symbols and decode back
        noisy = cw.copy()
        for r in range(4):
            pos = rng.choice(code.n, code.t, replace=False)
            noisy[r, pos] ^= rng.integers(1, 256, code.t)
        errs = code.decode(noisy)
        assert (errs == code.t).all()
        assert (noisy == cw).all()
