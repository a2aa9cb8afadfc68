"""RS41 model: frame codec roundtrip, ECC, and bit-exactness vs the
reference rs41mod / fsk_demod oracle binaries."""

import numpy as np
import pytest

import oracle
from radiosonde_auto_rx_jax.models.rs41 import (
    encode_frame, frame_to_bits, descramble, rs41_ecc, make_calibytes,
    RS41Decoder, HEADER_BYTES, NDATA_LEN, FRAME_LEN)
from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn
from radiosonde_auto_rx_jax.demod.fsk import FSKConfig, fsk_demod_stream

RS41_CFG = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300, est_min=-5000,
                     est_max=5000, tone_spacing=5000, freq_est_type=1)


def _mkframe(i=0, **kw):
    args = dict(frame_nb=500 + i, sonde_id="S0930112", week=2300,
                tow_ms=23415000 + 1000 * i, lat=47.05, lon=15.43,
                alt=5000.0 + 20 * i, vH=12.5, vD=220.0, vV=4.5,
                calibytes=make_calibytes(), calfr=i % 51)
    args.update(kw)
    return encode_frame(**args)


def _pad518(frame):
    return np.concatenate([frame, np.zeros(FRAME_LEN - len(frame), np.uint8)])


def test_scramble_header():
    """The on-air header bytes 10 B6 CA 11 22 96 12 F8 descramble to the
    frame header (rs41mod.c:86-88)."""
    onair = np.array([0x10, 0xB6, 0xCA, 0x11, 0x22, 0x96, 0x12, 0xF8],
                     np.uint8)
    np.testing.assert_array_equal(descramble(onair), HEADER_BYTES)


def test_frame_roundtrip():
    t = RS41Decoder().decode_frame(_pad518(_mkframe()), NDATA_LEN)
    assert t is not None
    assert t["id"] == "S0930112" and t["frame"] == 500
    assert abs(t["lat"] - 47.05) < 1e-4 and abs(t["alt"] - 5000) < 0.5
    assert abs(t["vel_h"] - 12.5) < 0.02 and abs(t["heading"] - 220) < 0.1
    assert t["datetime"].endswith("Z")


def test_ecc_corrects_byte_errors(rng):
    frame = _mkframe()
    bad = _pad518(frame)
    pos = rng.choice(np.arange(60, NDATA_LEN), 20, replace=False)
    bad[pos] ^= rng.integers(1, 256, 20).astype(np.uint8)
    ec, fixed = rs41_ecc(bad, NDATA_LEN)
    assert ec > 0
    np.testing.assert_array_equal(fixed[:NDATA_LEN], frame)


def test_decode_bits_stream(rng):
    stream = [rng.integers(0, 2, 300)]
    for i in range(3):
        stream.append(frame_to_bits(_mkframe(i)))
    bits = np.concatenate(stream).astype(np.uint8)
    # sprinkle bit errors
    flip = rng.choice(len(bits), 15, replace=False)
    bits[flip] ^= 1
    out = RS41Decoder().decode_bits(bits)
    assert [t["frame"] for t in out] == [500, 501, 502]


def test_calibration_accumulates():
    """Cal subframes collected over frames activate PTU + conf decoding."""
    cal = make_calibytes(tx_freq_khz=404200, rstyp="RS41-SGP")
    meas = [261000, 130000, 235000, 190000, 180000, 200000,
            261500, 130000, 235000, 0, 0, 0]
    dec = RS41Decoder(ptu_mode=1)
    t = None
    for i in range(0x23):
        t = dec.decode_frame(_pad518(_mkframe(i, calibytes=cal,
                                              ptu_meas=meas)), NDATA_LEN)
    assert t is not None
    assert t["tx_frequency"] == 404200
    assert t["subtype"] == "RS41-SGP"
    assert t["rs41_mainboard"] == "RSM412"
    assert "temp" in t and -30 < t["temp"] < 30
    assert "humidity" in t


needs_oracle = pytest.mark.skipif(not oracle.available(),
                                  reason="reference oracle unavailable")


@needs_oracle
def test_frame_parity_vs_reference():
    """Descrambled frames fed to rs41mod --rawhex must yield identical
    telemetry fields to our decoder."""
    rs41mod = oracle.binary("rs41mod")
    assert rs41mod
    cal = make_calibytes()
    meas = [261000, 130000, 235000, 190000, 180000, 200000,
            261500, 130000, 235000, 0, 0, 0]
    hexlines, mine = [], []
    dec = RS41Decoder(ptu_mode=2)
    for i in range(25):
        f = _mkframe(i, calibytes=cal, ptu_meas=meas)
        hexlines.append(bytes(f).hex())
        t = dec.decode_frame(_pad518(f), NDATA_LEN)
        mine.append(t)
    ref = oracle.run_json(
        f"{rs41mod} --rawhex --ecc2 --ptu2 --json",
        ("\n".join(hexlines) + "\n").encode())
    assert len(ref) == len(mine) == 25
    for rt, t in zip(ref, mine):
        m = {k: v for k, v in t.items() if k not in ("datetime_dt", "ecc")}
        for k in set(rt) | set(m):
            if k == "version":
                continue
            assert str(rt.get(k)) == str(m.get(k)), (rt["frame"], k)


@needs_oracle
def test_full_chain_parity_vs_reference(tmp_path):
    """GFSK IQ at 14 dB Eb/N0 through (a) our demod+decoder and (b) the
    reference fsk_demod|rs41mod: same frames, identical fields."""
    import jax.numpy as jnp
    fsk_demod = oracle.binary("fsk_demod")
    rs41mod = oracle.binary("rs41mod")
    assert fsk_demod and rs41mod
    rng = np.random.default_rng(3)
    cal = make_calibytes()
    allbits = [np.random.default_rng(9).integers(0, 2, 400)]
    # clock-rich idle between frames (constant-tone padding would let the
    # symbol-timing estimator wander, a weakness shared with the reference)
    idle = np.tile(np.array([0, 1], np.uint8), (FRAME_LEN - NDATA_LEN) * 4)
    for i in range(6):
        allbits.append(frame_to_bits(_mkframe(i, calibytes=cal)))
        allbits.append(idle)
    bits = np.concatenate(allbits)
    iq = gfsk_mod(bits, 48000, 4800, 2, 800.0, 4800, 0.5)
    iq = add_awgn(iq, 14.0, 48000, 4800, 1, rng)

    _, rxbits, _, _ = fsk_demod_stream(RS41_CFG, jnp.asarray(iq))
    mine = RS41Decoder().decode_bits(np.asarray(rxbits))

    p = tmp_path / "rs41.cs16"
    p.write_bytes(oracle.iq_to_cs16(iq))
    ref = oracle.run_json(
        f"{fsk_demod} --cs16 -b -5000 -u 5000 -s --mask 5000 --nsym=300 "
        f"-p 5 2 48000 4800 {p} - 2>/dev/null | "
        f"{rs41mod} --ptu2 --json --softin -i --ecc2 2>/dev/null")

    assert [t["frame"] for t in mine] == [500 + i for i in range(6)]
    refmap = {t["frame"]: t for t in ref}
    assert len(refmap) == 6
    for t in mine:
        rt = refmap[t["frame"]]
        m = {k: v for k, v in t.items() if k not in ("datetime_dt", "ecc")}
        for k in set(rt) | set(m):
            if k == "version":
                continue
            assert str(rt.get(k)) == str(m.get(k)), (t["frame"], k)


def test_ecc3_erasure_search_beyond_rs_limit(rng):
    """ECC3: with byte scores marking the corrupted bytes weakest, the
    erasure search recovers a frame with 13 errors in one codeword —
    one past the t=12 RS limit (rs41mod.c 3rd pass :1848-1943)."""
    from radiosonde_auto_rx_jax.models.rs41 import RS_MSGPOS
    frame = _mkframe()
    bad = _pad518(frame)
    # 13 byte errors all in codeword 0 (even msg offsets)
    pos = RS_MSGPOS + 2 * np.arange(4, 30, 2)[:13]
    bad[pos] ^= rng.integers(1, 256, 13).astype(np.uint8)

    ec0, _ = rs41_ecc(bad.copy(), NDATA_LEN)
    assert ec0 < 0, "13 errors should defeat plain RS + known-byte pass"

    scores = np.full(FRAME_LEN, 9.0)
    scores[pos[:2]] = 0.1               # two weakest -> erasure candidates
    ec, fixed = rs41_ecc(bad.copy(), NDATA_LEN, byte_scores=scores)
    assert ec >= 0, "ECC3 erasure search failed"
    np.testing.assert_array_equal(fixed[:NDATA_LEN], frame)


def test_ecc3_bit_toggle(rng):
    """ECC3 bit-toggle: 14 single-bit errors in one codeword decode when
    the three weakest scores point at corrupted bytes (2 erasures + 1
    toggled bit)."""
    from radiosonde_auto_rx_jax.models.rs41 import RS_MSGPOS
    frame = _mkframe()
    bad = _pad518(frame)
    pos = RS_MSGPOS + 2 * np.arange(3, 31, 2)[:14]
    bitidx = rng.integers(0, 8, 14)
    bad[pos] ^= (1 << bitidx).astype(np.uint8)

    ec0, _ = rs41_ecc(bad.copy(), NDATA_LEN)
    assert ec0 < 0

    scores = np.full(FRAME_LEN, 9.0)
    scores[pos[0]] = 0.05               # weakest: bit-toggle candidate
    scores[pos[1]] = 0.1                # erasures
    scores[pos[2]] = 0.2
    toggles = np.zeros(FRAME_LEN, np.uint8)
    toggles[pos] = (1 << bitidx).astype(np.uint8)
    ec, fixed = rs41_ecc(bad.copy(), NDATA_LEN, byte_scores=scores,
                         bit_toggle=toggles)
    assert ec >= 0, "ECC3 bit-toggle search failed"
    np.testing.assert_array_equal(fixed[:NDATA_LEN], frame)


def test_ecc4_known_byte_stuffing(rng):
    """ECC4: a decoder with SondeID/cal history recovers a frame whose
    corruption (14 errors in cw0, several in the ID/cal region) defeats
    ECC2+ECC3 alone (rs41mod.c:1764-1845)."""
    from radiosonde_auto_rx_jax.models.rs41 import POS_SONDEID, POS_CALDATA
    dec = RS41Decoder()
    # prime history: one clean frame (id + calfr 0 collected)
    assert dec.decode_frame(_pad518(_mkframe(0)), NDATA_LEN) is not None
    assert dec.id == "S0930112" and dec.calfrchk[0]

    frame = _mkframe(51)       # calfr 51 % 51 = 0 again, frame_nb 551
    bad = _pad518(frame)
    # corrupt the SondeID (4 even-offset bytes -> cw0) and cal bytes
    # (8 even offsets), plus 4 more even msg bytes: 16 errors in cw0
    idpos = POS_SONDEID + np.array([0, 2, 4, 6])
    calpos = POS_CALDATA + 1 + np.array([1, 3, 5, 7, 9, 11, 13, 15])
    extra = np.array([0x70, 0x90, 0xB0, 0xD0])
    allpos = np.concatenate([idpos, calpos, extra])
    cw0pos = allpos[allpos % 2 == 1]   # odd frame pos -> cw1? keep all:
    bad[allpos] ^= rng.integers(1, 256, len(allpos)).astype(np.uint8)

    scores = np.full(FRAME_LEN, 9.0)
    scores[extra] = 0.1
    toggles = np.zeros(FRAME_LEN, np.uint8)

    ec0, _ = rs41_ecc(bad.copy(), NDATA_LEN, byte_scores=scores,
                      bit_toggle=toggles)
    dec._since_good = 51
    t = dec.decode_frame(bad.copy(), NDATA_LEN, byte_scores=scores,
                         bit_toggle=toggles)
    assert t is not None, "ECC4 stuffing did not recover the frame"
    assert t["id"] == "S0930112" and t["frame"] == 551
