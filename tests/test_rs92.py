"""RS92 codec tests: frame round-trip, ECC, PTU cal, RINEX IO, and JSON
parity vs the reference rs92mod (raw-pseudorange GPS navigation)."""

import os

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models.rs92 import (
    RS92Decoder, encode_frame, encode_flight_bits, frame_to_raw_bits,
    make_calibytes, make_test_ephemeris, gps_to_date)
from radiosonde_auto_rx_jax.station import gps_ephem
from tests import oracle

LAT, LON, ALT = -34.95, 138.52, 12000.0
VNEU = (5.0, 3.0, -4.0)


@pytest.fixture(scope="module")
def ephs():
    return make_test_ephemeris()


def _decoder(ephs):
    return RS92Decoder(ephemeris=ephs)


def test_gps_to_date():
    # GPS week 2300 starts 2024-02-04 (Sunday)
    assert gps_to_date(2300, 0) == (2024, 2, 4)


def test_frame_roundtrip(ephs):
    raw = encode_flight_bits(n_frames=2, ephs=ephs, lat=LAT, lon=LON,
                             alt=ALT, vel_neu=VNEU)
    telems = _decoder(ephs).decode_bits(raw)
    assert telems, "no telemetry decoded"
    t = telems[-1]
    assert t["type"] == "RS92"
    assert t["id"] == "R1234567"
    assert t["subtype"] == "RS92-SGP"
    assert abs(t["lat"] - LAT) < 5e-4
    assert abs(t["lon"] - LON) < 5e-4
    assert abs(t["alt"] - ALT) < 100.0
    vH = np.hypot(VNEU[0], VNEU[1])
    vD = np.degrees(np.arctan2(VNEU[1], VNEU[0])) % 360
    assert abs(t["vel_h"] - vH) < 1.0
    assert abs(t["heading"] - vD) < 20.0
    assert abs(t["vel_v"] - VNEU[2]) < 1.0
    assert t["datetime"].startswith("2024-02-")
    assert t["tx_frequency"] == 402500


def test_rs_ecc_corrects_byte_errors(ephs):
    f = encode_frame(ephs=ephs, lat=LAT, lon=LON, alt=ALT)
    f_err = f.copy()
    for pos in (20, 80, 150, 200):   # 4 byte errors < t=12
        f_err[pos] ^= 0x5A
    telems = _decoder(ephs).decode_bits(frame_to_raw_bits(f_err))
    assert telems and telems[0]["ecc"] == 4
    assert abs(telems[0]["lat"] - LAT) < 5e-4


def test_uncorrectable_frame_rejected(ephs):
    f = encode_frame(ephs=ephs)
    f[20:60] ^= 0xFF   # way beyond t=12
    assert _decoder(ephs).decode_bits(frame_to_raw_bits(f)) == []


def test_inverted_stream(ephs):
    raw = encode_flight_bits(n_frames=1, ephs=ephs, lat=LAT, lon=LON,
                             alt=ALT) ^ 1
    telems = _decoder(ephs).decode_bits(raw)
    assert telems and abs(telems[0]["lat"] - LAT) < 5e-4


def test_ptu_after_full_cal(ephs):
    raw = encode_flight_bits(n_frames=32, ephs=ephs, lat=LAT, lon=LON,
                             alt=ALT, T=-25.0, RH=45.0, P=320.0)
    dec = _decoder(ephs)
    telems = dec.decode_bits(raw)
    assert dec.cal_complete
    t = telems[-1]
    assert abs(t["temp"] + 25.0) < 0.2
    assert abs(t["humidity"] - 45.0) < 0.2
    assert abs(t["pressure"] - 320.0) < 0.5


def test_no_ephemeris_no_position(ephs):
    raw = encode_flight_bits(n_frames=1, ephs=ephs)
    assert RS92Decoder().decode_bits(raw) == []


def test_rinex_roundtrip(tmp_path, ephs):
    path = str(tmp_path / "nav.txt")
    gps_ephem.write_rinex_nav(ephs, path)
    back = gps_ephem.read_rinex_nav(path)
    assert len(back) == len(ephs)
    for a, b in zip(ephs, back):
        assert a.prn == b.prn
        assert a.gpsweek == b.gpsweek
        assert abs(a.toe - b.toe) < 1e-3
        assert abs(a.Omega0 - b.Omega0) < 1e-9
        assert abs(a.M0 - b.M0) < 1e-9


def _soft_stream(raw_bits, lead=200):
    lead0 = np.zeros(lead, dtype=np.uint8)
    stream = np.concatenate([lead0, raw_bits, lead0])
    return (stream.astype(np.float32) * 2 - 1).tobytes(), stream


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_parity_vs_reference(tmp_path, ephs):
    binp = oracle.binary("rs92mod")
    if binp is None:
        pytest.skip("could not build rs92mod")
    rinex = str(tmp_path / "eph.txt")
    gps_ephem.write_rinex_nav(ephs, rinex)
    raw = encode_flight_bits(n_frames=32, ephs=ephs, lat=LAT, lon=LON,
                             alt=ALT, vel_neu=VNEU, T=-25.0, RH=45.0,
                             P=320.0)
    soft, stream = _soft_stream(raw)
    ref = oracle.run_json(
        f"{binp} --ecc --crc --vel --ptu --json --softin -e {rinex}", soft)
    ours = RS92Decoder(ephemeris=ephs).decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[-1], ours[-1]
    assert r["id"] == o["id"]
    assert r["frame"] == o["frame"]
    assert r["datetime"] == o["datetime"]
    assert abs(r["lat"] - o["lat"]) < 2e-4
    assert abs(r["lon"] - o["lon"]) < 2e-4
    assert abs(r["alt"] - o["alt"]) < 60.0
    assert abs(r["vel_h"] - o["vel_h"]) < 1.5
    assert abs(r["vel_v"] - o["vel_v"]) < 1.5
    if "temp" in r:
        assert abs(r["temp"] - o["temp"]) < 0.2
        assert abs(r["humidity"] - o["humidity"]) < 0.2


def test_ngp_full_cal_roundtrip(ephs):
    """RS92-NGP: scrambled cal + PTU decode after full cal collection,
    with the type auto-toggled from the 0x170 constant block
    (rs92mod.c chk_toggle_type :342-365, xor_ptu :367-419)."""
    cal = make_calibytes(ngp=True, freq_khz=1680000)
    raw = encode_flight_bits(n_frames=32, ephs=ephs, calibytes=cal,
                             ngp=True, lat=LAT, lon=LON, alt=ALT,
                             T=-25.0, RH=45.0, P=320.0)
    dec = RS92Decoder(ephemeris=ephs)     # ngp defaults False: auto-toggle
    telems = dec.decode_bits(raw)
    assert dec.cal_complete
    assert dec.ngp, "NGP not auto-detected from cal constant block"
    t = telems[-1]
    assert t["subtype"] == "RS92-NGP"
    assert abs(t["lat"] - LAT) < 5e-4
    assert abs(t["temp"] + 25.0) < 0.2
    assert abs(t["humidity"] - 45.0) < 0.2
    assert abs(t["pressure"] - 320.0) < 0.5
    # NGP frequency table: 1600 MHz base (rs92mod.c:757)
    assert dec.freq_khz == 1680000


def test_ngp_keystream_roundtrip():
    """xcal_key recovers the exact keystream the encoder applied."""
    from radiosonde_auto_rx_jax.models.rs92 import xcal_key
    key = np.arange(16, dtype=np.uint8) * 7 + 3
    cal = make_calibytes(ngp=True, ngp_key=key, freq_khz=1680000)
    assert np.array_equal(xcal_key(cal), key)


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_ngp_parity_vs_reference(tmp_path, ephs):
    """The reference rs92mod --ngp decodes our synthesized NGP stream and
    agrees with our decoder — evidence the scramble/byte-order model
    matches the real protocol handling (rs92mod.c --ngp paths)."""
    binp = oracle.binary("rs92mod")
    if binp is None:
        pytest.skip("could not build rs92mod")
    rinex = str(tmp_path / "eph.txt")
    gps_ephem.write_rinex_nav(ephs, rinex)
    cal = make_calibytes(ngp=True, freq_khz=1680000)
    raw = encode_flight_bits(n_frames=32, ephs=ephs, calibytes=cal,
                             ngp=True, lat=LAT, lon=LON, alt=ALT,
                             T=-25.0, RH=45.0, P=320.0)
    soft, stream = _soft_stream(raw)
    ref = oracle.run_json(
        f"{binp} --ngp --ecc --crc --vel --ptu --json --softin -e {rinex}",
        soft)
    ours = RS92Decoder(ephemeris=ephs).decode_bits(stream)
    assert ref, "reference produced no JSON"
    assert ours, "our decoder produced no telemetry"
    r, o = ref[-1], ours[-1]
    assert r["id"] == o["id"]
    assert r.get("subtype") == "RS92-NGP" == o["subtype"]
    assert abs(r["lat"] - o["lat"]) < 2e-4
    assert abs(r["lon"] - o["lon"]) < 2e-4
    assert abs(r["alt"] - o["alt"]) < 60.0
    if "temp" in r:
        assert abs(r["temp"] - o["temp"]) < 0.2
        assert abs(r["humidity"] - o["humidity"]) < 0.2


def test_soft_combining_beats_second_bit(ephs):
    """Both Manchester symbols are integrated when soft values are given
    (rs92mod.c:2016-2022): weakly-wrong second halves are overridden by
    confident first halves."""
    rng = np.random.default_rng(5)
    raw = encode_flight_bits(n_frames=2, ephs=ephs, lat=LAT, lon=LON,
                             alt=ALT)
    soft = raw.astype(np.float32) * 2.0 - 1.0
    idx = np.flatnonzero(np.arange(len(raw)) % 2 == 1)
    idx = idx[idx > 400]                      # keep the header findable
    bad = rng.choice(idx, size=int(0.10 * len(idx)), replace=False)
    soft[bad] = -0.2 * (raw[bad] * 2.0 - 1.0)
    hard = (soft >= 0).astype(np.uint8)
    assert _decoder(ephs).decode_bits(hard) == []
    telems = _decoder(ephs).decode_bits(hard, soft)
    assert telems and abs(telems[0]["lat"] - LAT) < 5e-4


def test_prn32_overflow_corrects_following_slot():
    """A frame tracking PRN 32 (5-bit field 0 + overflow bit) borrows
    the LSB of the NEXT slot's PRN field as the overflow marker; the
    decoder's persistent toggle must recover the next slot's true PRN,
    flipping when the naive correction collides with another tracked
    PRN (rs92mod.c:798-842)."""
    import numpy as np
    from radiosonde_auto_rx_jax.models.rs92 import (
        POS_GPS_PRN, POS_GPS_STATUS, unpack_prns)

    def build(prn_fields, status):
        prn_le = np.zeros(64, np.uint8)
        for i, v in enumerate(prn_fields):
            for j in range(5):
                prn_le[5 * i + j] = (v >> j) & 1
        frame = np.zeros(256, np.uint8)
        for blk in range(4):
            w = 0
            for i in range(15):
                w |= int(prn_le[15 * blk + i]) << i
            w |= int(prn_le[60 + blk]) << 15
            frame[POS_GPS_PRN + 2 * blk] = w & 0xFF
            frame[POS_GPS_PRN + 2 * blk + 1] = w >> 8
        frame[POS_GPS_STATUS:POS_GPS_STATUS + 12] = status
        return frame

    status = np.full(12, 0x05, np.uint8)
    # slot 0 = PRN 32 (field 0); slot 1's field LSB doubles as the
    # overflow marker, so true PRN 9 (0b01001) transmits as 9 with the
    # marker bit set; remaining slots arbitrary distinct PRNs
    fields = [0, 9, 3, 4, 5, 6, 7, 10, 11, 12, 13, 14]
    prns, st, tog = unpack_prns(build(fields, status), 0x1)
    assert prns[0] == 32
    # no tracked PRN equals 9^1=8 -> toggle stays 1, slot 1 reads 8
    assert tog == 0x1 and prns[1] == 8

    # now make PRN 8 already tracked elsewhere: 9^1 collides -> the
    # toggle flips to 0 and slot 1 keeps its raw value 9
    fields2 = [0, 9, 8, 4, 5, 6, 7, 10, 11, 12, 13, 14]
    prns2, _, tog2 = unpack_prns(build(fields2, status), 0x1)
    assert prns2[0] == 32
    assert tog2 == 0x0 and prns2[1] == 9

    # no PRN-32 in frame: toggle passes through untouched
    fields3 = [1, 9, 8, 4, 5, 6, 7, 10, 11, 12, 13, 14]
    prns3, _, tog3 = unpack_prns(build(fields3, status), 0x0)
    assert prns3[0] == 1 and tog3 == 0x0
