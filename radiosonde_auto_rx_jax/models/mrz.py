"""Meteo-Radiy MP3-H1 / MRZ-N1 frame codec (2.4 kBd, Manchester1, CRC16).

Frame structure and telemetry semantics follow the on-air protocol as
documented by the reference decoder (reference demod/mod/mp3h1mod.c):
44-bit preamble+header, Manchester1 raw bits (:114-155); 8-bit offset then
MSB-first byte packing (:157-185,805-807); frame "AA BF 35" + counter,
time, ECEF position/velocity cm (little-endian), nSats, T16/H16, ADC
values, per-frame config word (:250-275); lat/lon frame variant flagged by
0xFFFF at byte 30 (:808-810); CRC16 reversed-0x8005 init 0xFFFF over
[3, 3+crclen) stored LE (:280-310); config channels: NTC cal A/B/C, ADC
cals, snC/snD serials, date (:520-618); ECEF→geodetic + NEU velocities
(:313-395); JSON output gated on snC/snD/date known and time advancing
(:735-781).  Implementation (numpy + encoder fixture) is new.
"""

import numpy as np

from radiosonde_auto_rx_jax.models import register
from radiosonde_auto_rx_jax.demod.framing import find_frame_starts
from radiosonde_auto_rx_jax.models.rs41 import (
    ecef_to_geodetic, geodetic_to_ecef, hdv_to_ecef_vel, ecef_vel_to_hdv)

HEADER = "100110011001100110011001100110011001" "10101010"
BAUD = 2399
BITS_OFS = 8
CRCLEN_ECEF = 45
CRCLEN_LATLON = 42
FRAME_LEN = (CRCLEN_ECEF + 6)
BITFRAME_LEN = FRAME_LEN * 8

POS_CNT1, POS_TIME = 3, 4
POS_ECEF_X, POS_ECEF_V, POS_NSATS = 8, 20, 26
POS_T16, POS_H16, POS_FFFF = 29, 31, 33
POS_ADCT, POS_ADCH, POS_CNT2, POS_CFG = 35, 39, 43, 44
TIMEOUT_JSN = 60


def crc16_rev(data):
    """CRC16 poly 0xA001 (reversed 0x8005), init 0xFFFF (mp3h1mod.c:280)."""
    rem = 0xFFFF
    for byte in data:
        rem ^= int(byte)
        for _ in range(8):
            rem = (rem >> 1) ^ 0xA001 if rem & 1 else rem >> 1
    return rem & 0xFFFF


def _u2(f, p):
    return int(f[p]) | (int(f[p + 1]) << 8)


def _i2(f, p):
    v = _u2(f, p)
    return v - 0x10000 if v & 0x8000 else v


def _u4(f, p):
    return int(f[p]) | (int(f[p + 1]) << 8) | (int(f[p + 2]) << 16) | \
        (int(f[p + 3]) << 24)


def _i4(f, p):
    v = _u4(f, p)
    return v - 0x100000000 if v & 0x80000000 else v


def _f32(u):
    return float(np.frombuffer(np.uint32(u).tobytes(), "<f4")[0])


def datetime2gpsweek(yy, mm, dd, hr, mi, sec):
    if mm < 3:
        yy -= 1
        mm += 12
    gps_days = int(365.25 * yy) + int(30.6001 * (mm + 1.0)) + dd - 723263
    return gps_days // 7, (gps_days % 7) * 86400 + hr * 3600 + mi * 60 + sec


@register("MRZ")
class MRZDecoder:
    """Stateful MRZ frame decoder: raw Manchester1 bit stream -> telemetry."""

    HEADER = HEADER

    def __init__(self, jsn_freq_khz: int = 0):
        self.jsn_freq_khz = jsn_freq_khz
        self.reset_cfg()

    def reset_cfg(self):
        self.snC = 0
        self.snD = 0
        self.cfg = {}
        self.yr = self.mth = self.day = 0
        self.week = 0
        self.gps_cnt = 0
        self.gps_cnt_prev = 0
        self.sec_day = 0
        self.sec_day_prev = 0

    def decode_bits(self, raw_bits, soft=None):
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        out = []
        for inv in (False, True):
            hdr = HEADER if not inv else "".join(
                "1" if c == "0" else "0" for c in HEADER)
            for s in find_frame_starts(raw_bits, hdr, max_errors=2):
                raw = raw_bits[s:s + 2 * BITFRAME_LEN + 16]
                if inv:
                    raw = raw ^ 1
                if len(raw) < 2 * BITFRAME_LEN:
                    continue
                # Manchester1: decoded bit = complement of 2nd raw bit
                # (mp3h1mod.c:1224-1228: hb ^= 1 when not inverted).
                # With soft values both Manchester symbols are
                # integrated: s = s2-s1, decoded bit = (s < 0)
                # (mp3h1mod.c:1208).  The frame's leading "AA BF" bytes
                # are formed by the decoded header itself plus the two
                # bits that follow — the stream starts mid-byte, so
                # prepend the 22 decoded header bits before packing
                # (cf. mp3h1mod.c:114-129).
                n = len(raw) // 2 * 2
                if soft is not None and len(soft) >= s + n:
                    sr = soft[s:s + n] * (-1.0 if inv else 1.0)
                    bits = (sr[1::2] - sr[0::2] < 0.0).astype(np.uint8)
                else:
                    bits = raw[1:n:2] ^ 1
                hdr_decoded = np.array(
                    [1, 0] * 9 + [1, 1, 1, 1], dtype=np.uint8)
                t = self.decode_frame_bits(
                    np.concatenate([hdr_decoded, bits]))
                if t:
                    out.append(t)
        return out

    def decode_frame_bits(self, frame_bits):
        bits = frame_bits[BITS_OFS:]
        nby = min(len(bits) // 8, FRAME_LEN)
        frame = (bits[: nby * 8].reshape(-1, 8) <<
                 np.arange(7, -1, -1)[None, :]).sum(axis=1).astype(np.uint8)
        frame = np.concatenate(
            [frame, np.zeros(FRAME_LEN - nby, dtype=np.uint8)])
        return self.decode_frame(frame)

    def decode_frame(self, frame):
        crclen = CRCLEN_LATLON if _u2(frame, 30) == 0xFFFF else CRCLEN_ECEF
        crcdat = _u2(frame, crclen + 3)
        crc_ok = crcdat == crc16_rev(frame[POS_CNT1:POS_CNT1 + crclen])
        ofs = 0 if crclen == CRCLEN_ECEF else -3

        self._get_cfg(frame, ofs, crc_ok)
        telem = None
        if crc_ok:
            telem = self._get_position(frame, ofs)
        return telem

    # ---- config channels (mp3h1mod.c:520-618) ----

    def _get_cfg(self, frame, ofs, crc_ok):
        if not crc_ok:
            return
        subcnt1 = int(frame[POS_CNT1]) & 0xF
        cfg32 = _u4(frame, POS_CFG + ofs)
        self.cfg[subcnt1] = cfg32
        if subcnt1 == 0xC:
            if cfg32 != self.snC and self.snC > 0:
                self.snD = 0
                self.gps_cnt = 0
                self.week = 0
                self.yr = 0
            self.snC = cfg32
        elif subcnt1 == 0xD:
            if cfg32 != self.snD and self.snD > 0:
                self.snC = 0
                self.gps_cnt = 0
                self.week = 0
                self.yr = 0
            self.snD = cfg32
        elif subcnt1 == 0xF:
            self.yr = 2000 + cfg32 % 100
            cfg32 //= 100
            self.mth = cfg32 % 100
            self.day = cfg32 // 100

    # ---- position + JSON (mp3h1mod.c:344-436,630-781) ----

    def _get_position(self, frame, ofs):
        hrs, mins, sec = (int(frame[POS_TIME]), int(frame[POS_TIME + 1]),
                          int(frame[POS_TIME + 2]))
        self.gps_cnt_prev = self.gps_cnt
        self.sec_day_prev = self.sec_day
        self.sec_day = hrs * 3600 + mins * 60 + sec
        if self.yr == 0:
            week, tow = 0, self.sec_day
        else:
            week, tow = datetime2gpsweek(self.yr, self.mth, self.day,
                                         hrs, mins, sec)
        sec_gps = week * 604800 + tow
        self.week = week
        if sec_gps > self.gps_cnt_prev:
            self.gps_cnt = sec_gps

        if ofs == 0:
            X = [_i4(frame, POS_ECEF_X + 4 * k) / 100.0 for k in range(3)]
            V = [_i2(frame, POS_ECEF_V + 2 * k) / 100.0 for k in range(3)]
            lat, lon, alt = ecef_to_geodetic(*X)
            if not (-1000.0 <= alt <= 80000.0):
                return None
            vH, vD, vU = ecef_vel_to_hdv(V[0], V[1], V[2], lat, lon)
            nsats = int(frame[POS_NSATS])
        else:
            lat = _i4(frame, 7) * 1e-6
            lon = _i4(frame, 11) * 1e-6
            alt = _i4(frame, 15) * 1e-2
            if not (-1000.0 <= alt <= 80000.0):
                return None
            vH = _i2(frame, 19) / 100.0
            vD = _u2(frame, 21) / 100.0
            vU = 0.0
            nsats = int(frame[POS_NSATS - 3])

        T = _i2(frame, POS_T16 + ofs) / 100.0
        RH = _i2(frame, POS_H16 + ofs) / 100.0

        if not (self.week > 0 and self.gps_cnt > self.gps_cnt_prev
                and self.snC > 0 and self.snD > 0):
            return None
        if (self.gps_cnt - self.gps_cnt_prev > TIMEOUT_JSN
                and self.gps_cnt_prev > self.sec_day_prev):
            self.reset_cfg()
            return None

        telem = {
            "type": "MRZ",
            "frame": self.gps_cnt,
            "id": f"MRZ-{self.snC}-{self.snD}",
            "datetime": (f"{self.yr:04d}-{self.mth:02d}-{self.day:02d}"
                         f"T{hrs:02d}:{mins:02d}:{sec:02d}Z"),
            "lat": round(lat, 5),
            "lon": round(lon, 5),
            "alt": round(alt, 5),
            "vel_h": round(vH, 5),
            "heading": round(vD, 5),
            "sats": nsats,
            "ref_datetime": "UTC",
            "ref_position": "GPS" if ofs == 0 else "MSL",
        }
        if ofs == 0:
            telem["vel_v"] = round(vU, 5)
        if T > -273.0:
            telem["temp"] = round(T, 1)
        if RH > -0.5:
            telem["humidity"] = round(RH, 1)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem


# --------------------------------------------------------------------------- #
# encoder fixture
# --------------------------------------------------------------------------- #

def encode_frame(cnt1, hrs, mins, sec, lat, lon, alt, vH=5.0, vD=90.0,
                 vU=-3.0, nsats=9, T=-20.5, RH=55.0, cfg32=0):
    """Build one valid ECEF-mode MRZ frame (51 bytes incl. AA AA trailer)."""
    frame = np.zeros(FRAME_LEN, dtype=np.uint8)
    frame[0], frame[1], frame[2] = 0xAA, 0xBF, 0x35
    frame[POS_CNT1] = 0x80 | (cnt1 & 0xF)
    frame[POS_TIME:POS_TIME + 3] = (hrs, mins, sec)
    X, Y, Z = geodetic_to_ecef(lat, lon, alt)
    vx, vy, vz = hdv_to_ecef_vel(vH, vD, vU, lat, lon)
    for k, val in enumerate((X, Y, Z)):
        v = int(round(val * 100)) & 0xFFFFFFFF
        for i in range(4):
            frame[POS_ECEF_X + 4 * k + i] = (v >> (8 * i)) & 0xFF
    for k, val in enumerate((vx, vy, vz)):
        v = int(round(val * 100)) & 0xFFFF
        frame[POS_ECEF_V + 2 * k] = v & 0xFF
        frame[POS_ECEF_V + 2 * k + 1] = (v >> 8) & 0xFF
    frame[POS_NSATS] = nsats
    tv = int(round(T * 100)) & 0xFFFF
    frame[POS_T16], frame[POS_T16 + 1] = tv & 0xFF, (tv >> 8) & 0xFF
    hv = int(round(RH * 100)) & 0xFFFF
    frame[POS_H16], frame[POS_H16 + 1] = hv & 0xFF, (hv >> 8) & 0xFF
    frame[POS_FFFF], frame[POS_FFFF + 1] = 0xFF, 0xFF
    frame[POS_CNT2] = (cnt1 & 0xF) + 1
    for i in range(4):
        frame[POS_CFG + i] = (cfg32 >> (8 * i)) & 0xFF
    crc = crc16_rev(frame[POS_CNT1:POS_CNT1 + CRCLEN_ECEF])
    frame[CRCLEN_ECEF + 3] = crc & 0xFF
    frame[CRCLEN_ECEF + 4] = (crc >> 8) & 0xFF
    frame[CRCLEN_ECEF + 5] = 0xAA
    return frame


def frame_to_raw_bits(frame):
    """Frame bytes -> raw Manchester1 stream.

    The frame's first two bytes (AA BF) overlap the header: the decoded
    header supplies bits 0..21, so on air only bits 22.. are sent — two
    '1' bits completing 0xBF, then the bytes from 0x35 onward."""
    bits = ((frame[:, None] >> np.arange(7, -1, -1)[None, :]) & 1
            ).reshape(-1).astype(np.uint8)
    tx_bits = np.concatenate(
        [np.array([1, 1], dtype=np.uint8), bits[16:]])
    # Manchester1: bit b -> (b, 1-b); decoder reads complement of 2nd bit
    raw = np.empty(2 * len(tx_bits), dtype=np.uint8)
    raw[0::2] = tx_bits
    raw[1::2] = 1 - tx_bits
    hdr = np.array([int(c) for c in HEADER], dtype=np.uint8)
    return np.concatenate([hdr, raw])


def encode_flight_bits(snC=30112, snD=21055, date=(2021, 6, 15),
                       lat=55.75, lon=37.62, alt=15000.0, n_frames=8):
    """Raw bit stream: frames cycling cfg channels incl. snC/snD/date."""
    yy, mm, dd = date
    date32 = ((dd * 100) + mm) * 100 + (yy % 100)
    cfgs = [(0xC, snC), (0xD, snD), (0xF, date32), (0x0, 0x3F800000)]
    streams = []
    for i in range(n_frames):
        cid, cval = cfgs[i % len(cfgs)]
        f = encode_frame(cid, 12, 30, i, lat, lon, alt, cfg32=cval)
        streams.append(frame_to_raw_bits(f))
        streams.append(np.zeros(20, dtype=np.uint8))
    return np.concatenate(streams)
