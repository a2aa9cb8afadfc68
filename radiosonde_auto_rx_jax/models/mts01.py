"""Meteosis MTS01 frame codec (1200 Bd NRZ, ASCII CSV payload, CRC16).

Frame structure per the reference decoder (reference demod/mod/mts01mod.c):
32-bit raw header AA AA B4 2B (:49-51); frame = 1 pad byte (0x80) + 128
ASCII bytes + CRC16 little-endian (:52-56,160-162); CRC16 poly 0x8005 init
0xFFFF with bit-reversed result (:76-99); payload = comma-separated fields:
ID, ?, frame number, datetime YYMMDDHHMMSS, battery mV, lat, lon, alt,
heading, vH, ?, rawT, rawT, rawRH (:192-237); thermistor approximation
B=3000K, T0=0C, R0=15 (:139-148); JSON output (:251-274).
"""

import numpy as np

from radiosonde_auto_rx_jax.models import register
from radiosonde_auto_rx_jax.demod.framing import find_frame_starts

HEADER = "10101010" "10101010" "10110100" "00101011"
BAUD = 1200
OFS = 1
DATLEN = 128
FRAMELEN = 130 + OFS


def crc16_re(data):
    """CRC16 0x8005 init 0xFFFF, result bit-reversed (mts01mod.c:76-99)."""
    rem = 0xFFFF
    for byte in data:
        rem ^= int(byte) << 8
        for _ in range(8):
            rem = ((rem << 1) ^ 0x8005 if rem & 0x8000 else rem << 1) \
                & 0xFFFF
    re = 0
    for j in range(16):
        if rem & (1 << (15 - j)):
            re |= 1 << j
    return re


def get_temp(R):
    """NTC approximation (mts01mod.c:139-148)."""
    if R <= 0:
        return -273.15
    B0, T0, R0 = 3000.0, 273.15, 15.0
    return 1.0 / (1.0 / T0 + np.log(R / R0) / B0) - 273.15


@register("MTS01")
class MTS01Decoder:
    """MTS01 frame decoder: NRZ bit stream -> telemetry."""

    HEADER = HEADER

    def __init__(self, jsn_freq_khz: int = 0):
        self.jsn_freq_khz = jsn_freq_khz

    def decode_bits(self, bits, soft=None):
        bits = np.asarray(bits, dtype=np.uint8)
        out = []
        for inv in (False, True):
            hdr = HEADER if not inv else "".join(
                "1" if c == "0" else "0" for c in HEADER)
            for s in find_frame_starts(bits, hdr, max_errors=2):
                seg = bits[s:s + 8 * FRAMELEN]
                if inv:
                    seg = seg ^ 1
                if len(seg) < 8 * FRAMELEN:
                    continue
                frame = (seg.reshape(-1, 8) <<
                         np.arange(7, -1, -1)[None, :]).sum(axis=1
                                                            ).astype(np.uint8)
                t = self.decode_frame(frame)
                if t:
                    out.append(t)
        return out

    def decode_frame(self, frame):
        crcdat = (int(frame[OFS + DATLEN + 1]) << 8) | \
            int(frame[OFS + DATLEN])
        if crcdat != crc16_re(frame[OFS:OFS + DATLEN]):
            return None
        data = bytes(frame[OFS:OFS + DATLEN])
        fields = data.split(b",")
        try:
            sid = fields[0].decode("ascii").strip("\x00")
            frnr = int(fields[2])
            dtd = fields[3].decode("ascii")
            year, month, day = 2000 + int(dtd[0:2]), int(dtd[2:4]), \
                int(dtd[4:6])
            hrs, mins, sec = int(dtd[6:8]), int(dtd[8:10]), int(dtd[10:12])
            batt = float(fields[4])
            lat = float(fields[5])
            lon = float(fields[6])
            alt = float(fields[7])
            vD = float(fields[8])
            vH = float(fields[9])
            rawT = float(fields[11])
        except (IndexError, ValueError, UnicodeDecodeError):
            return None
        T = get_temp(rawT)
        telem = {
            "type": "MTS01",
            "frame": frnr,
            "id": f"MTS01-{sid}",
            "datetime": (f"{year:04d}-{month:02d}-{day:02d}"
                         f"T{hrs:02d}:{mins:02d}:{float(sec):06.3f}Z"),
            "lat": round(lat, 5),
            "lon": round(lon, 5),
            "alt": round(alt, 5),
            "vel_h": round(vH, 5),
            "heading": round(vD, 5),
            "batt": round(batt / 1000.0, 2),
            "ref_datetime": "UTC",
            "ref_position": "MSL",
        }
        if T > -270.0:
            telem["temp"] = round(float(T), 1)
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem


# --------------------------------------------------------------------------- #
# encoder fixture
# --------------------------------------------------------------------------- #

def encode_frame(sid="T1234567", frnr=321, date=(2023, 5, 17),
                 time=(10, 45, 30), batt_mv=2900, lat=46.2044, lon=6.1432,
                 alt=2345.0, heading=270.5, vel_h=12.3, rawT=12.5,
                 rawRH=40.0):
    yy, mm, dd = date
    hh, mi, ss = time
    csv = (f"{sid},X,{frnr},{yy % 100:02d}{mm:02d}{dd:02d}"
           f"{hh:02d}{mi:02d}{ss:02d},{batt_mv},{lat:.6f},{lon:.6f},"
           f"{alt:.1f},{heading:.1f},{vel_h:.1f},0,{rawT:.2f},{rawT:.2f},"
           f"{rawRH:.1f}")
    payload = csv.encode("ascii")
    assert len(payload) <= DATLEN
    # pad with clock-rich printable filler, not NULs: 40+ zero bytes of
    # constant tone starve the demod's symbol-clock tracking (the real
    # sonde's CSV fills most of the 128-byte field).  'U' = 0x55 keeps
    # bit-rate alternation; both parsers only read the CSV fields before
    # the pad.
    data = payload + b"U" * (DATLEN - len(payload))
    frame = np.zeros(FRAMELEN, dtype=np.uint8)
    frame[0] = 0x80
    frame[OFS:OFS + DATLEN] = np.frombuffer(data, np.uint8)
    crc = crc16_re(frame[OFS:OFS + DATLEN])
    frame[OFS + DATLEN] = crc & 0xFF
    frame[OFS + DATLEN + 1] = (crc >> 8) & 0xFF
    return frame


def frame_to_bits(frame):
    hdr = np.array([int(c) for c in HEADER], dtype=np.uint8)
    bits = ((frame[:, None] >> np.arange(7, -1, -1)[None, :]) & 1
            ).reshape(-1).astype(np.uint8)
    return np.concatenate([hdr, bits])
