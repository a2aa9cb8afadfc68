"""Lockheed LMS6-403 frame codec (4.8 kBd, conv K=7 r=1/2 + RS CCSDS).

Frame structure per the reference decoder (reference
demod/mod/lms6Xmod.c): on-air raw pairs are (c0, inv(c1)) — the decoder
re-inverts odd raw bits (:1411-1413); 80-raw-bit CCSDS block sync
(00 58 F3 3F B8 conv-encoded, :101-113); per-block Viterbi/algebraic
deconvolution (:208-377) then little-endian byte packing (:415-441);
RS(255,223) CCSDS over block bytes 5..259 in reversed order (:698-711,
:880-884); 223-byte frames located by sync 24 54 00 00/05, may straddle
blocks (:800-827,886-920); CRC16 0x1021 init 0 over frame[0..220]
(:380-409); field layout SN/frnr/TOW/lat-lon(B60B60)/alt/vel24-ENU
(:445-661); LMS-X variant (typ 10) with float64 TOW + HDV velocities;
JSON output (:762-795).  Implementation (numpy + encoder fixture) is new.
"""

import numpy as np

from radiosonde_auto_rx_jax.models import register
from radiosonde_auto_rx_jax.demod.framing import find_frame_starts
from radiosonde_auto_rx_jax.ecc.rs import RS255_223_CCSDS
from radiosonde_auto_rx_jax.ecc.viterbi import conv_encode, viterbi_decode

BAUD = 4800
SYNC_LEN = 5
FRM_LEN = 223
BLOCK_LEN = FRM_LEN + 32 + SYNC_LEN          # 260 bytes
RAWBITBLOCK_LEN_6 = (BLOCK_LEN + 1) * 8 * 2  # raw bits per block (+1 tail)
BLOCKSTART = SYNC_LEN * 8 * 2                # 80 raw bits of sync

RS_SYNC = np.array([0x00, 0x58, 0xF3, 0x3F, 0xB8], dtype=np.uint8)
FRM_SYNC6 = np.array([0x24, 0x54, 0x00, 0x00], dtype=np.uint8)

OFS = 4
B60B60 = (1 << 30) / 90.0


def _sync_raw_bits():
    """Conv-encoded block sync = the reference's blk_syncbits (80 bits)."""
    bits = bytes_to_bits_le(RS_SYNC)
    return conv_encode(bits)


from radiosonde_auto_rx_jax.demod.framing import (  # noqa: E402
    bits_to_bytes_le, bytes_to_bits_le)


BLK_SYNCBITS = _sync_raw_bits()
# on-air header: raw bits 16..80 of the sync with every odd bit inverted
_hdr = BLK_SYNCBITS[16:80].copy()
_hdr[1::2] ^= 1
RAW_HEADER = "".join(str(b) for b in _hdr)


def crc16_0(data):
    """CRC16 0x1021 init 0 (lms6Xmod.c:380-398)."""
    rem = 0
    for byte in data:
        rem ^= int(byte) << 8
        for _ in range(8):
            rem = ((rem << 1) ^ 0x1021 if rem & 0x8000 else rem << 1) \
                & 0xFFFF
    return rem


@register("LMS6")
class LMS6Decoder:
    """Stateful LMS6-403 decoder: on-air raw bit stream -> telemetry.

    Frames may straddle RS blocks; ``frm_buf`` carries the partial frame.
    """

    HEADER = RAW_HEADER

    def __init__(self, jsn_freq_khz: int = 0, week: int = 0):
        self.jsn_freq_khz = jsn_freq_khz
        self.week = week
        self.frm_buf = None
        self.typ = 6

    def decode_bits(self, raw_bits, soft=None):
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        out = []
        nraw = RAWBITBLOCK_LEN_6 - BLOCKSTART
        for inv in (False, True):
            hdr = RAW_HEADER if not inv else "".join(
                "1" if c == "0" else "0" for c in RAW_HEADER)
            starts = find_frame_starts(raw_bits, hdr, max_errors=10)
            if len(starts) and inv:
                raw_bits = raw_bits ^ 1
            for s in starts:
                raw = raw_bits[s:s + nraw].copy()
                if len(raw) < nraw // 2:
                    continue
                sft = None
                if soft is not None:
                    sft = soft[s:s + nraw].copy()
                    if inv:
                        sft = -sft
                out.extend(self.decode_block_raw(raw, sft))
            if len(starts):
                break
        return out

    def decode_block_raw(self, raw, soft=None):
        """Raw on-air bits after the 64-bit header -> telemetry list."""
        # undo the on-air inversion of c1 (odd raw bits); stream position
        # after the header is raw index 80 (even), so parity holds
        if soft is None:
            soft = raw.astype(np.float64) * 2.0 - 1.0
        soft = soft.copy()
        soft[1::2] = -soft[1::2]
        full = np.concatenate([BLK_SYNCBITS.astype(np.float64) * 2 - 1,
                               soft])
        data_bits = viterbi_decode(full)
        block = bits_to_bytes_le(data_bits)
        return self.process_block(block)

    def process_block(self, block):
        out = []
        if len(block) < SYNC_LEN + 255:
            block = np.concatenate(
                [block, np.zeros(SYNC_LEN + 255 - len(block), np.uint8)])
        # RS(255,223): block[5+j] = cw[254-j]
        cw = block[SYNC_LEN:SYNC_LEN + 255][::-1].astype(np.int64).copy()
        n_err = RS255_223_CCSDS.decode(cw)
        if n_err >= 0:
            block = block.copy()
            block[SYNC_LEN:SYNC_LEN + 255] = cw[::-1].astype(np.uint8)

        pos = SYNC_LEN
        data_end = SYNC_LEN + FRM_LEN
        while pos < data_end:
            if self.frm_buf is None:
                # search frame sync 24 54 00 00/05
                while pos < data_end:
                    w = block[pos:pos + 4]
                    if len(w) == 4 and w[0] == 0x24 and w[1] == 0x54 and \
                            w[2] == 0x00 and w[3] in (0x00, 0x05):
                        self.frm_buf = []
                        break
                    pos += 1
                if self.frm_buf is None:
                    break
            take = min(FRM_LEN - len(self.frm_buf), data_end - pos)
            self.frm_buf.extend(block[pos:pos + take])
            pos += take
            if len(self.frm_buf) == FRM_LEN:
                frame = np.asarray(self.frm_buf, dtype=np.uint8)
                self.frm_buf = None
                t = self.decode_frame(frame)
                if t:
                    out.append(t)
        return out

    def decode_frame(self, frame):
        crcdat = (int(frame[221]) << 8) | int(frame[222])
        if crcdat != crc16_0(frame[:221]):
            return None
        if frame[0] == 0 or frame[OFS + 1] == 0:
            return None
        sn = ((int(frame[OFS]) << 24) | (int(frame[OFS + 1]) << 16) |
              (int(frame[OFS + 2]) << 8) | int(frame[OFS + 3])) & 0xFFFFFF
        frnr = (int(frame[OFS + 4]) << 8) | int(frame[OFS + 5])

        def be(p, n):
            v = 0
            for i in range(n):
                v = (v << 8) | int(frame[p + i])
            return v

        def sbe(p, n):
            v = be(p, n)
            return v - (1 << (8 * n)) if v & (1 << (8 * n - 1)) else v

        tow_ms = be(OFS + 0x06, 4)
        gpssec = tow_ms // 1000
        day = gpssec // 86400
        if not (0 <= day <= 6):
            return None
        std = (gpssec % 86400) // 3600
        minute = (gpssec % 3600) // 60
        sek = gpssec % 60 + (tow_ms % 1000) / 1000.0

        lat = sbe(OFS + 0x0E, 4) / B60B60
        lon = sbe(OFS + 0x12, 4) / B60B60
        alt = sbe(OFS + 0x16, 4) / 1000.0
        if not (-200 <= alt <= 60000):
            return None
        vx = sbe(OFS + 0x1A, 3) / 1e3
        vy = sbe(OFS + 0x1D, 3) / 1e3
        vz = sbe(OFS + 0x20, 3) / 1e3
        vH = float(np.hypot(vx, vy))
        vD = float(np.degrees(np.arctan2(vx, vy)) % 360.0)

        telem = {
            "type": "LMS",
            "frame": frnr,
            "id": f"LMS6-{sn}",
            "datetime": f"{std:02d}:{minute:02d}:{sek:06.3f}Z",
            "lat": round(lat, 5),
            "lon": round(lon, 5),
            "alt": round(alt, 5),
            "vel_h": round(vH, 5),
            "heading": round(vD, 5),
            "vel_v": round(vz, 5),
            "gpstow": tow_ms,
            "subtype": "LMS6-403",
            "ref_datetime": "GPS",
            "ref_position": "GPS",
        }
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        return telem


# --------------------------------------------------------------------------- #
# encoder fixture
# --------------------------------------------------------------------------- #

def encode_frame(sn=7123456 & 0xFFFFFF, frnr=1234, tow_ms=210600500,
                 lat=44.5, lon=-72.6, alt=16000.0, vE=12.0, vN=-5.0,
                 vU=3.2, fill_seed=None):
    frame = np.zeros(FRM_LEN, dtype=np.uint8)
    if fill_seed is not None:
        # realistic bit entropy in the unparsed payload region (the real
        # sonde sends sensor/aux data there; all-zero frames make a
        # degenerate FSK spectrum)
        rng = np.random.default_rng(fill_seed)
        frame[0x28:221] = rng.integers(0, 256, 221 - 0x28, dtype=np.uint8)
    frame[0:4] = FRM_SYNC6

    def put(p, v, n):
        v &= (1 << (8 * n)) - 1
        for i in range(n):
            frame[p + i] = (v >> (8 * (n - 1 - i))) & 0xFF

    put(OFS, sn | 0x7A000000 & 0, 4)
    frame[OFS] = 0x00
    frame[OFS + 1] = (sn >> 16) & 0xFF
    frame[OFS + 2] = (sn >> 8) & 0xFF
    frame[OFS + 3] = sn & 0xFF
    put(OFS + 4, frnr, 2)
    put(OFS + 0x06, tow_ms, 4)
    put(OFS + 0x0E, int(round(lat * B60B60)), 4)
    put(OFS + 0x12, int(round(lon * B60B60)), 4)
    put(OFS + 0x16, int(round(alt * 1000)), 4)
    put(OFS + 0x1A, int(round(vE * 1e3)), 3)
    put(OFS + 0x1D, int(round(vN * 1e3)), 3)
    put(OFS + 0x20, int(round(vU * 1e3)), 3)
    crc = crc16_0(frame[:221])
    frame[221] = (crc >> 8) & 0xFF
    frame[222] = crc & 0xFF
    return frame


def encode_block(frame):
    """223 data bytes -> 260-byte block (sync + RS codeword)."""
    msg = frame[::-1].astype(np.int64)       # msg[j] = cw[32+j]
    cw = RS255_223_CCSDS.encode(msg)
    block = np.zeros(BLOCK_LEN, dtype=np.uint8)
    block[:SYNC_LEN] = RS_SYNC
    for j in range(255):
        block[SYNC_LEN + j] = cw[254 - j]
    return block


def blocks_to_raw_bits(blocks):
    """Block byte list -> continuous on-air raw stream (c0, inv(c1))."""
    data = np.concatenate([bytes_to_bits_le(b) for b in blocks])
    raw = conv_encode(data)
    raw = raw.copy()
    raw[1::2] ^= 1
    return raw
