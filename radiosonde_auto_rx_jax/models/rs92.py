"""Vaisala RS92-SGP frame codec + raw-pseudorange GPS navigation.

Frame structure and telemetry semantics follow the on-air protocol as
documented by the reference decoder (reference demod/mod/rs92mod.c):
4800 Bd, 8N1 bytes Manchester2-coded (decoded bit = 2nd raw bit,
:180-196,2012-2043), 240-byte frame with 6 header bytes (:81-95);
sub-blocks tagged 0x6510/0x690C/0x673D/0x6805 each followed by data and
CRC16-CCITT (:263-295); frame number/SondeID/cal counter (:244-247),
calibration f32 records idx+LE-float at calibytes[0x40+5j] (:507-526),
SGP/NGP discrimination via the constant cal block at 0x170 (:339-365);
PTU evaluation nu()/poly5() (:553-566,567-630); GPS block: TOW ms,
12x5-bit PRNs with PRN-32 overflow bits (:777-812), 12 status bytes,
12x(u32 chips, s24 deltachips) pseudoranges (:960-1105); RS(255,231)
parity over frame[6:216] stored at frame[216:240] with parity-first
codeword layout (:1356-1385); JSON output fields (:1492-1536).
Navigation: best-GDOP 4-satellite least-squares position + linearized
velocity from pseudorange rates (:1122-1320, nav_gps_vel.c NAV_LinV
:1801-1880) via radiosonde_auto_rx_jax.station.gps_ephem.
Implementation (numpy + encoder fixture) is new.
"""

import itertools

import numpy as np

from radiosonde_auto_rx_jax.models import register
from radiosonde_auto_rx_jax.demod.framing import find_frame_starts
from radiosonde_auto_rx_jax.ecc.rs import RS255_231
from radiosonde_auto_rx_jax.ecc.crc import crc16_ccitt
from radiosonde_auto_rx_jax.station import gps_ephem

# raw (Manchester-level) header: last 3 of the 6 header bytes
HEADER = ("10100110011001101001"
          "1010011001100110100110101010100110101001")
BAUD = 4800
FRAME_LEN = 240
FRAMESTART = 6
HEADER_BYTES = (0x2A, 0x2A, 0x2A, 0x2A, 0x2A, 0x10)

POS_FRAMENB = 0x08     # u16 LE
POS_SONDEID = 0x0C     # 8 ASCII bytes
POS_CALDATA = 0x17     # cal counter byte; 16 data bytes follow
POS_CALFREQ = 0x1A     # u16 LE inside cal frame 0
POS_PTU = 0x2C         # 24 bytes: 8 x u24 LE measurement channels
POS_GPS_TOW = 0x48     # u32 LE, ms
POS_GPS_PRN = 0x4E     # 12 x 5 bit in 4 u16 LE words
POS_GPS_STATUS = 0x56  # 12 bytes
POS_GPS_DATA = 0x62    # 12 x 8 bytes (u32 chips, u24 deltachips, pad)
POS_AUX = 0xC6         # 10 bytes (2 + 4 x u16 aux)
POS_AUXDATA = 0xC8

LEN_CFG, LEN_PTU, LEN_GPS, LEN_AUX = 0x20, 0x18, 0x7A, 0x0A
BLOCK_TAGS = {0x06: 0x6510, 0x2A: 0x690C, 0x46: 0x673D, 0xC4: 0x6805}
RS_R = 24
MSG_LEN = 210          # frame[6:216] protected by RS(255,231)

CRC_FRAME, CRC_PTU, CRC_GPS, CRC_AUX = 1, 2, 4, 8

# pseudorange scale: meters per chip unit (rs92mod.c:968-971)
DF = 299792.458 / 1023.0 / 1024.0
DL = 1575.42 / 1.023 / 4.0
PR_OFS = 20e6
DOP_LIMIT = 9.9

# constant SGP calibration block at calibytes[0x170] (rs92mod.c:339-340)
CALX170 = bytes((0x36, 0x98, 0x92, 0x25, 0x6B, 0xB3, 0x99, 0xE1,
                 0x57, 0x05, 0x30, 0x9A, 0xFE, 0x51, 0xF4, 0xAB))

_M32 = 0xFFFFFFFF


def xor_ptu_key(calibytes):
    """16-byte PTU descrambling keystream for RS92-NGP, derived from the
    (unscrambled) cal bytes at 0x24 by the reference's add/shift/xor hash
    (rs92mod.c xor_ptu :367-419)."""
    pcal = np.asarray(calibytes[0x24:0x24 + 11], dtype=np.int64)
    key = np.zeros(16, dtype=np.uint8)
    for j in range(8):
        a = 0x1D89
        for k in range(4):
            c = a
            a = (int(pcal[j + k]) + c) & _M32
            c = a
            a = ((a << 10) + c) & _M32
            c = a
            a = ((a >> 6) ^ c) & _M32
        c = a
        a = ((a << 3) + c) & _M32
        c = a
        a = ((a >> 11) ^ c) & _M32
        c = a
        a = ((a << 15) + c) & _M32
        key[2 * j] = a & 0xFF
        key[2 * j + 1] = (a >> 8) & 0xFF
    return key


def xcal_key(calibytes):
    """16-byte cal descrambling keystream for RS92-NGP: the raw cal block
    at 0x170 XORed against the known SGP constant, with the NGP float
    byte-order permutation folded in (rs92mod.c:481-502)."""
    p = np.asarray(calibytes[0x170:0x180], dtype=np.uint8)
    q = np.frombuffer(CALX170, dtype=np.uint8)
    key = np.zeros(16, dtype=np.uint8)
    for k in range(3):
        key[5 * k] = p[5 * k] ^ q[5 * k]
        key[5 * k + 1] = p[5 * k + 1] ^ q[5 * k + 1]
        key[5 * k + 3] = p[5 * k + 3] ^ q[5 * k + 2]
        key[5 * k + 4] = p[5 * k + 4] ^ q[5 * k + 3]
        key[5 * k + 2] = p[5 * k + 2] ^ q[5 * k + 4]
    key[15] = p[15] ^ q[15]
    return key


def gps_to_date(week, gpssec):
    """GPS week + seconds -> (year, month, day) (rs92mod.c:218-236)."""
    mjd = 44244 + week * 7 + int(gpssec) // 86400
    j = mjd + 2468570
    c = 4 * j // 146097
    j -= (146097 * c + 3) // 4
    y = 4000 * (j + 1) // 1461001
    j = j - 1461 * y // 4 + 31
    m = 80 * j // 2447
    day = j - 2447 * m // 80
    j = m // 11
    month = m + 2 - 12 * j
    year = 100 * (c - 49) + y + j
    return year, month, day


def _u2(f, p):
    return int(f[p]) | (int(f[p + 1]) << 8)


def _u4(f, p):
    return (int(f[p]) | (int(f[p + 1]) << 8) | (int(f[p + 2]) << 16)
            | (int(f[p + 3]) << 24))


def _poly5(x, a):
    return ((((a[5] * x + a[4]) * x + a[3]) * x + a[2]) * x + a[1]) * x + a[0]


def _nu(t, t0, y0):
    """Measurement scaling 1/(y0 - t/t0) (rs92mod.c:563-566)."""
    if t0 == 0.0:
        return 0.0
    den = y0 - t / t0
    return 1.0 / den if den != 0.0 else 0.0


def unpack_prns(frame, prn32toggle: int = 0x1):
    """12 PRNs from 4 u16 LE words, 15+1-bit layout (rs92mod.c:777-812).

    Returns (prns, status, prn32toggle').  ``prn32toggle`` is the
    persistent PRN-32 follower state (rs92mod.c:812-842): when slot i
    holds PRN 32 (columns 0/1), the overflow flag that marks it is the
    LSB of the NEXT slot's 5-bit field, so the next slot's PRN is
    transmitted with its LSB borrowed.  The decoder keeps a one-bit
    guess of that borrow, flipping it whenever the corrected PRN would
    collide with another tracked PRN in the same frame, and XORs it
    into the following slot.  Without this, a frame tracking PRN 32
    pairs the next slot's pseudorange with the wrong satellite.
    """
    prn_le = np.zeros(64, dtype=np.uint8)
    for blk in range(4):
        w = _u2(frame, POS_GPS_PRN + 2 * blk)
        for i in range(15):
            prn_le[15 * blk + i] = (w >> i) & 1
        prn_le[60 + blk] = (w >> 15) & 1
    status = frame[POS_GPS_STATUS:POS_GPS_STATUS + 12]
    prns = np.zeros(12, dtype=np.int64)
    for i in range(12):
        prns[i] = int((prn_le[5 * i:5 * i + 5]
                       << np.arange(5)).sum())
    ind_prn32 = 32
    for i in range(12):
        if prns[i] == 0 and (int(status[i]) & 0x0F):
            # PRN-32 stored as 0 with the per-column overflow bit set
            if ((i % 3 == 2 and prn_le[60 + i // 3])
                    or (i % 3 != 2 and prn_le[5 * (i + 1)])):
                prns[i] = 32
                ind_prn32 = i
        elif (int(status[i]) & 0x0F) == 0:
            prns[i] = 0
    if ind_prn32 < 11 and ind_prn32 % 3 != 2:
        nxt = ind_prn32 + 1
        if (int(status[nxt]) & 0x0F) and prns[nxt] > 1:
            others = [j for j in range(12)
                      if j not in (ind_prn32, nxt)
                      and (int(status[j]) & 0x0F)]
            if any(prns[j] == (prns[nxt] ^ prn32toggle) for j in others):
                prn32toggle ^= 0x1
            prns[nxt] ^= prn32toggle
    return prns, status, prn32toggle


def pack_prns(frame, prns, status):
    """Inverse of unpack_prns for the encoder fixture (PRNs < 32)."""
    prn_le = np.zeros(64, dtype=np.uint8)
    for i in range(12):
        for j in range(5):
            prn_le[5 * i + j] = (int(prns[i]) >> j) & 1
    for blk in range(4):
        w = 0
        for i in range(15):
            w |= int(prn_le[15 * blk + i]) << i
        w |= int(prn_le[60 + blk]) << 15
        frame[POS_GPS_PRN + 2 * blk] = w & 0xFF
        frame[POS_GPS_PRN + 2 * blk + 1] = w >> 8
    frame[POS_GPS_STATUS:POS_GPS_STATUS + 12] = status


@register("RS92")
class RS92Decoder:
    """Stateful RS92-SGP decoder: raw Manchester bit stream -> telemetry.

    ``ephemeris`` is a path to a RINEX-2 GPS navigation file or a list of
    :class:`gps_ephem.Ephemeris`; without it frames are parsed but no
    position can be solved (same as the reference rs92mod without -e/-a).
    """

    HEADER = HEADER

    def __init__(self, jsn_freq_khz: int = 0, ephemeris=None,
                 ngp: bool = False):
        self.jsn_freq_khz = jsn_freq_khz
        if isinstance(ephemeris, str):
            self.ephs = gps_ephem.read_rinex_nav(ephemeris)
        else:
            self.ephs = list(ephemeris) if ephemeris else []
        self.id = ""
        # RS92-NGP (1680 MHz): cal + PTU scrambled; auto-toggled from the
        # cal constant at 0x170 once cal completes (rs92mod.c
        # chk_toggle_type :342-365)
        self.ngp = bool(ngp)
        self._reset_cal()
        self.freq_khz = 0

    def _reset_cal(self):
        self.calibytes = np.zeros(32 * 16, dtype=np.uint8)
        self.calfrchk = np.zeros(32, dtype=bool)
        self.cal_f32 = np.zeros(256, dtype=np.float32)
        self.cal_complete = False
        self.xptu16 = np.zeros(16, dtype=np.uint8)
        self._freq_word = None

    # ------------------------------------------------------------------ #
    # bit layer
    # ------------------------------------------------------------------ #

    def decode_bits(self, raw_bits, soft=None):
        """Raw 4800 bd Manchester stream (+ optional soft values with
        positive == raw bit 1) -> telemetry dicts."""
        raw_bits = np.asarray(raw_bits, dtype=np.uint8)
        out = []
        for inv in (False, True):
            hdr = HEADER if not inv else "".join(
                "1" if c == "0" else "0" for c in HEADER)
            for s in find_frame_starts(raw_bits, hdr, max_errors=3):
                n_data = FRAME_LEN - FRAMESTART
                raw = raw_bits[s:s + n_data * 20]
                if inv:
                    raw = raw ^ 1
                if len(raw) < 20:
                    continue
                fsoft = None
                if soft is not None:
                    fsoft = soft[s:s + n_data * 20] * (-1.0 if inv else 1.0)
                t = self.decode_raw_frame(raw, fsoft)
                if t:
                    out.append(t)
        return out

    def decode_raw_frame(self, raw, soft=None):
        """Manchester2 + 8N1 -> frame bytes -> telemetry (or None).

        With soft values, both Manchester symbols are integrated
        (s = s2 - s1, rs92mod.c:2016-2022) instead of slicing only the
        second raw bit -- ~2-3 dB of decode sensitivity."""
        n = len(raw) // 20
        if soft is not None and len(soft) >= n * 20:
            pairs = np.asarray(soft[: n * 20], dtype=np.float64
                               ).reshape(n, 10, 2)
            tenbit = (pairs[:, :, 1] - pairs[:, :, 0] >= 0.0
                      ).astype(np.uint8)
        else:
            tenbit = raw[: n * 20].reshape(n, 10, 2)[:, :, 1]  # 2nd raw bit
        data = (tenbit[:, 1:9] << np.arange(8)[None, :]).sum(axis=1)
        frame = np.zeros(FRAME_LEN, dtype=np.uint8)
        frame[:FRAMESTART] = HEADER_BYTES
        frame[FRAMESTART:FRAMESTART + n] = data.astype(np.uint8)
        return self.decode_frame(frame)

    # ------------------------------------------------------------------ #
    # frame layer
    # ------------------------------------------------------------------ #

    def rs92_ecc(self, frame):
        """In-place RS(255,231) correction (rs92mod.c:1360-1385)."""
        cw = np.zeros(255, dtype=np.int64)
        cw[:RS_R] = frame[FRAME_LEN - RS_R:]
        cw[RS_R:RS_R + MSG_LEN] = frame[FRAMESTART:FRAMESTART + MSG_LEN]
        errs = RS255_231.decode(cw)
        frame[FRAME_LEN - RS_R:] = cw[:RS_R].astype(np.uint8)
        frame[FRAMESTART:FRAMESTART + MSG_LEN] = \
            cw[RS_R:RS_R + MSG_LEN].astype(np.uint8)
        return errs

    def _crc_ok(self, frame, pos, ln):
        return crc16_ccitt(frame[pos:pos + ln]) == _u2(frame, pos + ln)

    def decode_frame(self, frame):
        frame = np.array(frame, dtype=np.uint8)
        ecc = self.rs92_ecc(frame)
        crc = 0
        if not self._crc_ok(frame, POS_FRAMENB, LEN_CFG):
            crc |= CRC_FRAME
        if not self._crc_ok(frame, POS_PTU, LEN_PTU):
            crc |= CRC_PTU
        if not self._crc_ok(frame, POS_GPS_TOW, LEN_GPS):
            crc |= CRC_GPS
        if not self._crc_ok(frame, POS_AUX, LEN_AUX):
            crc |= CRC_AUX

        frnr = _u2(frame, POS_FRAMENB)
        if (crc & CRC_FRAME) == 0:
            self._get_sonde_id(frame)
        # NGP PTU descrambling needs a valid frame number
        # (rs92mod.c get_Meas :570)
        ptu_ok = (crc & CRC_PTU) == 0 and not (
            self.ngp and (crc & CRC_FRAME))
        ptu = self._get_ptu(frame) if ptu_ok else {}
        aux = self._get_aux(frame) if (crc & CRC_AUX) == 0 else None

        if crc & (CRC_FRAME | CRC_GPS) or not self.ephs or not self.id:
            return None

        tow_ms = _u4(frame, POS_GPS_TOW)
        nav = self._solve_gps(frame, tow_ms)
        if nav is None:
            return None
        lat, lon, alt, vH, vD, vU, week = nav

        gpssec = tow_ms // 1000
        yr, mth, day = gps_to_date(week, gpssec)
        sod = gpssec % 86400
        sek = sod % 60 + (tow_ms % 1000) / 1000.0
        telem = {
            "type": "RS92",
            "frame": frnr,
            "id": self.id,
            "datetime": (f"{yr:04d}-{mth:02d}-{day:02d}"
                         f"T{sod // 3600:02d}:{(sod % 3600) // 60:02d}"
                         f":{sek:06.3f}Z"),
            "lat": round(lat, 5),
            "lon": round(lon, 5),
            "alt": round(alt, 5),
            "vel_h": round(vH, 5),
            "heading": round(vD, 5),
            "vel_v": round(vU, 5),
            "subtype": "RS92-NGP" if self.ngp else "RS92-SGP",
            "ref_datetime": "GPS",
            "ref_position": "GPS",
            "ecc": int(ecc),
        }
        telem.update(ptu)
        if aux:
            telem["aux"] = aux
        if self.jsn_freq_khz:
            telem["freq"] = self.jsn_freq_khz
        if self.freq_khz:
            telem["tx_frequency"] = self.freq_khz
        return telem

    # ------------------------------------------------------------------ #
    # config / calibration
    # ------------------------------------------------------------------ #

    def _get_sonde_id(self, frame):
        sid = frame[POS_SONDEID:POS_SONDEID + 8]
        if np.any(sid < 0x20) or np.any(sid > 0x7E):
            return
        sid = bytes(sid).decode("ascii")
        if sid != self.id:
            self._reset_cal()
            self.id = sid
        calfr = int(frame[POS_CALDATA])
        if calfr < 32 and not self.calfrchk[calfr]:
            self.calibytes[calfr * 16:calfr * 16 + 16] = \
                frame[POS_CALDATA + 1:POS_CALDATA + 17]
            self.calfrchk[calfr] = True
        if calfr == 0:
            self._freq_word = _u2(frame, POS_CALFREQ)
        if self._freq_word is not None:
            base = 1600000 if self.ngp else 400000
            self.freq_khz = base + 10 * self._freq_word
        if not self.cal_complete and self.calfrchk.all():
            self.cal_complete = True
            # type auto-toggle: the raw 0x170 block equals the SGP
            # constant only for SGP sondes (rs92mod.c chk_toggle_type)
            self.ngp = bytes(self.calibytes[0x170:0x180]) != CALX170
            if self._freq_word is not None:
                base = 1600000 if self.ngp else 400000
                self.freq_khz = base + 10 * self._freq_word
            xcal = self.calibytes[0x40:0x40 + 66 * 5].copy()
            if self.ngp:
                self.xptu16 = xor_ptu_key(self.calibytes)
                xkey = xcal_key(self.calibytes)
                xcal ^= np.tile(xkey, -(-len(xcal) // 16))[:len(xcal)]
            # 66 records of [idx, f32] starting at 0x40 (rs92mod.c
            # :507-526); NGP float bytes permuted (d1,d2,d0,d3)
            for j in range(66):
                rec = xcal[5 * j:5 * j + 5]
                idx = int(rec[0])
                b = rec[1:5]
                if self.ngp:
                    # xx_dat32 = d1 | d2<<8 | d0<<16 | d3<<24
                    # (rs92mod.c:516-526)
                    b = b[[1, 2, 0, 3]]
                self.cal_f32[idx] = np.frombuffer(bytes(b), dtype="<f4")[0]

    def _get_ptu(self, frame):
        """PTU channels -> T/RH/P via cal polynomials (rs92mod.c:567-630)."""
        if not self.cal_complete:
            return {}
        m = frame[POS_PTU:POS_PTU + 24].astype(np.int64)
        if self.ngp:
            # NGP: meas bytes XORed with the frame-number bytes and the
            # cal-derived keystream (rs92mod.c get_Meas :573-581)
            j = np.arange(24)
            m ^= frame[POS_FRAMENB + (j & 1)].astype(np.int64)
            m ^= self.xptu16[j % 16].astype(np.int64)
        ch = (m[0::3] | (m[1::3] << 8) | (m[2::3] << 16)).astype(np.float64)
        temp, hum1, hum2, ref1, ref2, pres, ref3, ref4 = ch
        cal = self.cal_f32
        out = {}
        x = _nu(ref1 - temp, ref1 - ref4, cal[37])
        T = _poly5(x, cal[30:36])
        if -120.0 < T < 80.0:
            out["temp"] = round(float(T), 1)
        x = _nu(ref1 - hum1, ref1 - ref3, cal[47])
        U1 = _poly5(x, cal[40:46])
        x = _nu(ref1 - hum2, ref1 - ref3, cal[57])
        U2 = _poly5(x, cal[50:56])
        rh = min(max(max(U1, U2), 0.0), 100.0)
        out["humidity"] = round(float(rh), 1)
        x = _nu(ref1 - pres, ref1 - ref4, cal[17])
        P = _poly5(x, cal[10:16])
        if P > 0.0:
            out["pressure"] = round(float(P), 2)
        return out

    def _get_aux(self, frame):
        words = [_u2(frame, POS_AUXDATA + 2 * i) for i in range(4)]
        if not any(words):
            return None
        return "".join(f"{w:04x}" for w in words)

    # ------------------------------------------------------------------ #
    # GPS navigation
    # ------------------------------------------------------------------ #

    def _sat_state(self, prn, t):
        """(pos, clock_corr, vel) for a PRN at GPS seconds t, or None."""
        eph, week, gpsweek = gps_ephem.select_ephemeris(self.ephs, prn, t)
        if eph is None:
            return None
        x0, y0, z0, cl = gps_ephem.sat_position_with_clock(week, t, eph)
        dt = 0.5
        xa = gps_ephem.sat_position(week, t - dt, eph)
        xb = gps_ephem.sat_position(week, t + dt, eph)
        vel = (np.array(xb) - np.array(xa)) / (2 * dt)
        return np.array((x0, y0, z0)), cl, vel, gpsweek

    def _solve_gps(self, frame, tow_ms):
        t = tow_ms / 1000.0
        prns, status, self._prn32toggle = unpack_prns(
            frame, getattr(self, "_prn32toggle", 0x1))
        sats = []     # (prn, pos, clock_corr, vel, chips, deltachips)
        week = None
        seen = set()
        for j in range(12):
            prn = int(prns[j])
            chips = _u4(frame, POS_GPS_DATA + 8 * j)
            # unsigned 24-bit read, matching the reference exactly
            # (rs92mod.c:1035-1040: no sign extension; the receiver's
            # clock drift keeps on-air deltachips positive, and the
            # common rate offset is absorbed by the solver's cc term)
            delta = (int(frame[POS_GPS_DATA + 8 * j + 4])
                     | (int(frame[POS_GPS_DATA + 8 * j + 5]) << 8)
                     | (int(frame[POS_GPS_DATA + 8 * j + 6]) << 16))
            if prn == 0 or prn in seen:
                continue
            if (int(status[j]) & 0x0F) != 0x0F:
                continue
            if chips in (0x7FFFFFFF, 0x55555555):
                continue
            if 0x10000000 < chips < 0xF0000000:
                continue
            st = self._sat_state(prn, t)
            if st is None:
                continue
            pos, cl, vel, gpsweek = st
            if np.linalg.norm(pos) < 6.7e6:
                continue
            week = gpsweek
            chips_s = chips - (1 << 32) if chips & 0x80000000 else chips
            sats.append((prn, pos, cl, vel, chips_s, delta))
            seen.add(prn)
        if len(sats) < 4 or week is None:
            return None

        # PR referenced to the nearest pseudorange (rs92mod.c:1090-1105)
        pranges = np.array([-s[4] * DF + s[2] for s in sats])
        pr = pranges - pranges.min() + PR_OFS
        positions = np.array([s[1] for s in sats])
        prates = np.array([-s[5] * DF / DL for s in sats])
        vels = np.array([s[3] for s in sats])

        # best-GDOP 4-satellite subset (rs92mod.c:1155-1220)
        best = None
        for idx in itertools.combinations(range(len(sats)), 4):
            ii = list(idx)
            pos_ecef, bias = gps_ephem.solve_position(
                positions[ii], pr[ii])
            gdop = gps_ephem.dop(positions[ii], pos_ecef)
            if gdop is None or not np.isfinite(gdop):
                continue
            if best is None or gdop < best[0]:
                best = (gdop, ii, pos_ecef, bias)
        if best is None or best[0] >= DOP_LIMIT:
            return None
        gdop, ii, pos_ecef, bias = best
        lat, lon, alt = gps_ephem.ecef_to_elli(*pos_ecef)
        if not (-1000.0 < alt < 60000.0):
            return None
        vel = gps_ephem.solve_velocity(
            positions[ii], vels[ii], np.zeros(4), pos_ecef, prates[ii])
        vH, vD, vU = _ecef_vel_to_hdv(vel, lat, lon)
        return lat, lon, alt, vH, vD, vU, week


def _ecef_vel_to_hdv(vel, lat, lon):
    """ECEF velocity -> horizontal speed/heading/up (rs92mod.c:1108-1120)."""
    phi, lam = np.radians(lat), np.radians(lon)
    vN = (-vel[0] * np.sin(phi) * np.cos(lam)
          - vel[1] * np.sin(phi) * np.sin(lam) + vel[2] * np.cos(phi))
    vE = -vel[0] * np.sin(lam) + vel[1] * np.cos(lam)
    vU = (vel[0] * np.cos(phi) * np.cos(lam)
          + vel[1] * np.cos(phi) * np.sin(lam) + vel[2] * np.sin(phi))
    vH = float(np.hypot(vN, vE))
    vD = float(np.degrees(np.arctan2(vE, vN))) % 360.0
    return vH, vD, float(vU)


# --------------------------------------------------------------------------- #
# encoder fixture
# --------------------------------------------------------------------------- #

def make_test_ephemeris(n_sats=8, gpsweek=2300, toe=43200.0):
    """Spread-geometry GPS constellation for fixtures (healthy, PRN 1..n)."""
    ephs = []
    for k in range(n_sats):
        e = gps_ephem.Ephemeris()
        e.prn = k + 1
        e.week, e.gpsweek = 1, gpsweek
        e.toe = e.toc = toe
        e.Omega0 = 2 * np.pi * (k % 4) / 4.0 + 0.3
        e.M0 = 2 * np.pi * ((k * 5) % 8) / 8.0 + 0.7 * (k // 4)
        e.w = 0.4 * k
        ephs.append(e)
    return ephs


def default_cal_coeffs():
    """Identity-ish PTU calibration: T = x, RH = x, P = x."""
    cal = {}
    cal[37] = 2.0          # T scaling y0
    cal[31] = 1.0          # T poly: a1 = 1
    cal[47] = 2.0
    cal[41] = 1.0
    cal[57] = 2.0
    cal[51] = 1.0
    cal[17] = 2.0
    cal[11] = 1.0
    return cal


def make_calibytes(cal_coeffs=None, freq_khz=402500, ngp=False,
                   ngp_key=None):
    """32x16 calibration byte array with f32 records + SGP tag block.

    ``ngp=True`` builds an RS92-NGP cal block: records in NGP float byte
    order, the 0x170 constant block in its NGP plaintext arrangement, and
    the whole 0x40.. region XORed with a 16-byte keystream — exactly what
    the decoder's xcal_key/chk_toggle_type machinery expects
    (rs92mod.c:481-526)."""
    cal_coeffs = default_cal_coeffs() if cal_coeffs is None else cal_coeffs
    calibytes = np.zeros(32 * 16, dtype=np.uint8)
    items = sorted(cal_coeffs.items())
    assert len(items) <= 56
    for j, (idx, val) in enumerate(items):
        rec = 0x40 + 5 * j
        calibytes[rec] = idx
        b = np.frombuffer(np.float32(val).tobytes(), dtype=np.uint8)
        if ngp:
            # inverse of the decode permutation (b0..b3 -> d1,d2,d0,d3)
            b = b[[2, 0, 1, 3]]
        calibytes[rec + 1:rec + 5] = b
    for j in range(len(items), 56):
        calibytes[0x40 + 5 * j] = 200  # unused slot
    q = np.frombuffer(CALX170, dtype=np.uint8)
    if ngp:
        # plaintext 0x170 block = sigma-permuted SGP constant so the
        # decoder's key extraction (p ^ q with the same sigma) recovers
        # the keystream
        plain = np.zeros(16, dtype=np.uint8)
        for k in range(3):
            plain[5 * k] = q[5 * k]
            plain[5 * k + 1] = q[5 * k + 1]
            plain[5 * k + 3] = q[5 * k + 2]
            plain[5 * k + 4] = q[5 * k + 3]
            plain[5 * k + 2] = q[5 * k + 4]
        plain[15] = q[15]
        calibytes[0x170:0x180] = plain
    else:
        calibytes[0x170:0x180] = q
    # cal frame 0 bytes 2-3 = (freq - base) / 10 kHz (rs92mod.c:755-758)
    base = 1600000 if ngp else 400000
    w = (freq_khz - base) // 10
    calibytes[POS_CALFREQ - (POS_CALDATA + 1)] = w & 0xFF
    calibytes[POS_CALFREQ - (POS_CALDATA + 1) + 1] = w >> 8
    if ngp:
        key = np.asarray(
            ngp_key if ngp_key is not None
            else [0x5A, 0xC3, 0x17, 0x88, 0x2E, 0xD1, 0x4B, 0x96,
                  0x63, 0x0F, 0xB2, 0x79, 0xE4, 0x3D, 0xA8, 0x51],
            dtype=np.uint8)
        n = 66 * 5
        calibytes[0x40:0x40 + n] ^= np.tile(key, -(-n // 16))[:n]
    return calibytes


def _ptu_channels(T=-25.0, RH=45.0, P=320.0):
    """Channel counts that evaluate to T/RH/P under default_cal_coeffs."""
    ref1, ref3, ref4 = 4_000_000.0, 3_500_000.0, 3_000_000.0
    t0_t = ref1 - ref4          # T / P scaling basis
    t0_h = ref1 - ref3
    # x = 1/(y0 - t/t0) = target  ->  t = t0*(y0 - 1/target)
    temp = ref1 - t0_t * (2.0 - 1.0 / T)
    hum = ref1 - t0_h * (2.0 - 1.0 / RH)
    pres = ref1 - t0_t * (2.0 - 1.0 / P)
    ref2 = 3_200_000.0
    return [temp, hum, hum, ref1, ref2, pres, ref3, ref4]


def encode_frame(frnr=100, sonde_id="R1234567", calfr=0, calibytes=None,
                 ephs=None, tow_ms=43_205_000, lat=-34.95, lon=138.52,
                 alt=12000.0, vel_neu=(5.0, 3.0, -4.0), T=-25.0, RH=45.0,
                 P=320.0, aux=None, ngp=False):
    """Build one valid 240-byte RS92-SGP frame (incl. RS parity).

    Pseudoranges/rates are synthesized from ``ephs`` so that the reference
    navigation solution lands on (lat, lon, alt) with NEU velocity
    ``vel_neu`` = (vN, vE, vU).
    """
    if ephs is None:
        ephs = make_test_ephemeris()
    if calibytes is None:
        calibytes = make_calibytes()
    frame = np.zeros(FRAME_LEN, dtype=np.uint8)
    frame[:FRAMESTART] = HEADER_BYTES
    for pos, tag in BLOCK_TAGS.items():
        frame[pos] = tag & 0xFF
        frame[pos + 1] = tag >> 8
    frame[POS_FRAMENB] = frnr & 0xFF
    frame[POS_FRAMENB + 1] = frnr >> 8
    frame[POS_SONDEID:POS_SONDEID + 8] = np.frombuffer(
        sonde_id.encode().ljust(8)[:8], dtype=np.uint8)
    frame[POS_CALDATA] = calfr
    frame[POS_CALDATA + 1:POS_CALDATA + 17] = \
        calibytes[calfr * 16:calfr * 16 + 16]

    # PTU channels: 8 x u24 LE
    ch = np.array(_ptu_channels(T, RH, P)).round().astype(np.int64)
    for i, v in enumerate(ch):
        frame[POS_PTU + 3 * i] = v & 0xFF
        frame[POS_PTU + 3 * i + 1] = (v >> 8) & 0xFF
        frame[POS_PTU + 3 * i + 2] = (v >> 16) & 0xFF
    if ngp:
        # scramble on-air PTU bytes (inverse == forward XOR,
        # rs92mod.c get_Meas :573-581); CRC covers the scrambled bytes
        xptu = xor_ptu_key(calibytes)
        j = np.arange(24)
        frame[POS_PTU:POS_PTU + 24] ^= \
            frame[POS_FRAMENB + (j & 1)] ^ xptu[j % 16]

    # GPS block
    t = tow_ms / 1000.0
    frame[POS_GPS_TOW:POS_GPS_TOW + 4] = np.frombuffer(
        np.uint32(tow_ms).tobytes(), dtype=np.uint8)
    phi, lam = np.radians(lat), np.radians(lon)
    n_r = gps_ephem.EARTH_A / np.sqrt(
        1 - gps_ephem.E2 * np.sin(phi) ** 2)
    rx = np.array([(n_r + alt) * np.cos(phi) * np.cos(lam),
                   (n_r + alt) * np.cos(phi) * np.sin(lam),
                   (n_r * (1 - gps_ephem.E2) + alt) * np.sin(phi)])
    vN, vE, vU = vel_neu
    v_rx = np.array([
        -vN * np.sin(phi) * np.cos(lam) - vE * np.sin(lam)
        + vU * np.cos(phi) * np.cos(lam),
        -vN * np.sin(phi) * np.sin(lam) + vE * np.cos(lam)
        + vU * np.cos(phi) * np.sin(lam),
        vN * np.cos(phi) + vU * np.sin(phi)])

    prns = np.zeros(12, dtype=np.int64)
    status = np.zeros(12, dtype=np.uint8)
    n = min(len(ephs), 12)
    dt = 0.5
    for j in range(n):
        e = ephs[j]
        prns[j] = e.prn
        status[j] = 0xFF
        x, y, z, cl = gps_ephem.sat_position_with_clock(1, t, e)
        sat = np.array([x, y, z])
        sat_rot = np.array(gps_ephem._rotZ(
            x, y, z, gps_ephem.EARTH_ROT * gps_ephem.RANGE_EST))
        # decoder computes PR = -chips*DF + clock_corr (+const); make the
        # solver land on rx: -chips*DF = |sat_rot - rx| - cl + const
        prange = np.linalg.norm(sat_rot - rx) - cl + 1.0e5
        chips = int(round(-prange / DF)) & 0xFFFFFFFF
        frame[POS_GPS_DATA + 8 * j:POS_GPS_DATA + 8 * j + 4] = \
            np.frombuffer(np.uint32(chips).tobytes(), dtype=np.uint8)
        xa = np.array(gps_ephem.sat_position(1, t - dt, e))
        xb = np.array(gps_ephem.sat_position(1, t + dt, e))
        v_sat = (xb - xa) / (2 * dt)
        los = (sat - rx) / np.linalg.norm(sat - rx)
        # -3 km/s common receiver clock-drift rate keeps deltachips
        # positive (the reference reads them unsigned); the solver's cc
        # term absorbs it
        prate = float(los @ (v_sat - v_rx)) - 3000.0
        delta = int(round(-prate * DL / DF)) & 0xFFFFFF
        frame[POS_GPS_DATA + 8 * j + 4] = delta & 0xFF
        frame[POS_GPS_DATA + 8 * j + 5] = (delta >> 8) & 0xFF
        frame[POS_GPS_DATA + 8 * j + 6] = (delta >> 16) & 0xFF
    for j in range(n, 12):
        frame[POS_GPS_DATA + 8 * j:POS_GPS_DATA + 8 * j + 4] = \
            np.frombuffer(np.uint32(0x7FFFFFFF).tobytes(), dtype=np.uint8)
    pack_prns(frame, prns, status)

    if aux:
        for i, w in enumerate(aux[:4]):
            frame[POS_AUXDATA + 2 * i] = w & 0xFF
            frame[POS_AUXDATA + 2 * i + 1] = w >> 8

    # CRCs per block
    for pos, ln in ((POS_FRAMENB, LEN_CFG), (POS_PTU, LEN_PTU),
                    (POS_GPS_TOW, LEN_GPS), (POS_AUX, LEN_AUX)):
        c = crc16_ccitt(frame[pos:pos + ln])
        frame[pos + ln] = c & 0xFF
        frame[pos + ln + 1] = c >> 8

    # RS(255,231) parity (parity-first codeword, rs92mod.c:1356-1385)
    msg = np.zeros(231, dtype=np.int64)
    msg[:MSG_LEN] = frame[FRAMESTART:FRAMESTART + MSG_LEN]
    cw = RS255_231.encode(msg)
    frame[FRAME_LEN - RS_R:] = cw[:RS_R].astype(np.uint8)
    return frame


def frame_to_raw_bits(frame):
    """Frame bytes -> raw Manchester2 8N1 bit stream (incl. header)."""
    frame = np.asarray(frame, dtype=np.uint8)
    bits10 = np.zeros((len(frame), 10), dtype=np.uint8)
    bits10[:, 0] = 0
    bits10[:, 9] = 1
    for i in range(8):
        bits10[:, 1 + i] = (frame >> i) & 1
    bits = bits10.reshape(-1)
    raw = np.empty(2 * len(bits), dtype=np.uint8)
    raw[0::2] = bits ^ 1
    raw[1::2] = bits
    return raw


def encode_flight_bits(n_frames=4, ephs=None, calibytes=None, **kw):
    """Raw bit stream of n consecutive frames cycling cal subframes."""
    if ephs is None:
        ephs = make_test_ephemeris()
    if calibytes is None:
        calibytes = make_calibytes()
    chunks = []
    tow0 = kw.pop("tow_ms", 43_205_000)
    frnr0 = kw.pop("frnr", 100)
    for k in range(n_frames):
        f = encode_frame(frnr=frnr0 + k, calfr=k % 32, calibytes=calibytes,
                         ephs=ephs, tow_ms=tow0 + 1000 * k, **kw)
        chunks.append(frame_to_raw_bits(f))
    return np.concatenate(chunks)
