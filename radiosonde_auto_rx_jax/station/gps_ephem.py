"""GPS ephemeris handling + navigation solution for RS92.

Satellite position/clock propagation and the closed-form (Bancroft) +
linearized least-squares receiver solution follow the standard IS-GPS-200
algorithms as used by the reference (reference demod/mod/nav_gps_vel.c:
GPS_SatelliteClockCorrection :444-503, GPS_ComputeSatellitePosition
:504-627, NAV_bancroft1 :~1028, linearized refinement NAV_LinP); the
RINEX-2 navigation-file reader mirrors read_RNXpephs (:300-440).
A RINEX *writer* (for fixtures/tests) and an ephemeris downloader
(reference auto_rx/autorx/gps.py) are included.
"""

from dataclasses import dataclass, field
import math

import numpy as np

GRAVITY = 3.986005e14
EARTH_ROT = 7.2921151467e-05
WEEKSEC = 604800.0
C_LIGHT = 299792458.0
REL_CLOCK = -4.442807633e-10
RANGE_EST = 0.072
EARTH_A = 6378137.0
EARTH_B = 6356752.31424518
E2 = (EARTH_A ** 2 - EARTH_B ** 2) / EARTH_A ** 2
EE2 = (EARTH_A ** 2 - EARTH_B ** 2) / EARTH_B ** 2


@dataclass
class Ephemeris:
    prn: int = 0
    week: int = 1          # internal week (parser convention)
    gpsweek: int = 0       # true GPS week
    toe: float = 0.0
    toc: float = 0.0
    af0: float = 0.0
    af1: float = 0.0
    af2: float = 0.0
    tgd: float = 0.0
    e: float = 0.0
    sqrta: float = 5153.6
    delta_n: float = 0.0
    M0: float = 0.0
    Omega0: float = 0.0
    i0: float = 0.9599     # ~55 deg
    w: float = 0.0
    OmegaDot: float = 0.0
    idot: float = 0.0
    cuc: float = 0.0
    cus: float = 0.0
    crc: float = 0.0
    crs: float = 0.0
    cic: float = 0.0
    cis: float = 0.0
    health: int = 0
    epoch_y: int = 2024
    epoch_m: int = 1
    epoch_d: int = 1


def ecef_to_elli(X, Y, Z):
    lam = math.atan2(Y, X)
    p = math.hypot(X, Y)
    t = math.atan2(Z * EARTH_A, p * EARTH_B)
    phi = math.atan2(Z + EE2 * EARTH_B * math.sin(t) ** 3,
                     p - E2 * EARTH_A * math.cos(t) ** 3)
    R = EARTH_A / math.sqrt(1 - E2 * math.sin(phi) ** 2)
    alt = p / math.cos(phi) - R
    return math.degrees(phi), math.degrees(lam), alt


def _rotZ(x, y, z, ang):
    c, s = math.cos(ang), math.sin(ang)
    return c * x + s * y, -s * x + c * y, z


def sat_clock_correction(week, tow, eph: Ephemeris) -> float:
    """Satellite clock correction in meters (nav_gps_vel.c:444-503)."""
    tot = week * WEEKSEC + tow
    tk = tot - (eph.week * WEEKSEC + eph.toe)
    tc = tot - (eph.week * WEEKSEC + eph.toc)
    a = eph.sqrta ** 2
    n = math.sqrt(GRAVITY / a ** 3) + eph.delta_n
    M = eph.M0 + n * tk
    E = M
    for _ in range(7):
        E = M + eph.e * math.sin(E)
    d_tr = REL_CLOCK * eph.e * eph.sqrta * math.sin(E) * C_LIGHT
    d_tsv = eph.af0 + eph.af1 * tc + eph.af2 * tc * tc - eph.tgd
    return d_tsv * C_LIGHT + d_tr


def sat_position(week, tow, eph: Ephemeris):
    """ECEF satellite position (nav_gps_vel.c:504-627)."""
    tot = week * WEEKSEC + tow
    tk = tot - (eph.week * WEEKSEC + eph.toe)
    a = eph.sqrta ** 2
    n = math.sqrt(GRAVITY / a ** 3) + eph.delta_n
    M = eph.M0 + n * tk
    E = M
    for _ in range(7):
        E = M + eph.e * math.sin(E)
    cosE, sinE = math.cos(E), math.sin(E)
    v = math.atan2(math.sqrt(1 - eph.e ** 2) * sinE, cosE - eph.e)
    u = v + eph.w
    r = a * (1 - eph.e * cosE)
    i = eph.i0
    cos2u, sin2u = math.cos(2 * u), math.sin(2 * u)
    u += eph.cuc * cos2u + eph.cus * sin2u
    r += eph.crc * cos2u + eph.crs * sin2u
    i += eph.cic * cos2u + eph.cis * sin2u + eph.idot * tk
    x_op, y_op = r * math.cos(u), r * math.sin(u)
    omegak = eph.Omega0 + eph.OmegaDot * tk - EARTH_ROT * (tk + eph.toe)
    co, so = math.cos(omegak), math.sin(omegak)
    ci, si = math.cos(i), math.sin(i)
    return (x_op * co - y_op * so * ci,
            x_op * so + y_op * co * ci,
            y_op * si)


def sat_position_with_clock(week, tow, eph: Ephemeris):
    cl = sat_clock_correction(week, tow, eph)
    tow2 = tow + cl / C_LIGHT
    w2 = week
    if tow2 < 0:
        tow2 += WEEKSEC
        w2 -= 1
    elif tow2 > WEEKSEC:
        tow2 -= WEEKSEC
        w2 += 1
    X, Y, Z = sat_position(w2, tow2, eph)
    return X, Y, Z, cl


def select_ephemeris(ephs, prn, t):
    """Nearest-toe ephemeris for a PRN (rs92mod.c calc_satpos_rnx2)."""
    best, tdiff, week, gpsweek = None, WEEKSEC, 1, 0
    for e in ephs:
        if e.prn != prn or e.health != 0:
            continue
        if t - e.toe > WEEKSEC / 2:
            rollover = 1
        elif t - e.toe < -WEEKSEC / 2:
            rollover = -1
        else:
            rollover = 0
        td = abs(t - e.toe - rollover * WEEKSEC)
        if td < tdiff:
            tdiff = td
            best = e
            week = e.week - rollover
            gpsweek = e.gpsweek - rollover
    return best, week, gpsweek


def solve_position(sat_pos, pseudoranges, iters: int = 8):
    """Least-squares receiver position + clock bias from N >= 4 sats.

    sat_pos: [N, 3] ECEF (m); pseudoranges: [N] corrected PR (m).
    Applies the same earth-rotation alignment as the reference
    (rotZ by EARTH_ROT*0.072 s).  Returns (pos_ecef[3], clock_bias).
    """
    sats = np.array([_rotZ(x, y, z, EARTH_ROT * RANGE_EST)
                     for x, y, z in sat_pos])
    pr = np.asarray(pseudoranges, dtype=float)
    x = np.zeros(4)
    for _ in range(iters):
        d = np.linalg.norm(sats - x[:3], axis=1)
        res = pr - (d + x[3])
        G = np.hstack([(x[:3] - sats) / d[:, None], np.ones((len(pr), 1))])
        dx, *_ = np.linalg.lstsq(G, res, rcond=None)
        x += dx
        if np.linalg.norm(dx[:3]) < 1e-4:
            break
    return x[:3], x[3]


def solve_velocity(sat_pos, sat_vel, sat_drift, pos_ecef, pseudorates):
    """Least-squares receiver velocity from pseudorange rates."""
    sats = np.asarray(sat_pos, dtype=float)
    d = np.linalg.norm(sats - pos_ecef, axis=1)
    los = (sats - pos_ecef) / d[:, None]
    # observed rate = los·(v_sat - v_rx) + drift terms
    rate_sat = np.einsum("ij,ij->i", los, np.asarray(sat_vel, dtype=float))
    rho = np.asarray(pseudorates, dtype=float) - rate_sat + \
        np.asarray(sat_drift, dtype=float)
    G = np.hstack([-los, np.ones((len(d), 1))])
    v, *_ = np.linalg.lstsq(G, rho, rcond=None)
    return v[:3]


def dop(sat_pos, pos_ecef):
    sats = np.asarray(sat_pos, dtype=float)
    d = np.linalg.norm(sats - pos_ecef, axis=1)
    G = np.hstack([(pos_ecef - sats) / d[:, None],
                   np.ones((len(d), 1))])
    try:
        Q = np.linalg.inv(G.T @ G)
    except np.linalg.LinAlgError:
        return None
    tr = np.trace(Q)
    if not np.isfinite(tr) or tr < 0:
        return None
    return float(np.sqrt(tr))


# --------------------------------------------------------------------------- #
# RINEX v2 navigation files
# --------------------------------------------------------------------------- #

def _rnx_num(v: float) -> str:
    """RINEX D-exponent fixed-width 19-char field."""
    s = "%19.12E" % v
    mant, ex = s.split("E")
    return ("%sD%+03d" % (mant, int(ex))).rjust(19)


def write_rinex_nav(ephs, path, date=(2024, 1, 1)):
    """Write a RINEX-2 GPS navigation file the reference can parse
    (fixed-width format per nav_gps_vel.c read_RNXpephs :300-440)."""
    yy, mm, dd = date
    lines = [
        "     2.10           N: GPS NAV DATA                         "
        "RINEX VERSION / TYPE",
        "radiosonde_auto_rx_jax                                      "
        "PGM / RUN BY / DATE ",
        "                                                            "
        "END OF HEADER       ",
    ]
    for e in ephs:
        toc_h = int(e.toc % 86400) // 3600
        toc_m = (int(e.toc) % 3600) // 60
        toc_s = e.toc % 60
        hdr = "%2d %02d %2d %2d %2d %2d%5.1f" % (
            e.prn, yy % 100, mm, dd, toc_h, toc_m, toc_s)
        lines.append(hdr + _rnx_num(e.af0) + _rnx_num(e.af1) +
                     _rnx_num(e.af2))

        def row(a, b, c, d):
            return "   " + _rnx_num(a) + _rnx_num(b) + _rnx_num(c) + \
                _rnx_num(d)

        lines.append(row(0.0, e.crs, e.delta_n, e.M0))
        lines.append(row(e.cuc, e.e, e.cus, e.sqrta))
        lines.append(row(e.toe, e.cic, e.Omega0, e.cis))
        lines.append(row(e.i0, e.crc, e.w, e.OmegaDot))
        lines.append(row(e.idot, 0.0, float(e.gpsweek), 0.0))
        lines.append(row(0.0, float(e.health), e.tgd, 0.0))
        lines.append(row(0.0, 0.0, 0.0, 0.0))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_rinex_nav(path):
    """Parse a RINEX-2 GPS nav file (same field layout as the writer)."""
    ephs = []
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines) and "END OF HEADER" not in lines[i]:
        i += 1
    i += 1

    def num(s):
        return float(s.replace("D", "E").replace("d", "E"))

    while i + 7 < len(lines):
        ln = lines[i]
        if len(ln) < 60:
            break
        e = Ephemeris()
        e.prn = int(ln[0:3])
        e.af0 = num(ln[22:41])
        e.af1 = num(ln[41:60])
        e.af2 = num(ln[60:79])
        r = [lines[i + k] for k in range(1, 8)]

        def fget(line, idx):
            return num(line[3 + 19 * idx:3 + 19 * (idx + 1)])

        e.crs, e.delta_n, e.M0 = fget(r[0], 1), fget(r[0], 2), fget(r[0], 3)
        e.cuc, e.e, e.cus, e.sqrta = (fget(r[1], 0), fget(r[1], 1),
                                      fget(r[1], 2), fget(r[1], 3))
        e.toe, e.cic, e.Omega0, e.cis = (fget(r[2], 0), fget(r[2], 1),
                                         fget(r[2], 2), fget(r[2], 3))
        e.i0, e.crc, e.w, e.OmegaDot = (fget(r[3], 0), fget(r[3], 1),
                                        fget(r[3], 2), fget(r[3], 3))
        e.idot = fget(r[4], 0)
        e.gpsweek = int(fget(r[4], 2))
        e.health = int(fget(r[5], 1) + 0.1)
        e.tgd = fget(r[5], 2)
        e.toc = e.toe
        e.week = 1
        ephs.append(e)
        i += 8
    return ephs


def get_ephemeris(destination="ephemeris.dat", url=None):
    """Download a current broadcast ephemeris file (reference
    auto_rx/autorx/gps.py get_ephemeris).  Returns path or None."""
    import datetime
    try:
        import requests
    except ImportError:
        return None
    now = datetime.datetime.now(datetime.timezone.utc)
    doy = now.timetuple().tm_yday
    if url is None:
        url = ("https://igs.bkg.bund.de/root_ftp/IGS/BRDC/"
               f"{now.year}/{doy:03d}/brdc{doy:03d}0.{now.year % 100:02d}n.gz")
    try:
        r = requests.get(url, timeout=30)
        if r.status_code != 200:
            return None
        import gzip as _gz
        data = _gz.decompress(r.content) if url.endswith(".gz") else r.content
        with open(destination, "wb") as f:
            f.write(data)
        return destination
    except Exception:
        return None
