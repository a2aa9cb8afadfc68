"""Synthetic multi-sonde wideband captures (seeded, host NumPy).

The reference validates against recorded captures; this builds the same
kind of input from the package's own frame encoders and GFSK modulator:
RS41 (48 kHz direct chain), M20 (a lookalike whose idle cross-fires the
WXR template, so the full-rate confirmation has work to do), DFM (50 kHz
resampled chain) and M10 (48.08 kHz resampled chain).  Every sonde
records what it encoded — the serial its decoder must report and the
frame numbers of the frames sent — so a station run can be checked
against the synthesizer instead of against another run of the station.

The low-level bit builders (``rs41_bits`` ...) keep the call signatures
the station-step test fixtures use.
"""

import datetime
from dataclasses import dataclass, field

import numpy as np

from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod

_GPS_EPOCH = datetime.datetime(1980, 1, 6, tzinfo=datetime.timezone.utc)

# the identities the default encoder fields read as
RS41_SERIAL = "T1357911"
M20_SERIAL = "M20-305-3-11234"     # encode_frame_m20's default sn24
M10_SERIAL = "M10-A05-3-24660"     # encode_frame_m10's default sn bytes
DFM_SN = 21054321


def _gps_week_tow(ts: float):
    """(GPS week, seconds of week) of unix time ``ts`` (GPS = UTC here,
    as the decoders' time conversion assumes)."""
    now = datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
    s = int((now - _GPS_EPOCH).total_seconds())
    return s // 604800, s % 604800


def rs41_bits(rng, ts=None, n_frames=3, frame0=900, gap_bits=0,
              lat=-34.5, lon=138.6, alt=12000.0):
    """RS41 frames (1 s apart in GPS time) between 400 random lead/tail
    bits; ``gap_bits`` random bits follow every frame."""
    from radiosonde_auto_rx_jax.models.rs41 import (
        encode_frame, frame_to_bits, make_calibytes)
    now = (datetime.datetime.fromtimestamp(ts, datetime.timezone.utc)
           if ts is not None else
           datetime.datetime.now(datetime.timezone.utc))
    week = (now - datetime.datetime(1980, 1, 6,
                                    tzinfo=datetime.timezone.utc)).days // 7
    dow = (now.weekday() + 1) % 7
    tow_ms = ((dow * 24 + now.hour) * 3600 + now.minute * 60 +
              now.second) * 1000
    cal = make_calibytes()
    parts = [rng.integers(0, 2, 400)]
    for i in range(n_frames):
        parts.append(frame_to_bits(encode_frame(
            frame_nb=frame0 + i, sonde_id=RS41_SERIAL, week=week,
            tow_ms=tow_ms + i * 1000, lat=lat, lon=lon, alt=alt,
            calibytes=cal, calfr=i % 51)))
        if gap_bits:
            parts.append(rng.integers(0, 2, gap_bits))
    parts.append(rng.integers(0, 2, 400))
    return np.concatenate(parts)


def m20_bits(rng, n_frames=4, week=2150, gpssec=388815, gap_bits=0,
             lat=52.1, lon=13.3, tick=0):
    """M20 frames between alternating idle runs; GPS time advances
    ``tick`` s per frame, and ``gap_bits`` random bits follow each frame
    (a long alternating run between frames is not decoded: see
    PERF.md, open questions)."""
    from radiosonde_auto_rx_jax.models.m10 import (
        encode_frame_m20, frame_to_raw_bits)
    idle = np.tile(np.array([1, 0], np.uint8), 200)
    gap = rng.integers(0, 2, gap_bits).astype(np.uint8)
    raw = np.concatenate([np.concatenate([frame_to_raw_bits(
        encode_frame_m20(week=week, gpssec=gpssec + i * tick, lat=lat,
                         lon=lon)),
        gap]) for i in range(n_frames)])
    return np.concatenate([idle, raw, idle])


def dfm_bits(rng, n_cycles=2, date=None, lat=47.9, lon=16.8):
    """DFM-09 flight cycles (1.12 s each, GPS time +1 s per cycle).
    2 cycles decode positions; serial confirmation (and therefore the
    production telemetry filter) needs >= 3 cycles."""
    from radiosonde_auto_rx_jax.models.dfm import encode_flight_bits
    kw = {} if date is None else {"date": date}
    return np.concatenate([
        rng.integers(0, 2, 500).astype(np.uint8),
        encode_flight_bits(sn=DFM_SN, lat=lat, lon=lon,
                           n_cycles=n_cycles, time_step=1.0,
                           **kw).astype(np.uint8)])


def m10_bits(rng, n_frames=3, week=2050, tow_ms=388815000, gap_bits=0,
             lat=48.2, lon=16.4, tick=0):
    """M10 frames between 8-ones/8-zeros idle runs; GPS time advances
    ``tick`` s per frame."""
    from radiosonde_auto_rx_jax.models.m10 import (
        encode_frame_m10, frame_to_raw_bits)
    idle = np.tile(np.concatenate([np.ones(8, np.uint8),
                                   np.zeros(8, np.uint8)]), 40)
    gap = np.resize(idle, gap_bits)
    raw = np.concatenate([np.concatenate([frame_to_raw_bits(
        encode_frame_m10(week=week, tow_ms=tow_ms + 1000 * i * tick,
                         lat=lat, lon=lon, alt=11000.0)), gap])
        for i in range(n_frames)])
    return np.concatenate([idle, raw, idle])


def taper(sig, n=4096):
    """Cosine ramp on the burst edges: an instantaneous IQ amplitude
    step is nonphysical (real transmitters key up/down over many
    symbols) and its broadband transient lands in different sparse-Welch
    segments depending on tiling offset."""
    w = 0.5 - 0.5 * np.cos(np.pi * np.arange(n) / n)
    sig[:n] *= w
    sig[-n:] *= w[::-1]
    return sig


# --------------------------------------------------------------------- #
# whole sondes: bits at their air rate, modulation, and what was encoded

# (baud, tone spacing Hz, Gaussian BT) per type — the transmitters'
# modulation as the station-step fixtures build it
_AIR = {"RS41": (4800, 4800, 0.5), "M20": (9600, 9600, 1.0),
        "DFM": (2500, 5000, 0.5), "M10": (9616, 10000, 1.0)}
_POS = {"RS41": (-34.5, 138.6), "M20": (52.1, 13.3),
        "DFM": (47.9, 16.8), "M10": (48.2, 16.4)}


@dataclass
class Sonde:
    """One synthesized transmitter and the fields its decoder must
    report: ``serial`` exactly, and ``frame`` numbers from ``frames``."""
    kind: str                      # decoder type name
    freq_hz: float                 # absolute carrier frequency
    serial: str
    lat: float
    lon: float
    frames: set = field(default_factory=set)


def sonde_bits(kind: str, seconds: float, ts: float, rng):
    """(bits at the air rate, Sonde-without-frequency) for ``seconds``
    of one sonde transmitting one frame per second from GPS time
    ``ts``."""
    rs = _AIR[kind][0]
    per_s = int(rs)                # air bits per second
    n = max(1, int(seconds) - 1)
    week, tow = _gps_week_tow(ts)
    lat, lon = _POS[kind]
    if kind == "RS41":
        frame_bits = 320 * 8
        bits = rs41_bits(rng, ts=ts, n_frames=n, frame0=1000,
                         gap_bits=per_s - frame_bits, lat=lat, lon=lon)
        return bits, Sonde(kind, 0.0, RS41_SERIAL, lat, lon,
                           set(range(1000, 1000 + n)))
    if kind == "M20":
        from radiosonde_auto_rx_jax.models.m10 import (
            encode_frame_m20, frame_to_raw_bits)
        fbits = len(frame_to_raw_bits(encode_frame_m20()))
        bits = m20_bits(rng, n_frames=n, week=week, gpssec=tow,
                        gap_bits=max(0, per_s - fbits) // 2 * 2,
                        lat=lat, lon=lon, tick=1)
        return bits, Sonde(kind, 0.0, M20_SERIAL, lat, lon,
                           {week * 604800 + tow + i for i in range(n)})
    if kind == "M10":
        from radiosonde_auto_rx_jax.models.m10 import (
            encode_frame_m10, frame_to_raw_bits)
        fbits = len(frame_to_raw_bits(encode_frame_m10()))
        bits = m10_bits(rng, n_frames=n, week=week, tow_ms=tow * 1000,
                        gap_bits=max(0, per_s - fbits), lat=lat, lon=lon,
                        tick=1)
        return bits, Sonde(kind, 0.0, M10_SERIAL, lat, lon,
                           {week * 604800 + tow + i for i in range(n)})
    if kind == "DFM":
        from radiosonde_auto_rx_jax.models.dfm import datetime2gpsweek
        t0 = datetime.datetime.fromtimestamp(int(ts), datetime.timezone.utc)
        n_cyc = max(3, int(seconds / 1.12))
        bits = dfm_bits(rng, n_cycles=n_cyc, lat=lat, lon=lon,
                        date=(t0.year, t0.month, t0.day, t0.hour,
                              t0.minute, float(t0.second)))
        frames = set()
        for c in range(n_cyc):
            t = t0 + datetime.timedelta(seconds=c)
            wk, tw = datetime2gpsweek(t.year, t.month, t.day, t.hour,
                                      t.minute, t.second)
            frames.add(wk * 604800 + tw)
        return bits, Sonde(kind, 0.0, f"DFM-{DFM_SN}", lat, lon, frames)
    raise ValueError(f"no synthesizer for {kind!r}")


def wideband_capture(placements, fs: int, seconds: float, center_hz: float,
                     ts: float, seed: int = 0, noise: float = 0.002,
                     level: float = 0.2):
    """Complex64 [T] capture (T = fs*seconds) at ``center_hz`` with one
    GFSK sonde of amplitude ``level`` per ``(kind, offset_hz)`` in
    ``placements`` over complex Gaussian noise (``noise`` rms per
    component).  The default level keeps four sondes inside the cs16
    range of ``write_cs16``.  Returns (iq, sondes) with each Sonde's
    absolute frequency filled in."""
    rng = np.random.default_rng(seed)
    T = int(fs * seconds)
    iq = (rng.standard_normal(T) + 1j * rng.standard_normal(T)
          ).astype(np.complex64) * np.float32(noise)
    sondes = []
    for kind, off in placements:
        bits, sonde = sonde_bits(kind, seconds, ts, rng)
        rs, spacing, bt = _AIR[kind]
        sig = gfsk_mod(bits, fs, rs, 2, off, spacing, bt=bt)[:T]
        iq[:len(sig)] += taper(sig) * np.float32(level)
        sonde.freq_hz = center_hz + off
        sondes.append(sonde)
    return iq, sondes


def to_cs16(iq, scale: float = 16000.0):
    """[2, T] int16 planes of complex ``iq`` (the cs16 wire scale).
    Raises ValueError if a sample would clip: clipping a multi-sonde
    capture spreads intermodulation spurs across the band."""
    re = np.round(iq.real * scale)
    im = np.round(iq.imag * scale)
    if max(np.abs(re).max(), np.abs(im).max()) > 32767:
        raise ValueError("capture clips at this cs16 scale")
    return np.stack([re, im]).astype(np.int16)


def write_cs16(path, iq, scale: float = 16000.0):
    """Interleaved int16 I/Q (the rtl_sdr/airspy cs16 wire format)."""
    with open(path, "wb") as f:
        f.write(to_cs16(iq, scale).T.tobytes())


def check_telemetry(telems, sondes, min_frames: int = 1):
    """Problems (empty list = pass) of decoded telemetry against what
    the synthesizer encoded: every sonde reports its exact serial, only
    frame numbers it sent, its position, and at least ``min_frames``
    distinct frames; no telemetry arrives from any other transmitter."""
    problems = []
    by_serial = {}
    for t in telems:
        by_serial.setdefault(t["id"], []).append(t)
    for s in sondes:
        got = by_serial.pop(s.serial, [])
        frames = {int(t["frame"]) for t in got}
        if len(frames) < min_frames:
            problems.append(f"{s.kind} {s.serial}: {len(frames)} distinct "
                            f"frames decoded, want >= {min_frames}")
        extra = frames - s.frames
        if extra:
            problems.append(f"{s.kind} {s.serial}: frame numbers "
                            f"{sorted(extra)[:5]} were never sent")
        for t in got:
            if abs(float(t["lat"]) - s.lat) > 1e-3 or \
                    abs(float(t["lon"]) - s.lon) > 1e-3:
                problems.append(f"{s.kind} {s.serial}: position "
                                f"{t['lat']},{t['lon']} != {s.lat},{s.lon}")
                break
    for serial in by_serial:
        problems.append(f"telemetry from an unknown serial {serial!r}")
    return problems
