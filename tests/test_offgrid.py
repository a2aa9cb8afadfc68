"""Off-grid frequency coverage (round-4 verdict #1-#3).

Real sondes transmit on a 10 kHz raster, not on the station's 48 kHz
channel grid.  The reference tunes its SDR to the detected peak
(reference auto_rx/autorx/scan.py:1034-1097, sdr_wrappers.py:270-376);
here the scan carries ``peak − channel_center`` and the station
re-extracts a recentered channel from the retained wideband block
(ops/channelizer.extract_channels).  These tests pin:

- extraction == PFB rows at channel centers (op-level parity)
- sondes at +10 / −20 kHz off channel centers decode identical
  telemetry to on-center placement, single-device AND sharded
- a sonde drifting ~24 kHz across a channel boundary over three
  captures keeps ONE task and decodes every block (drift continuity,
  reference auto_rx.py:304-419 decoder_spacing_limit)
- Weathex (±25 kHz tones) detects and decodes on a DEFAULT 48 kHz
  station via the 96 kHz wide-scan + on-demand wide extraction
  (reference decode.py:1385-1471 runs a dedicated 96 kHz SDR task)
"""

import sys

import numpy as np
import pytest

from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod
from radiosonde_auto_rx_jax.ops.channelizer import (
    channel_freqs, channelize, extract_channels)
from radiosonde_auto_rx_jax.station.station import Station

from station_fixture import dfm_bits, rs41_bits, taper

N_CHAN = 16
FS_WIDE = 768_000
T_WIDE = 3_072_000           # 4 s: DFM serial confirmation needs 3 cycles
RS41_CH, DFM_CH = 5, 4
FREQS = channel_freqs(N_CHAN, FS_WIDE)
CENTER = 402.5e6
RS41_TS = 1_755_600_000      # fixed epoch -> identical frames per build


class _Col:
    def __init__(self):
        self.items = []

    def add(self, t):
        self.items.append(t)

    def close(self):
        pass


def _cfg(**kw):
    return {"capture_rate": FS_WIDE, "num_channels": N_CHAN,
            "station_lat": 0.0, "station_lon": 0.0,
            "sonde_time_threshold": 1e9, "frame_plane_workers": 0,
            "enable_realtime_filter": False, **kw}


def _capture(rs41_off: float, dfm_off: float, seed: int = 21):
    rng = np.random.default_rng(seed)
    wide = (rng.standard_normal(T_WIDE) +
            1j * rng.standard_normal(T_WIDE)).astype(np.complex64) * 0.002
    bits_rng = np.random.default_rng(77)
    rs41 = taper(gfsk_mod(rs41_bits(bits_rng, ts=RS41_TS), FS_WIDE, 4800,
                          2, FREQS[RS41_CH] + rs41_off, 4800,
                          bt=0.5)[:T_WIDE])
    wide[:len(rs41)] += rs41
    dfm = taper(gfsk_mod(dfm_bits(bits_rng, n_cycles=3), FS_WIDE, 2500,
                         2, FREQS[DFM_CH] + dfm_off, 5000,
                         bt=0.5)[:T_WIDE])
    wide[:len(dfm)] += dfm
    return np.stack([wide.real, wide.imag]).astype(np.float32)


def _key(t):
    return (t["type"], t.get("id"), t.get("frame"),
            round(t["lat"], 4), round(t["lon"], 4), round(t["alt"], 1))


def test_extract_matches_pfb_rows():
    """Extraction at a channel center reproduces that PFB channel, and
    an off-grid extraction lands the target tone at DC."""
    rng = np.random.default_rng(0)
    T = FS_WIDE
    x = (rng.standard_normal(T) +
         1j * rng.standard_normal(T)).astype(np.complex64)
    planes = np.stack([x.real, x.imag]).astype(np.float32)
    ch = np.asarray(channelize(planes, N_CHAN)).astype(np.float32)
    ext = np.asarray(extract_channels(
        planes, FS_WIDE, [FREQS[3], FREQS[13]], N_CHAN)
    ).astype(np.float32)
    for i, k in enumerate([3, 13]):
        scale = np.abs(ch[k]).max()
        assert np.abs(ext[i] - ch[k]).max() < 5e-3 * scale, k
    # off-grid tone -> DC
    f0 = FREQS[3] + 10e3
    tone = np.exp(2j * np.pi * f0 * np.arange(T) / FS_WIDE)
    tp = np.stack([tone.real, tone.imag]).astype(np.float32)
    z = np.asarray(extract_channels(tp, FS_WIDE, [f0], N_CHAN)
                   ).astype(np.float32)[0]
    zc = (z[0] + 1j * z[1])[300:]
    assert np.std(np.angle(zc)) < 1e-3, "extracted tone not at DC"


@pytest.fixture(scope="module")
def telem_sets():
    """Decode the on-center and off-grid captures on single-device
    stations; shared across the comparison tests."""
    out = {}
    for tag, (r_off, d_off) in {
            "center": (0.0, 0.0), "offgrid": (10e3, -20e3)}.items():
        col = _Col()
        st = Station({**_cfg(), "use_mesh": False}, exporters=[col],
                     center_freq_hz=CENTER)
        telems = st.process_capture(_capture(r_off, d_off))
        out[tag] = (telems, dict(st.active), st)
    return out


def test_offgrid_equals_oncenter_single_device(telem_sets):
    """+10 kHz RS41 and −20 kHz DFM decode IDENTICAL telemetry to the
    on-center placement (verdict done-criterion)."""
    ref, _, _ = telem_sets["center"]
    got, active, st = telem_sets["offgrid"]
    assert {t["type"] for t in ref} >= {"RS41", "DFM"}, \
        "control capture did not decode both types"
    assert sorted(map(_key, got)) == sorted(map(_key, ref))
    # task keys sit on the detected carriers, not channel centers
    by_type = {active[f]["type"]: f for f in active}
    assert abs(by_type["RS41"] -
               (CENTER + FREQS[RS41_CH] + 10e3)) < 1.5e3
    assert abs(by_type["DFM"] -
               (CENTER + FREQS[DFM_CH] - 20e3)) < 1.5e3


def test_offgrid_sharded_equals_single(telem_sets):
    """The production sharded path decodes the same off-grid telemetry
    (recentering happens under the mesh via _recenter_cids)."""
    import jax
    assert len(jax.devices()) >= 8
    ref, ref_active, _ = telem_sets["offgrid"]
    col = _Col()
    st = Station(_cfg(), exporters=[col], center_freq_hz=CENTER)
    assert st.mesh is not None and st.mesh.shape["ch"] >= 2
    got = st.process_captures([_capture(10e3, -20e3)], [CENTER])
    assert sorted(map(_key, got)) == sorted(map(_key, ref))
    assert set(st.active) == set(ref_active)


def test_drift_continuity_one_task():
    """A sonde drifting +12 kHz per capture (crossing the 48 kHz channel
    boundary at +24 kHz) keeps ONE task with decodes in EVERY block:
    the scan absorbs the moved peak into the active task
    (decoder_spacing_limit) and retunes its recentering NCO."""
    col = _Col()
    st = Station({**_cfg(), "use_mesh": False}, exporters=[col],
                 center_freq_hz=CENTER)
    ids = set()
    for i, off in enumerate((14e3, 26e3, 38e3)):
        rng = np.random.default_rng(31 + i)
        wide = (rng.standard_normal(T_WIDE) + 1j *
                rng.standard_normal(T_WIDE)).astype(np.complex64) * 0.002
        sig = taper(gfsk_mod(rs41_bits(np.random.default_rng(77),
                                       ts=RS41_TS + i),
                             FS_WIDE, 4800, 2, FREQS[RS41_CH] + off,
                             4800, bt=0.5)[:T_WIDE])
        wide[:len(sig)] += sig
        planes = np.stack([wide.real, wide.imag]).astype(np.float32)
        telems = st.process_capture(planes)
        assert telems, f"block {i} (+{off/1e3:.0f} kHz) decoded nothing"
        assert len(st.active) == 1, \
            f"block {i}: {len(st.active)} tasks (want 1): {st.active}"
        fz = next(iter(st.active))
        assert abs(fz - (CENTER + FREQS[RS41_CH] + off)) < 2e3, \
            f"block {i}: task at {fz}, sonde at {FREQS[RS41_CH]+off}"
        ids |= {t["id"] for t in telems}
    assert len(ids) == 1, f"serial changed across drift: {ids}"


def test_subthreshold_offset_no_retune_oscillation():
    """A sonde ~800 Hz off a channel center (below RECENTER_MIN_HZ, so
    its row is demodulated at the channel center): the drift feedback
    must anchor to the DEMOD center, settling the task once instead of
    walking +800 Hz per block forever (round-5 review finding)."""
    col = _Col()
    st = Station({**_cfg(), "use_mesh": False}, exporters=[col],
                 center_freq_hz=CENTER)
    freqs_seen = []
    for i in range(3):
        rng = np.random.default_rng(61 + i)
        wide = (rng.standard_normal(T_WIDE) + 1j *
                rng.standard_normal(T_WIDE)).astype(np.complex64) * 0.002
        sig = taper(gfsk_mod(rs41_bits(np.random.default_rng(77),
                                       ts=RS41_TS + 10 + i),
                             FS_WIDE, 4800, 2, FREQS[RS41_CH] + 800.0,
                             4800, bt=0.5)[:T_WIDE])
        wide[:len(sig)] += sig
        planes = np.stack([wide.real, wide.imag]).astype(np.float32)
        telems = st.process_capture(planes)
        assert telems, f"block {i} decoded nothing"
        assert len(st.active) == 1, st.active
        freqs_seen.append(next(iter(st.active)))
    # after the first settle the task frequency must be STABLE (no
    # per-block +800 Hz walk) and within the estimator bin of truth
    assert freqs_seen[1] == freqs_seen[2], \
        f"task frequency oscillates: {freqs_seen}"
    assert abs(freqs_seen[-1] - (CENTER + FREQS[RS41_CH] + 800)) < 600, \
        freqs_seen


def test_weathex_offgrid_default_station():
    """Weathex off-grid on a DEFAULT 48 kHz station: the width gate
    routes the candidate to the 96 kHz wide-scan detector and the chain
    decodes through the on-demand wide extraction — the round-4 warning
    path (station.py 'needs a 96000 Hz channel') is unreachable for
    in-band types."""
    sys.path.insert(0, "tests")
    from test_station_chains import _wxr_bits
    raw, (_, fld, want) = _wxr_bits()
    idle = np.tile(np.array([1, 0], np.uint8), 200)
    tail = np.tile(np.array([1, 0], np.uint8), 800)
    tx = np.concatenate([idle, raw, tail])
    f0 = FREQS[3] + 10e3
    sig = gfsk_mod(tx, FS_WIDE, 4800, 2, f0, 50000, bt=1.0)
    rng = np.random.default_rng(3)
    T = 2_304_000
    wide = (rng.standard_normal(T) +
            1j * rng.standard_normal(T)).astype(np.complex64) * 0.002
    wide[:len(sig)] += sig[:T]
    planes = np.stack([wide.real, wide.imag]).astype(np.float32)
    for use_mesh in (False, True):
        col = _Col()
        st = Station(_cfg(use_mesh=use_mesh, wideband_sondes=True),
                     exporters=[col], center_freq_hz=CENTER)
        telems = (st.process_captures([planes]) if use_mesh
                  else st.process_capture(planes))
        assert telems, f"no Weathex telemetry (mesh={use_mesh})"
        t = telems[-1]
        assert t["type"] == "WXR301" and abs(t[fld] - want) < 1e-3
        fz = next(f for f in st.active
                  if st.active[f]["type"] == "WXR301")
        assert abs(fz - (CENTER + f0)) < 1.5e3


def test_weathex_subsnap_offset_wide_lookup():
    """A wideband candidate whose refined carrier is WITHIN the 1 kHz
    recentering snap of a channel center must still route to the 96 kHz
    wide scan: the _wide_freqs key must match the SNAPPED candidate
    frequency the capture path reconstructs (round-5 review finding —
    keys were stored unsnapped, so a sub-snap carrier missed the lookup
    and fell down the narrow path where its ±25 kHz tones are lost)."""
    sys.path.insert(0, "tests")
    from test_station_chains import _wxr_bits
    raw, (_, fld, want) = _wxr_bits()
    idle = np.tile(np.array([1, 0], np.uint8), 200)
    tail = np.tile(np.array([1, 0], np.uint8), 800)
    tx = np.concatenate([idle, raw, tail])
    f0 = FREQS[3] + 400.0          # sub-snap: < RECENTER_MIN_HZ
    sig = gfsk_mod(tx, FS_WIDE, 4800, 2, f0, 50000, bt=1.0)
    rng = np.random.default_rng(3)
    T = 2_304_000
    wide = (rng.standard_normal(T) +
            1j * rng.standard_normal(T)).astype(np.complex64) * 0.002
    wide[:len(sig)] += sig[:T]
    planes = np.stack([wide.real, wide.imag]).astype(np.float32)
    col = _Col()
    st = Station(_cfg(use_mesh=False, wideband_sondes=True),
                 exporters=[col], center_freq_hz=CENTER)
    telems = st.process_capture(planes)
    assert telems, "sub-snap wideband candidate was lost"
    t = telems[-1]
    assert t["type"] == "WXR301" and abs(t[fld] - want) < 1e-3


def test_multiblock_batch_drift_single_task():
    """Two captures of the same ~800 Hz-off sonde decoded in ONE
    sharded collect batch: the drift retune must be deferred until the
    whole batch is done — a mid-batch rekey orphans the second block's
    decode, which then resurrects a duplicate task at the old key
    (round-5 review finding)."""
    col = _Col()
    st = Station(_cfg(use_mesh=True), exporters=[col],
                 center_freq_hz=CENTER)
    T = 2_304_000
    caps = []
    for i in range(2):
        rng = np.random.default_rng(81 + i)
        wide = (rng.standard_normal(T) + 1j *
                rng.standard_normal(T)).astype(np.complex64) * 0.002
        sig = taper(gfsk_mod(rs41_bits(np.random.default_rng(77),
                                       ts=RS41_TS + 20 + i),
                             FS_WIDE, 4800, 2, FREQS[RS41_CH] + 800.0,
                             4800, bt=0.5)[:T])
        wide[:len(sig)] += sig
        caps.append(np.stack([wide.real, wide.imag]).astype(np.float32))
    telems = st.process_captures(caps)
    assert telems, "no telemetry from the two-block batch"
    assert len(st.active) == 1, \
        f"mid-batch retune duplicated the task: {sorted(st.active)}"
    fz = next(iter(st.active))
    assert abs(fz - (CENTER + FREQS[RS41_CH] + 800)) < 1200, fz


def test_multiblock_batch_absorb_drift_single_task():
    """A drifting sonde whose scan-peak absorb fires MID-batch (block 2
    of one collect sees the moved peak while block 1 already snapshotted
    the old task key): the absorb retune must also defer to the end of
    the batch, or block 1's decode resurrects a duplicate task at the
    old key (round-5 review follow-up to the deferred-retune fix)."""
    col = _Col()
    st = Station(_cfg(use_mesh=True), exporters=[col],
                 center_freq_hz=CENTER)
    T = 2_304_000

    def _cap(off, seed, i):
        rng = np.random.default_rng(seed)
        wide = (rng.standard_normal(T) + 1j *
                rng.standard_normal(T)).astype(np.complex64) * 0.002
        sig = taper(gfsk_mod(rs41_bits(np.random.default_rng(77),
                                       ts=RS41_TS + 60 + i),
                             FS_WIDE, 4800, 2, FREQS[RS41_CH] + off,
                             4800, bt=0.5)[:T])
        wide[:len(sig)] += sig
        return np.stack([wide.real, wide.imag]).astype(np.float32)

    # batch 1 establishes the task at +14 kHz
    assert st.process_captures([_cap(14e3, 101, 0)])
    assert len(st.active) == 1
    # batch 2: block 1 still at +14 kHz, block 2 moved to +26 kHz —
    # the second block's scan peak absorbs into the active task
    st.process_captures([_cap(14e3, 102, 1), _cap(26e3, 103, 2)])
    assert len(st.active) == 1, \
        f"mid-batch absorb retune duplicated the task: {sorted(st.active)}"
    fz = next(iter(st.active))
    assert abs(fz - (CENTER + FREQS[RS41_CH] + 26e3)) < 2e3, fz
