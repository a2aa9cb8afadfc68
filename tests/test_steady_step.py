"""Fused steady-state station step (round-4 verdict #6).

On a single-device mesh the production dispatch speculates the block's
tasks from current task state and runs channelize + PSD + recentering +
per-type demod as ONE device program (ShardedStationStep.steady_step).
These tests pin: telemetry equality with the legacy split path across
a capture sequence (detection block → steady blocks → drifting sonde →
sonde disappearance), and that the fused outputs are actually used in
the steady blocks.
"""

import numpy as np
import jax
import pytest

from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod
from radiosonde_auto_rx_jax.parallel.mesh import make_mesh
from radiosonde_auto_rx_jax.station.station import Station

from station_fixture import dfm_bits, rs41_bits, taper
from test_offgrid import (CENTER, FREQS, FS_WIDE, N_CHAN, T_WIDE,
                          _capture, _cfg, _key, _Col)

RS41_CH, DFM_CH = 5, 4


def _one_dev_station(**kw):
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
    return Station(_cfg(**kw), exporters=[_Col()], center_freq_hz=CENTER,
                   mesh=mesh)


def test_steady_equals_legacy_over_sequence():
    """Three capture cycles (detect → steady → steady) with an off-grid
    RS41 and DFM: fused-path telemetry equals the legacy split path,
    and blocks 2-3 are served by the fused program."""
    caps = [_capture(10e3, -20e3, seed=21 + i) for i in range(3)]

    st_ref = Station({**_cfg(), "use_mesh": False}, exporters=[_Col()],
                     center_freq_hz=CENTER)
    ref = []
    for c in caps:
        ref.extend(st_ref.process_capture(c))

    st = _one_dev_station()
    assert st.mesh is not None and st.mesh.size == 1
    got = []
    for c in caps:
        got.extend(st.process_captures([c]))

    assert ref, "legacy station produced no telemetry"
    assert sorted(map(_key, got)) == sorted(map(_key, ref))
    assert st.stats.get("fused_channels", 0) >= 2, \
        "steady blocks were not served by the fused program"
    assert set(st.active) == set(st_ref.active)


def test_steady_follows_drift_via_fallback():
    """A sonde jumping +12 kHz between captures invalidates the
    speculation for that block; the fallback re-demodulates and the
    NEXT block is fused again at the new frequency."""
    # scan_every=1: the scan-absorb retune must see every block (the
    # fixture jumps 12 kHz per capture; real drift is ~Hz/s and the
    # default 1-in-4 scan duty follows it fine)
    st = _one_dev_station(scan_every=1)
    fused_after = []
    for i, off in enumerate((14e3, 26e3, 26e3)):
        rng = np.random.default_rng(41 + i)
        wide = (rng.standard_normal(T_WIDE) + 1j *
                rng.standard_normal(T_WIDE)).astype(np.complex64) * 0.002
        sig = taper(gfsk_mod(rs41_bits(np.random.default_rng(77),
                                       ts=1_755_600_000 + i),
                             FS_WIDE, 4800, 2, FREQS[RS41_CH] + off,
                             4800, bt=0.5)[:T_WIDE])
        wide[:len(sig)] += sig
        planes = np.stack([wide.real, wide.imag]).astype(np.float32)
        telems = st.process_captures([planes])
        assert telems, f"block {i} decoded nothing"
        assert len(st.active) == 1
        fused_after.append(st.stats.get("fused_channels", 0))
    # block 0: detection (no fusion), block 1: retune fallback (no new
    # fused use for the moved channel), block 2: fused at the new freq
    assert fused_after[2] > fused_after[1], \
        f"block 2 not fused after drift settled: {fused_after}"


def test_steady_empty_plan_scan_only():
    """No active tasks: the fused program is just analyze (+ nothing);
    a fresh detection still decodes through the split path."""
    st = _one_dev_station()
    telems = st.process_captures([_capture(0.0, 0.0, seed=77)])
    assert telems, "detection block decoded nothing"
    assert {t["type"] for t in telems} >= {"RS41", "DFM"}
