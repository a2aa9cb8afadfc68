"""PER cliff regression gate (round-3 verdict #4).

``docs/per_r3.csv`` records every type's PER-vs-Eb/N0 sweep with the
cliff region refined to 300 frames/point (3 seeds x 100,
tools/per_refine.py; reference ground truth uses 100-240 packets per
file across multiple files, /root/reference/auto_rx/test/README.md:75-83).

This gate re-measures ONE point per type — half a dB above the recorded
50% cliff — with 100 fresh frames.  If a demod/decoder regression moved
the cliff up by more than 0.5 dB, the true PER at that point is >= 0.5,
so the measured PER exceeds the recorded value there by far more than
binomial noise (sigma <= 0.05 at n=100): the gate fails when

    measured_per > max(recorded_per(point) + 0.20, 0.35)

which a >= +0.5 dB cliff move trips with probability > 0.999 while a
healthy chain (recorded PER typically <= 0.15 there) false-fails with
probability < 1e-3 per type.
"""

import pytest

from radiosonde_auto_rx_jax.tools.per_harness import (
    gate_limit, gate_point, recorded_rows, row_f_off)

ALL_ROWS = recorded_rows()
TYPES = sorted({r["type"] for r in ALL_ROWS})
OFFGRID = sorted({(r["type"], row_f_off(r), float(r["ebno_db"]),
                   float(r["per"]))
                  for r in ALL_ROWS if row_f_off(r) != 0.0})


@pytest.mark.parametrize("sonde_type", TYPES)
def test_per_cliff_gate(sonde_type):
    from radiosonde_auto_rx_jax.tools.per_harness import run_point
    e_gate, p_rec, cliff = gate_point(ALL_ROWS, sonde_type)
    rows = run_point(sonde_type, e_gate, n_frames=100, seed=123)
    p_meas = rows[0]["per"]
    limit = gate_limit(p_rec)
    assert p_meas <= limit, (
        f"{sonde_type}: PER at {e_gate:.1f} dB measured {p_meas:.2f} vs "
        f"recorded {p_rec:.2f} (limit {limit:.2f}) — the 50% cliff "
        f"(recorded {cliff if cliff is None else round(cliff, 2)} dB) "
        f"moved by more than 0.5 dB; docs/per_r3.csv is the reference")


# one gate per (type, offset sign): re-measure the recorded ±20 kHz
# off-grid point with 50 fresh frames.  Same statistics as the centered
# gate at n=50 (sigma <= 0.07): a regression that moves the off-grid
# cliff by >= 0.5 dB trips the limit with high probability while a
# healthy recentering chain false-fails with p < 1e-3.
@pytest.mark.parametrize("sonde_type,f_off,e_gate,p_rec", OFFGRID,
                         ids=[f"{t}{'+' if f > 0 else '-'}20k"
                              for t, f, _, _ in OFFGRID])
def test_per_offgrid_gate(sonde_type, f_off, e_gate, p_rec):
    from radiosonde_auto_rx_jax.tools.per_harness import run_point
    rows = run_point(sonde_type, e_gate, n_frames=50, seed=321,
                     f_off=f_off)
    p_meas = rows[0]["per"]
    limit = max(p_rec + 0.25, 0.45)
    assert p_meas <= limit, (
        f"{sonde_type} at {f_off/1e3:+.0f} kHz / {e_gate:.1f} dB: PER "
        f"measured {p_meas:.2f} vs recorded {p_rec:.2f} (limit "
        f"{limit:.2f}) — the off-grid recentering chain regressed; "
        f"docs/per_r5.csv is the reference")
