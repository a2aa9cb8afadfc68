"""The synthesizer behind chip_smoke.py: each sonde's bits decode, on
the host, to exactly the serial and frame numbers it records, and the
telemetry check catches what it must."""

import time

import numpy as np
import pytest

from radiosonde_auto_rx_jax.models import get_model
from radiosonde_auto_rx_jax.tools import synth


@pytest.mark.parametrize("kind", ["RS41", "M20", "DFM", "M10"])
def test_sonde_bits_decode_to_recorded_fields(kind):
    bits, sonde = synth.sonde_bits(kind, 6, time.time(),
                                   np.random.default_rng(5))
    b = np.asarray(bits, np.uint8)
    telems = []
    for sign in (1.0, -1.0):          # decoders differ in soft polarity
        telems = get_model(kind)().decode_bits(
            b, (sign * (1.0 - 2.0 * b)).astype(np.float32))
        if telems:
            break
    good = [t for t in telems if t["id"] == sonde.serial]
    assert len({t["frame"] for t in good}) >= 3
    # only the unconfirmed DFM placeholder may differ from the serial
    assert synth.check_telemetry(good, [sonde], min_frames=3) == []
    assert {t["id"] for t in telems} <= {sonde.serial, "DFM-xxxxxxxx"}


def test_check_telemetry_flags_mismatches():
    s = synth.Sonde("RS41", 402.5e6, "T1357911", -34.5, 138.6, {1, 2, 3})
    ok = [{"id": "T1357911", "frame": f, "lat": -34.5, "lon": 138.6}
          for f in (1, 2)]
    assert synth.check_telemetry(ok, [s], min_frames=2) == []
    assert synth.check_telemetry(ok, [s], min_frames=3)
    bad_frame = ok + [{"id": "T1357911", "frame": 9, "lat": -34.5,
                       "lon": 138.6}]
    assert "never sent" in synth.check_telemetry(bad_frame, [s])[0]
    moved = [dict(ok[0], lat=10.0)]
    assert "position" in synth.check_telemetry(moved, [s])[0]
    ghost = ok + [{"id": "S0000000", "frame": 1, "lat": 0, "lon": 0}]
    assert "unknown serial" in synth.check_telemetry(ghost, [s])[0]
