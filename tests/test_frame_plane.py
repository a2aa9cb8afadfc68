"""Parallel host frame plane: pooled == inline, isolation, eviction."""

import datetime

import numpy as np
import pytest

from radiosonde_auto_rx_jax.station.frame_plane import FramePlane
from radiosonde_auto_rx_jax.station.station import Station


def _rs41_capture(st, rng, chan=5, sonde_id="T1357911"):
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod
    from radiosonde_auto_rx_jax.models.rs41 import (encode_frame,
                                                    frame_to_bits,
                                                    make_calibytes)
    now = datetime.datetime.now(datetime.timezone.utc)
    week = (now - datetime.datetime(1980, 1, 6,
                                    tzinfo=datetime.timezone.utc)).days // 7
    dow = (now.weekday() + 1) % 7
    tow_ms = ((dow * 24 + now.hour) * 3600 + now.minute * 60 +
              now.second) * 1000
    cal = make_calibytes()
    tx_bits = np.concatenate(
        [rng.integers(0, 2, 400)] +
        [frame_to_bits(encode_frame(
            frame_nb=900 + i, sonde_id=sonde_id, week=week,
            tow_ms=tow_ms + i * 1000, lat=-34.5, lon=138.6, alt=12000.0,
            calibytes=cal, calfr=i)) for i in range(3)] +
        [rng.integers(0, 2, 400)])
    wide = gfsk_mod(tx_bits, st.fs_wide, 4800, 2, st.freqs[chan], 4800,
                    bt=0.5)
    wide += (rng.standard_normal(len(wide)) +
             1j * rng.standard_normal(len(wide))
             ).astype(np.complex64) * 0.002
    return wide.astype(np.complex64)


def _stable(telems):
    keys = ("id", "frame", "type", "lat", "lon", "alt", "freq")
    return [{k: t.get(k) for k in keys} for t in telems]


def test_inline_plane_decodes():
    """workers=0 plane: decode/gather inline, decoder state persists."""
    from radiosonde_auto_rx_jax.models.dfm import (DFMDecoder,
                                                   encode_flight_bits)
    plane = FramePlane(workers=0)
    bits = encode_flight_bits(n_cycles=3)
    t1 = plane.decode(400_500_000, "DFM", {}, bits, None)
    res = plane.gather()
    assert res[t1], "no telemetry from inline plane"
    # same fz reuses the decoder (serial already confirmed -> telemetry
    # from the first cycle of a new stream)
    t2 = plane.decode(400_500_000, "DFM", {}, bits, None)
    assert plane.gather()[t2]
    plane.close()


def test_pooled_station_matches_inline():
    """The pooled frame plane produces the same telemetry as inline on a
    full station capture (VERDICT r1 #6: parallel host frame plane)."""
    rng = np.random.default_rng(5)
    cfg = {"capture_rate": 2_400_000, "num_channels": 50,
           "station_lat": 0.0, "station_lon": 0.0}
    st_in = Station(dict(cfg), exporters=[], center_freq_hz=402.5e6)
    wide = _rs41_capture(st_in, rng)
    got_inline = st_in.process_capture(wide)
    assert got_inline, "inline station produced no telemetry"

    st_pool = Station({**cfg, "frame_plane_workers": 2}, exporters=[],
                      center_freq_hz=402.5e6)
    try:
        got_pooled = st_pool.process_capture(wide)
        assert _stable(got_pooled) == _stable(got_inline)
        # decoder state lives in the workers, not in task metadata
        fz = st_pool.freq_of_channel(5)
        assert st_pool.active[fz]["type"] == "RS41"
        assert st_pool.active[fz]["decoder"] is None
        assert st_pool.active[fz]["last_ok"] > 0
    finally:
        st_pool.close()


def test_pooled_worker_error_isolated():
    """A decoder blowing up inside a worker yields an empty result for
    that ticket; other tickets and the plane itself survive."""
    from radiosonde_auto_rx_jax.models.dfm import encode_flight_bits
    plane = FramePlane(workers=2)
    try:
        bits = encode_flight_bits(n_cycles=3)
        bad = plane.decode(400_000_000, "RS41", {"no_such_kwarg": 1},
                           bits, None)
        good = plane.decode(400_010_000, "DFM", {}, bits, None)
        res = plane.gather()
        assert res[bad] == []
        assert res[good], "good ticket starved by bad one"
        # eviction of a worker-held decoder must not deadlock
        plane.drop(400_010_000)
        again = plane.decode(400_010_000, "DFM", {}, bits, None)
        assert plane.gather()[again]
    finally:
        plane.close()
