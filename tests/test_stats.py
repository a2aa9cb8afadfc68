"""Log-analytics stats: radio horizon + normalized SNR map."""

import numpy as np

from radiosonde_auto_rx_jax.utils import stats


def _write_log(path, serial, lat, lon, alt, snr=20.0, n=5):
    """Minimal per-sonde CSV in the TelemetryLogger column layout."""
    from radiosonde_auto_rx_jax.exporters.logfile import (
        LOG_HEADER, telemetry_to_log_line)
    import datetime
    lines = [LOG_HEADER]
    t0 = datetime.datetime(2026, 8, 17, 1, 2, 3,
                           tzinfo=datetime.timezone.utc)
    for i in range(n):
        ts = t0 + datetime.timedelta(seconds=i)
        t = dict(datetime=ts.strftime("%Y-%m-%dT%H:%M:%SZ"),
                 id=serial, frame=i, lat=lat, lon=lon + i * 1e-4,
                 alt=alt + 50 * i, vel_v=5.0, vel_h=10.0, heading=90.0,
                 temp=-20.0, humidity=50.0, pressure=-1,
                 type="RS41", freq_float=402.5, snr=snr, f_error=0,
                 sats=9, batt=2.9)
        lines.append(telemetry_to_log_line(t))
    path.write_text("".join(ln if ln.endswith("\n") else ln + "\n"
                            for ln in lines))


def test_collect_and_horizon(tmp_path):
    station = (0.0, 0.0, 0.0)
    _write_log(tmp_path / "20260817-010203_P1_RS41_402.500_sonde.log",
               "P1", 0.5, 0.5, 12000.0)      # ~78 km NE
    _write_log(tmp_path / "20260817-010203_P2_RS41_402.500_sonde.log",
               "P2", -0.3, -0.3, 8000.0)     # ~47 km SW
    pos = stats.collect_last_positions(str(tmp_path), station)
    assert len(pos) == 2
    bearings = sorted(p["bearing"] for p in pos)
    assert 40 < bearings[0] < 50 or 40 < bearings[1] < 50   # NE ~45 deg
    assert all(p["range_km"] > 10 for p in pos)
    prof = stats.horizon_profile(pos)
    assert np.sum(~np.isnan(prof)) == 2


def test_snr_map_normalization(tmp_path):
    station = (0.0, 0.0, 0.0)
    _write_log(tmp_path / "20260817-010203_P3_RS41_402.500_sonde.log",
               "P3", 0.45, 0.0, 10000.0, snr=20.0)   # ~50 km due north
    grid, counts = stats.snr_map(str(tmp_path), station, norm_range_km=50)
    assert counts.sum() == 5
    filled = grid[grid > -100]
    # at ~50 km the normalization term ~0: SNR stays ~20
    assert np.all(np.abs(filled - 20.0) < 1.5)


def test_snr_map_range_gates(tmp_path):
    station = (0.0, 0.0, 0.0)
    _write_log(tmp_path / "20260817-010203_P4_RS41_402.500_sonde.log",
               "P4", 0.01, 0.0, 1000.0)     # ~1 km: inside min_range
    grid, counts = stats.snr_map(str(tmp_path), station)
    assert counts.sum() == 0


def test_rs41_subframe_sidecar(tmp_path):
    """TelemetryLogger writes the 51x16 cal subframe once as binary
    (reference logger.py:280)."""
    from radiosonde_auto_rx_jax.exporters.logfile import TelemetryLogger
    lg = TelemetryLogger(log_directory=str(tmp_path), start_thread=False,
                         save_cal_data=True)
    cal = bytes(range(256)) * 3 + bytes(48)      # 816 = 51*16
    t = dict(datetime="2026-08-17T01:02:03Z", id="S5556667", frame=1,
             lat=1.0, lon=2.0, alt=3.0, type="RS41", freq_float=402.5,
             rs41_calconf51x16=cal.hex().upper())
    lg.write_telemetry(t)
    lg.close()
    sub = list(tmp_path.glob("*_subframe.bin"))
    assert sub and sub[0].read_bytes() == cal


def test_version_check_offline():
    from radiosonde_auto_rx_jax.utils.version import (check_autorx_version,
                                                      version_startup_check)
    assert version_startup_check()
    r = check_autorx_version(timeout=0.2)
    assert r["local"] and "up_to_date" in r
