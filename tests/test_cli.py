"""Station CLI (station.main): arg parsing, exporter wiring, replay loop."""

import datetime
import json
import urllib.request

import numpy as np

from radiosonde_auto_rx_jax.station import main as cli


def test_parse_args_defaults():
    args = cli.parse_args([])
    assert args.config is None and args.frequency is None
    assert args.timeout == 0 and not args.verbose
    args = cli.parse_args(["-f", "402.5", "-m", "RS41", "-t", "10", "-v"])
    assert args.frequency == 402.5 and args.sonde_type == "RS41"
    assert args.timeout == 10 and args.verbose


def test_build_exporters_config_gated(tmp_path):
    from radiosonde_auto_rx_jax.station.config import default_config
    cfg = default_config()
    cfg["log_directory"] = str(tmp_path)
    cfg["sondehub_enabled"] = False
    exps = cli.build_exporters(cfg)
    names = [type(e).__name__ for e in exps]
    assert names == ["TelemetryLogger"]
    for e in exps:
        e.close()
    cfg["sondehub_enabled"] = True
    cfg["ozi_enabled"] = True
    exps = cli.build_exporters(cfg)
    names = [type(e).__name__ for e in exps]
    assert "SondehubUploader" in names and "OziUploader" in names
    for e in exps:
        e.close()


def test_missing_source_exits_config():
    assert cli.main(["--no-web"]) == cli.EXIT_CONFIG


def _rs41_wideband(path, freq_off_hz, fs=2_400_000):
    """Write a cs16 wideband capture with an RS41 burst at freq_off_hz."""
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod
    from radiosonde_auto_rx_jax.models.rs41 import (
        encode_frame, frame_to_bits, make_calibytes)
    rng = np.random.default_rng(11)
    now = datetime.datetime.now(datetime.timezone.utc)
    week = (now - datetime.datetime(1980, 1, 6,
                                    tzinfo=datetime.timezone.utc)).days // 7
    dow = (now.weekday() + 1) % 7
    tow_ms = ((dow * 24 + now.hour) * 3600 + now.minute * 60 +
              now.second) * 1000
    cal = make_calibytes()
    tx = np.concatenate(
        [rng.integers(0, 2, 400)] +
        [frame_to_bits(encode_frame(
            frame_nb=700 + i, sonde_id="C2468101", week=week,
            tow_ms=tow_ms + i * 1000, lat=51.5, lon=-0.12, alt=8000.0,
            calibytes=cal, calfr=i)) for i in range(3)] +
        [rng.integers(0, 2, 400)])
    wide = gfsk_mod(tx, fs, 4800, 2, freq_off_hz, 4800, bt=0.5)
    wide += (rng.standard_normal(len(wide)) +
             1j * rng.standard_normal(len(wide))).astype(np.complex64) * 0.002
    w = np.empty(2 * len(wide), np.int16)
    w[0::2] = np.clip(wide.real * 16000, -32768, 32767).astype(np.int16)
    w[1::2] = np.clip(wide.imag * 16000, -32768, 32767).astype(np.int16)
    path.write_bytes(w.tobytes())
    return len(wide) / fs


def test_replay_single_frequency_decode(tmp_path):
    """Full CLI run: cs16 replay file -> telemetry into the log exporter."""
    cap = tmp_path / "cap.cs16"
    freqs_off = 48000 * 5          # channel 5 of 50 @ 2.4 MHz
    secs = _rs41_wideband(cap, freqs_off)
    logdir = tmp_path / "log"
    rc = cli.main(["--replay", str(cap), "--no-web",
                   "--block-seconds", str(secs),
                   "-f", str((402.5e6 + freqs_off) / 1e6), "-m", "RS41",
                   "--log-dir", str(logdir)])
    assert rc == cli.EXIT_OK
    logs = list(logdir.glob("*_sonde.log"))
    assert logs, "no per-sonde log written"
    text = logs[0].read_text()
    assert "C2468101" in text


def test_replay_scan_mode_web(tmp_path):
    """Scan mode over noise: runs, serves the web API, exits cleanly."""
    cap = tmp_path / "noise.cs16"
    rng = np.random.default_rng(3)
    raw = (rng.standard_normal(2 * 240_000) * 300).astype(np.int16)
    cap.write_bytes(raw.tobytes())

    from radiosonde_auto_rx_jax.station.config import default_config
    from radiosonde_auto_rx_jax.web.server import WebExporter, WebServer
    from radiosonde_auto_rx_jax.station.station import Station
    # drive run_station directly so we can grab the ephemeral web port
    args = cli.parse_args(["--replay", str(cap), "--block-seconds", "0.1",
                           "--log-dir", str(tmp_path / "log")])
    cfg = default_config()
    cfg["sondehub_enabled"] = False
    cfg["web_port"] = 0
    cfg["web_host"] = "127.0.0.1"
    rc = cli.run_station(args, cfg)
    assert rc == cli.EXIT_OK


def test_web_server_endpoints(tmp_path):
    from radiosonde_auto_rx_jax.web.server import WebExporter, WebServer
    web = WebServer(station=None, web_exporter=WebExporter(),
                    config={"web_password": "x"}, host="127.0.0.1", port=0)
    web.start()
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{web.port}/get_version") as r:
            v = json.loads(r.read())
        assert "version" in v
    finally:
        web.close()


def test_emulate_mode(tmp_path):
    """--emulate replays a per-sonde log through the exporter chain."""
    from radiosonde_auto_rx_jax.exporters.logfile import (
        LOG_HEADER, telemetry_to_log_line)
    lines = [LOG_HEADER]
    for i in range(6):
        lines.append(telemetry_to_log_line(dict(
            datetime="2026-08-17T01:02:%02dZ" % i, id="E1239876", frame=i,
            lat=10.0, lon=20.0 + i * 1e-4, alt=5000.0 + 10 * i, vel_v=5.0,
            vel_h=10.0, heading=90.0, temp=-20.0, humidity=50.0,
            pressure=-1, type="RS41", freq_float=402.5, snr=15.0,
            f_error=0, sats=9, batt=2.9)))
    src = tmp_path / "20260817-010203_E1239876_RS41_402.500_sonde.log"
    src.write_text("".join(ln if ln.endswith("\n") else ln + "\n"
                           for ln in lines))
    logdir = tmp_path / "out"
    rc = cli.main(["--emulate", str(src), "--no-web",
                   "--log-dir", str(logdir)])
    assert rc == cli.EXIT_OK
    out = list(logdir.glob("*_sonde.log"))
    assert out and "E1239876" in out[0].read_text()
