"""Station control plane + exporter tests."""

import datetime
import os

import numpy as np
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.station import (
    Station, default_config, read_auto_rx_config, telemetry_filter,
    enrich_telemetry)
from radiosonde_auto_rx_jax.station.telemetry import RealtimeVelocityFilter
from radiosonde_auto_rx_jax.utils.geometry import (
    GenericTrack, position_info, time_to_landing)
from radiosonde_auto_rx_jax.exporters.logfile import (
    TelemetryLogger, telemetry_to_log_line)
from radiosonde_auto_rx_jax.exporters.aprs import telemetry_to_aprs_position
from radiosonde_auto_rx_jax.exporters.ozimux import OziUploader
from radiosonde_auto_rx_jax.exporters.sondehub import reformat_data


def _telem(**kw):
    now = datetime.datetime.now(datetime.timezone.utc)
    t = {
        "type": "RS41", "frame": 1234, "id": "S1234567",
        "datetime": now.strftime("%Y-%m-%dT%H:%M:%SZ"),
        "datetime_dt": now,
        "lat": -34.0, "lon": 138.0, "alt": 10000.0,
        "vel_h": 10.0, "vel_v": 5.0, "heading": 90.0,
        "temp": -40.0, "humidity": 50.0, "pressure": 260.0,
        "batt": 2.7, "sats": 9, "freq": "402.500 MHz",
        "freq_float": 402.5, "aprsid": "S1234567",
    }
    t.update(kw)
    return t


def test_position_info():
    info = position_info((-34.0, 138.0, 100.0), (-34.5, 138.5, 10000.0))
    assert 60e3 < info["great_circle_distance"] < 80e3
    assert 0 < info["bearing"] < 360
    assert info["elevation"] > 0


def test_generic_track_descent():
    tr = GenericTrack()
    t0 = datetime.datetime.now(datetime.timezone.utc)
    for i in range(8):
        st = tr.add_telemetry({"time": t0 + datetime.timedelta(seconds=10 * i),
                               "lat": -34.0, "lon": 138.0 + 0.001 * i,
                               "alt": 10000.0 - 60.0 * i})
    assert st["is_descending"]
    assert st["ascent_rate"] < -5.0
    assert st["time_to_landing"] is not None


def test_time_to_landing():
    t = time_to_landing(10000.0, 20.0)
    assert 600 < t < 3600
    assert time_to_landing(10000.0, -5.0) is None


def test_telemetry_filter_accepts_valid():
    cfg = default_config()
    assert telemetry_filter(_telem(), cfg) == "OK"


def test_telemetry_filter_rejects():
    cfg = default_config()
    assert telemetry_filter(_telem(lat=0.0, lon=0.0), cfg) is False
    assert telemetry_filter(_telem(alt=60000), cfg) is False
    assert telemetry_filter(_telem(sats=3), cfg) is False
    assert telemetry_filter(_telem(id="12345678"), cfg) is False  # bad serial
    old = datetime.datetime.now(datetime.timezone.utc) - \
        datetime.timedelta(hours=7)
    assert telemetry_filter(_telem(datetime_dt=old), cfg) is False


@pytest.mark.parametrize("typ,good,bad", [
    # per-type serial grammar (round-4 verdict #4; reference
    # auto_rx.py:566-725 plus the decoders' actual formats)
    ("RS41", "S1234567", "1234567"),
    ("RS41", "P0351234", "s1234567"),
    ("RS92", "M1234567", "M123456"),
    ("M10", "M10-305-3-11234", "M10-GARBAGE"),
    ("M10", "M10-A05-3-11234", "M10-305-3-1123"),
    ("M20", "M20-305-3-11234", "M20-3Q5-3-11234"),
    ("LMS6", "LMS6-7654321", "LMS6-76X4321"),
    ("DFM", "DFM-21054321", "DFM-xxxxxxxx"),
    ("DFM06", "DFM-A1B2C3", "DFM-a1b2c3"),     # DFM-06 serials are hex
    ("DFM09", "DFM-19123456", "DFM-"),
    # a Vaisala-looking serial must NOT bypass a non-Vaisala type's
    # grammar (the Vaisala regex is gated on RS41/RS92 types)
    ("MTS01", "MTS01-C1234567", "C1234567"),
    ("IMET5", "IMET5-54001234", "IMET5-54x01234"),
    ("IMET4", "IMET-1A2B3C4D", "IMET-NOTHEX0"),
    ("MTS01", "MTS01-T7654321", "MTS01-"),
    # MTS-01 serials are free-form ASCII and may contain separators;
    # whitespace is still rejected (breaks APRS object names)
    ("MTS01", "MTS01-T-12_34", "MTS01-T 1234"),
    ("WXR301", "WXR-30112233", "WXR-30112x33"),
    ("MRZ", "MRZ-30112-21055", "MRZ-30112-xxxxx"),
    ("IMS100", "IMS100-2304123", "IMS100-xxxxxx"),
    ("RS11G", "RS11G-1234567", "RS11G-"),
    ("RD94", "123456789", "000000000"),
    ("RD41", "987654321", "98765432"),
])
def test_telemetry_filter_serial_formats(typ, good, bad):
    cfg = default_config()
    assert telemetry_filter(_telem(type=typ, id=good), cfg) == "OK", \
        (typ, good)
    assert telemetry_filter(_telem(type=typ, id=bad), cfg) is False, \
        (typ, bad)


def test_telemetry_filter_radius_block():
    cfg = default_config()
    cfg.update(station_lat=-34.0, station_lon=138.0,
               max_radius_km=50, radius_temporary_block=True)
    far = _telem(lat=-40.0, lon=145.0)
    assert telemetry_filter(far, cfg) == "TempBlock"


def test_realtime_velocity_filter():
    f = RealtimeVelocityFilter(100.0)
    t1 = _telem()
    assert f.check(t1)
    t2 = _telem(lat=-35.0,
                datetime_dt=t1["datetime_dt"]
                + datetime.timedelta(seconds=10))
    assert not f.check(t2)   # 111 km in 10 s


def test_enrich_telemetry_time_only():
    t = {"type": "IMET5", "frame": 100, "id": "IMET5-54001",
         "datetime": "12:34:56Z", "lat": 1.0, "lon": 2.0, "alt": 3.0}
    e = enrich_telemetry(t, freq_hz=402.5e6)
    assert e["datetime_dt"].hour == 12
    assert e["freq"] == "402.500 MHz"


def test_imet_unique_id_generated():
    t = {"type": "IMET", "frame": 100, "id": "IMET-xxxx",
         "datetime": "12:34:56Z", "lat": 1.0, "lon": 2.0, "alt": 3.0}
    e = enrich_telemetry(t, freq_hz=402.5e6)
    assert e["id"].startswith("IMET-") and len(e["id"]) == 13
    # deterministic
    e2 = enrich_telemetry(t, freq_hz=402.5e6)
    assert e["id"] == e2["id"]


def test_log_line_format():
    line = telemetry_to_log_line(_telem())
    fields = line.strip().split(",")
    assert len(fields) == 20
    assert fields[1] == "S1234567"
    assert fields[12] == "RS41"


def test_telemetry_logger(tmp_path):
    lg = TelemetryLogger(str(tmp_path), start_thread=False)
    lg.write_telemetry(_telem())
    lg.write_telemetry(_telem(frame=1235))
    lg.close()
    files = list(tmp_path.glob("*_sonde.log"))
    assert len(files) == 1
    lines = files[0].read_text().splitlines()
    assert lines[0].startswith("timestamp,")
    assert len(lines) == 3


def test_aprs_packet_format():
    pkt, name = telemetry_to_aprs_position(
        _telem(), object_name="<id>",
        aprs_comment="Radiosonde <freq> <id>")
    assert name == "S1234567"
    assert pkt.startswith(";S1234567")
    assert "3400.00S" in pkt and "13800.00E" in pkt
    assert "/A=032808" in pkt          # 10000 m in feet
    assert "402.500 MHz" in pkt


def test_ozimux_sentence():
    s = OziUploader.make_sentence(_telem())
    assert s.startswith("TELEMETRY,")
    assert ",-34.00000,138.00000,10000\n" in s


def test_sondehub_reformat():
    out = reformat_data(_telem(), user_callsign="TEST")
    assert out["manufacturer"] == "Vaisala"
    assert out["type"] == "RS41"
    assert out["serial"] == "S1234567"
    assert out["frame"] == 1234
    # DFM: serial strip + slower uploads flag
    dfm = _telem(type="DFM", id="DFM-21012345", subtype="0xA:DFM09")
    out = reformat_data(dfm)
    assert out["serial"] == "21012345"
    assert out["_slower_uploads"]
    # encrypted dropped
    assert reformat_data(_telem(encrypted=True)) is None


def test_config_roundtrip(tmp_path):
    cfg_file = tmp_path / "station.cfg"
    cfg_file.write_text(
        "[search_params]\nmin_freq = 400.05\nmax_freq = 403.0\n"
        "[location]\nstation_lat = -34.9\n"
        "[aprs]\naprs_enabled = True\n")
    cfg = read_auto_rx_config(str(cfg_file))
    assert cfg["min_freq"] == 400.05
    assert cfg["station_lat"] == -34.9
    assert cfg["aprs_enabled"] is True
    assert cfg["sondehub_enabled"] is True   # default preserved


class _CollectExporter:
    def __init__(self):
        self.items = []

    def add(self, t):
        self.items.append(t)

    def close(self):
        pass


def test_station_full_cycle():
    """Wideband capture -> Station.process_capture -> exporter."""
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod
    from radiosonde_auto_rx_jax.models.rs41 import (
        encode_frame, frame_to_bits, make_calibytes)
    from radiosonde_auto_rx_jax.ops.channelizer import channel_freqs

    rng = np.random.default_rng(5)
    cfg = {"capture_rate": 2_400_000, "num_channels": 50,
           "station_lat": 0.0, "station_lon": 0.0}
    col = _CollectExporter()
    st = Station(cfg, exporters=[col], center_freq_hz=402.5e6)

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
            frame_nb=900 + i, sonde_id="T1357911", week=week,
            tow_ms=tow_ms + i * 1000, lat=-34.5, lon=138.6, alt=12000.0,
            calibytes=cal, calfr=i)) for i in range(3)] +
        [rng.integers(0, 2, 400)])
    wide = gfsk_mod(tx_bits, st.fs_wide, 4800, 2, st.freqs[5], 4800, bt=0.5)
    wide += (rng.standard_normal(len(wide)) +
             1j * rng.standard_normal(len(wide))).astype(np.complex64) * 0.002

    telems = st.process_capture(wide.astype(np.complex64))
    assert telems, "station produced no telemetry"
    t = telems[-1]
    assert t["id"] == "T1357911"
    assert abs(t["lat"] + 34.5) < 1e-4
    assert abs(t["freq_float"] - (402.5 + st.freqs[5] / 1e6)) < 1e-6
    assert col.items, "exporter did not receive telemetry"
    assert st.stats["frames_ok"] >= 1


def test_station_imet4_afsk_cycle():
    """iMet-4 (FM-carried Bell-202 AFSK) through scan -> detect -> AFSK
    chain -> telemetry with the synthetic IMET-xxxxxxxx ID."""
    from radiosonde_auto_rx_jax.models.imet4 import (
        afsk_modulate, encode_frame_bits, encode_gps_packet,
        encode_eptu_packet)
    rng = np.random.default_rng(1)
    frame = encode_frame_bits(
        [encode_gps_packet(lat=45.46, lon=9.19, alt=2500),
         encode_eptu_packet()], sync_bits=160)
    tx = np.concatenate([rng.integers(0, 2, 150), frame, frame,
                         rng.integers(0, 2, 300)]).astype(np.uint8)
    fs = 2_400_000
    audio = afsk_modulate(tx, fs=fs).astype(np.float64)
    ph = 2 * np.pi * np.cumsum(3000.0 * audio + 48000 * 8) / fs
    wide = np.exp(1j * ph).astype(np.complex64)
    wide += (rng.standard_normal(len(wide)) + 1j *
             rng.standard_normal(len(wide))).astype(np.complex64) * 0.002
    col = _CollectExporter()
    st = Station({"capture_rate": fs, "num_channels": 50,
                  "sonde_time_threshold": 24},
                 exporters=[col], center_freq_hz=402.5e6)
    telems = st.process_capture(wide)
    assert telems, "no iMet telemetry through the station"
    t = telems[-1]
    assert t["type"] == "IMET" and t["id"].startswith("IMET-")
    assert abs(t["lat"] - 45.46) < 1e-3
    assert st.active and list(st.active.values())[0]["type"] == "IMET4"


def test_station_wideband_mk2lms_channel():
    """LMS6-1680/MK2A on a 240 kHz wideband-station channel
    (reference decode.py:661-699): 601/600 resample -> 9616 Bd demod."""
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn
    from radiosonde_auto_rx_jax.models.mk2lms import encode_flight_bits
    from radiosonde_auto_rx_jax.ops.resample import resample_planes
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    raw = encode_flight_bits(sid32=7654321, n_frames=4, lat=51.0, lon=7.0,
                             alt=15000.0)
    tx = np.concatenate([np.tile([1, 0], 300), raw,
                         np.tile([1, 0], 300)]).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, 240400, 9616, 2, 0.0, 100000, bt=1.0),
                  18.0, 240400, 9616)
    ch240 = resample_planes(np.stack([iq.real, iq.imag]).astype(np.float32),
                            240400, 240000)
    col = _CollectExporter()
    st = Station({"capture_rate": 2_400_000, "num_channels": 10,
                  "sonde_time_threshold": 48},
                 exporters=[col], center_freq_hz=1680e6)
    assert st.fs_ch == 240000
    telems = st.decode_channel(jnp.asarray(np.asarray(ch240)), 2, "MK2LMS")
    assert telems
    t = telems[-1]
    assert t["id"] == "LMS6-7654321" and t["subtype"] == "MK2A"
    assert abs(t["lat"] - 51.0) < 1e-4


def test_station_only_scan_whitelist():
    """only_scan skips the PSD pass and scans exactly the whitelist."""
    st = Station({"capture_rate": 2_400_000, "num_channels": 50,
                  "only_scan": [402.5 + 48000 * 3 / 1e6]},
                 exporters=[], center_freq_hz=402.5e6)
    rng = np.random.default_rng(0)
    wide = (rng.standard_normal((2, 240_000)) * 0.01).astype(np.float32)
    chans = st.scan(wide)
    assert chans == [(3, 0.0)]


def test_station_dfm_true_baud_channel():
    """DFM at its true 2500 Bd through a 48 kHz station channel (the
    chain resamples to 50 kHz; 2400 Bd on 48 kHz would be 4% off)."""
    import jax.numpy as jnp
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn
    from radiosonde_auto_rx_jax.models.dfm import encode_flight_bits
    from radiosonde_auto_rx_jax.ops.resample import resample_planes
    raw = encode_flight_bits(sn=21055555, lat=50.1, lon=8.68, n_cycles=4)
    idle = np.tile(np.array([1, 0], np.uint8), 300)
    tx = np.concatenate([idle, raw, idle])
    # true rate: generate at 50 kHz, view through the 48 kHz channel
    iq = add_awgn(gfsk_mod(tx, 50000, 2500, 2, 0.0, 5000), 15.0,
                  50000, 2500)
    ch48 = resample_planes(np.stack([iq.real, iq.imag]).astype(np.float32),
                           50000, 48000)
    col = _CollectExporter()
    st = Station({"capture_rate": 2_400_000, "num_channels": 50,
                  "sonde_time_threshold": 1e9},
                 exporters=[col], center_freq_hz=402.5e6)
    telems = st.decode_channel(jnp.asarray(np.asarray(ch48)), 9, "DFM")
    assert telems, "no DFM telemetry through the station chain"
    t = telems[-1]
    assert t["id"] == "DFM-21055555"
    assert abs(t["lat"] - 50.1) < 1e-4


def test_encrypted_sonde_drops_and_blocks():
    """close_on_encrypted: drop the channel and add a temporary block
    (reference decode.py:1697 + auto_rx.py temp block handling)."""
    st = Station({"capture_rate": 2_400_000, "num_channels": 50},
                 exporters=[], center_freq_hz=402.5e6)

    class FakeDecoder:
        def decode_bits(self, bits, soft=None):
            import datetime
            now = datetime.datetime.now(datetime.timezone.utc)
            return [dict(type="RS41", subtype="RS41-SGM", id="S0000001",
                         frame=1, datetime=now.strftime(
                             "%Y-%m-%dT%H:%M:%SZ"),
                         lat=0.0, lon=0.0, alt=1000.0, encrypted=True)]

    fz = st.freq_of_channel(4)
    st.active[fz] = dict(type="RS41", decoder=FakeDecoder(), last_ok=0.0)
    out = st._decode_frames(fz, "RS41", np.zeros(100, np.uint8), None,
                            10.0, None)
    assert out == []
    assert fz not in st.active, "channel not dropped"
    assert st.temporary_blocks, "no temporary block added"
    assert st._blocked(fz)


def test_clean_task_list_reaps_idle():
    st = Station({"capture_rate": 2_400_000, "num_channels": 50,
                  "rx_timeout": 0.01}, exporters=[],
                 center_freq_hz=402.5e6)
    st.active[3] = dict(type="RS41", decoder=object(), last_ok=0.0)
    st.clean_task_list()
    assert 3 not in st.active


def test_station_dfm_full_cycle():
    """Wideband DFM at true 2500 Bd: PSD scan -> detect -> resampled
    chain -> telemetry (completes the detect->chain link for DFM)."""
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod
    from radiosonde_auto_rx_jax.models.dfm import encode_flight_bits
    rng = np.random.default_rng(8)
    raw = encode_flight_bits(sn=21031415, lat=47.37, lon=8.54,
                             n_cycles=3)
    idle = np.tile(np.array([1, 0], np.uint8), 150)
    tail = np.tile(np.array([1, 0], np.uint8), 500)
    tx = np.concatenate([idle, raw, tail])
    fs = 2_400_000
    off = 48000 * 11
    wide = gfsk_mod(tx, fs, 2500, 2, off, 5000, bt=1.0)
    wide += (rng.standard_normal(len(wide)) + 1j *
             rng.standard_normal(len(wide))).astype(np.complex64) * 0.002
    col = _CollectExporter()
    st = Station({"capture_rate": fs, "num_channels": 50,
                  "sonde_time_threshold": 1e9,
                  "enable_realtime_filter": False},
                 exporters=[col], center_freq_hz=402.5e6)
    telems = st.process_capture(wide.astype(np.complex64))
    assert telems, "no DFM telemetry through the full station cycle"
    t = telems[-1]
    assert t["id"] == "DFM-21031415"
    assert abs(t["lat"] - 47.37) < 1e-4
    assert st.active and list(st.active.values())[0]["type"] == "DFM"


def test_aprs_station_beacon_packet():
    """Station beacon packet format (reference aprs.py
    generate_station_object :166-258) + cadence gating."""
    from radiosonde_auto_rx_jax.exporters.aprs import (APRSUploader,
                                                       generate_station_object)
    pkt = generate_station_object("N0CALL", -34.5, 138.6,
                                  comment="gate v<version>", icon="/r")
    assert pkt.startswith("!34")
    assert "S/" in pkt and "E" in pkt and pkt.endswith("!")
    assert "<version>" not in pkt

    up = APRSUploader(start_thread=False, station_beacon=True,
                      station_beacon_rate=30,
                      station_beacon_position=(-34.5, 138.6, 50.0))
    sent = []
    up.upload_packet = lambda p: sent.append(p)
    up.beacon_station_position()
    assert len(sent) == 1
    up.beacon_station_position()          # within cadence: no re-send
    assert len(sent) == 1
    # 0,0 position refused
    up2 = APRSUploader(start_thread=False, station_beacon=True)
    up2.upload_packet = lambda p: sent.append(p)
    up2.beacon_station_position()
    assert len(sent) == 1


def test_email_nearby_landing_notification():
    """Landing notification: ascent above threshold then sustained
    descent below it within range triggers ONE nearby-landing e-mail
    (reference email_notification.py:220-300)."""
    import datetime
    from radiosonde_auto_rx_jax.exporters.email_notification import \
        EmailNotification
    en = EmailNotification(station_position=(-34.0, 138.6, 50.0),
                           launch_notifications=False,
                           landing_notifications=True,
                           landing_descent_trip=3)
    sent = []
    en.send_notification_email = \
        lambda msg, subject=None: sent.append((subject, msg))
    t0 = datetime.datetime.now(datetime.timezone.utc)

    def frame(i, alt):
        return dict(id="S1234567", type="RS41", freq="401.5 MHz",
                    lat=-34.01, lon=138.61, alt=alt,
                    datetime_dt=t0 + datetime.timedelta(seconds=5 * i))

    # ascent above the 1000 m threshold
    for i, alt in enumerate([500, 1500, 3000, 5000]):
        en.add(frame(i, alt))
    assert not sent
    # descend fast below threshold: the averaged ascent rate needs a few
    # frames to turn negative, then 3-trip + 1 to fire
    alts = [950 - 50 * j for j in range(10)]
    for j, alt in enumerate(alts):
        en.add(frame(10 + j, alt))
    assert len(sent) == 1, "landing notification not sent"
    subject, msg = sent[0]
    assert "S1234567" in subject and "Nearby" in subject
    assert "Range:" in msg and "sondehub.org" in msg
    # no duplicates
    en.add(frame(30, 400))
    assert len(sent) == 1


def test_aprs_object_name_padded_to_9():
    """APRS object names are a fixed 9-byte field: an 8-char serial must
    be space-padded before the '*' or every later fixed-position field
    shifts (round-4 review; reference aprs.py pads with ljust(9))."""
    pkt, name = telemetry_to_aprs_position(
        _telem(), object_name="<id>", aprs_comment="x")
    assert name == "S1234567"
    head, rest = pkt[1:].split("*", 1)
    assert len(head) == 9 and head == "S1234567 "
    assert rest[6] == "h"               # HHMMSS timestamp right after


def test_config_scan_lists_parse():
    """only_scan/never_scan/always_scan/always_decode must parse from
    [search_params] (round-4 review: they were missing from _SECTIONS,
    silently ignoring reference blacklist/whitelist configs)."""
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "station.cfg")
        with open(p, "w") as f:
            f.write("[search_params]\nnever_scan = 402.5, 403.2\n"
                    "always_decode = 404.1\nonly_scan =\n")
        cfg = read_auto_rx_config(p)
    assert cfg["never_scan"] == [402.5, 403.2]
    assert cfg["always_decode"] == [404.1]
    assert cfg["only_scan"] == []


def test_scan_never_scan_survives_centroid():
    """never_scan must hold even when the blocked signal's power pulls
    a NEIGHBORING raster point's centroid back onto the blocked
    frequency (round-5 review finding: the raster prefilter alone let
    a blocked 402.745 MHz interferer re-enter via the 402.740 raster
    point's centroid window)."""
    f_block = 402.745          # MHz, 5 kHz off the 10 kHz raster
    st = Station({"capture_rate": 768_000, "num_channels": 16,
                  "never_scan": [f_block]},
                 exporters=[], center_freq_hz=402.5e6)
    rng = np.random.default_rng(0)
    T = 768_000
    t = np.arange(T)
    tone = 0.5 * np.exp(2j * np.pi * (f_block * 1e6 - 402.5e6) *
                        t / 768_000)
    wide = tone + (rng.standard_normal(T) +
                   1j * rng.standard_normal(T)) * 0.002
    planes = np.stack([wide.real, wide.imag]).astype(np.float32)
    for ci, off in st.scan(planes):
        fq = st._chan_center(ci) + off
        assert abs(fq - f_block * 1e6) >= 5e3, \
            f"blocked frequency re-entered the scan: {fq}"
