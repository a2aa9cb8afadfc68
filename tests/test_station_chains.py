"""Station chain-rate regression: every CHAIN_TABLE type decodes a
signal synthesized at its TRUE on-air raw symbol rate through the 48 kHz
channel view (resampled chains emulate the channel by down-resampling).

This is the test class that caught the DFM 2400-vs-2500 and dropsonde
9600-vs-4800 chain-rate bugs — bit-level decoder tests can't see a wrong
demod rate."""

import numpy as np
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_jax.ops.resample import resample_planes
from radiosonde_auto_rx_jax.station.station import CHAIN_TABLE, Station


class _Col:
    def __init__(self):
        self.items = []

    def add(self, t):
        self.items.append(t)

    def close(self):
        pass


def _station():
    return Station({"capture_rate": 2_400_000, "num_channels": 50,
                    "sonde_time_threshold": 1e9,
                    "enable_realtime_filter": False},
                   exporters=[_Col()], center_freq_hz=402.5e6)


def _meisei_bits():
    from radiosonde_auto_rx_jax.models.meisei import (
        encode_subframes_ims100, frames_to_raw_bits)
    frames = [encode_subframes_ims100(c, sn=2304123.0, lat=36.1,
                                      lon=140.08, alt=9000.0)
              for c in (16, 17)]
    return frames_to_raw_bits(frames), ("IMS100-2304123", "lat", 36.1)


def _mrz_bits():
    from radiosonde_auto_rx_jax.models.mrz import encode_flight_bits
    return (encode_flight_bits(snC=30112, snD=21055, lat=55.75, lon=37.62,
                               alt=7500.0),
            ("MRZ-30112-21055", "lat", 55.75))


def _mts01_bits():
    from radiosonde_auto_rx_jax.models.mts01 import (encode_frame,
                                                     frame_to_bits)
    bits = np.concatenate([frame_to_bits(encode_frame(
        sid="T7654321", frnr=10 + i, lat=46.05, lon=14.51, alt=2000.0))
        for i in range(4)])
    return bits, ("MTS01-T7654321", "lat", 46.05)


def _imet54_bits():
    from radiosonde_auto_rx_jax.models.imet54 import (encode_frame,
                                                      encode_raw_bits)
    bits = np.concatenate([encode_raw_bits(encode_frame(
        sn=54001234, lat=51.5, lon=7.25, alt=3000.0))
        for _ in range(3)])
    return bits, ("IMET5-54001234", "lat", 51.5)


def _wxr_bits():
    from radiosonde_auto_rx_jax.models.weathex import (encode_frame,
                                                       frame_to_bits)
    gap = np.tile(np.array([1, 0], np.uint8), 30)
    bits = np.concatenate(sum(([frame_to_bits(encode_frame(
        frid=i, sn=30112233, lat=34.7, lon=135.5, alt=6000.0)), gap]
        for i in range(3)), []))
    return bits, (None, "lat", 34.7)


def _dropsonde_bits():
    from radiosonde_auto_rx_jax.models.dropsonde import (
        encode_frame_rd94, frames_to_raw_bits)
    frames = [encode_frame_rd94(frnr=i, lat=25.0, lon=-80.0, alt=4000.0)
              for i in range(3)]
    return frames_to_raw_bits(frames), (None, "lat", 25.0)


def _lms6_bits():
    from radiosonde_auto_rx_jax.models.lms6 import (blocks_to_raw_bits,
                                                    encode_block,
                                                    encode_frame)
    frames = [encode_frame(sn=7123456 & 0xFFFFFF, frnr=100 + i,
                           lat=39.0, lon=-76.9, alt=10000.0,
                           fill_seed=i) for i in range(3)]
    return (blocks_to_raw_bits([encode_block(f) for f in frames]),
            (None, "lat", 39.0))


# (generator, tone spacing Hz, Eb/N0 dB, Gaussian BT)
CASES = {
    "MEISEI": (_meisei_bits, 3600, 16.0, 1.0),
    "MRZ": (_mrz_bits, 6000, 20.0, 2.0),
    "MTS01": (_mts01_bits, 2400, 16.0, 1.0),
    "IMET5": (_imet54_bits, 4800, 16.0, 1.0),
    "RD94RD41": (_dropsonde_bits, 10000, 16.0, 1.0),
    "LMS6": (_lms6_bits, 4800, 16.0, 1.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chain_decodes_true_rate(name):
    gen, spacing, ebno, bt = CASES[name]
    raw, (want_id, fld, want_val) = gen()
    chain = CHAIN_TABLE[name]
    fs_chain = chain.get("resample_to", 48000)
    rs = chain["rs"]
    idle = np.tile(np.array([1, 0], np.uint8), 200)
    # the demod clips ~nmem + one block of tail: pad generously so the
    # last frame stays inside the demodulated region
    tail = np.tile(np.array([1, 0], np.uint8), 500)
    tx = np.concatenate([idle, np.asarray(raw, np.uint8), tail])
    iq = add_awgn(gfsk_mod(tx, fs_chain, rs, 2, 0.0, spacing, bt=bt),
                  ebno, fs_chain, rs)
    planes = np.stack([iq.real, iq.imag]).astype(np.float32)
    if fs_chain != 48000:
        planes = np.asarray(resample_planes(planes, fs_chain, 48000))
    st = _station()
    telems = st.decode_channel(jnp.asarray(planes), 7, name)
    assert telems, f"{name}: no telemetry through the station chain"
    t = telems[-1]
    if want_id is not None:
        assert t["id"] == want_id, t["id"]
    assert abs(t[fld] - want_val) < 1e-3, t


def test_wxr301_wideband_chain():
    """Weathex needs a 96 kHz channel with 50 kHz tone spacing
    (reference decode.py:1388-1414: 96 kHz IQ, mask 50000) — run it on a
    wideband station (25 channels of 2.4 MHz)."""
    raw, (_, fld, want) = _wxr_bits()
    chain = CHAIN_TABLE["WXR301"]
    assert chain.get("wide_fs") == 96000
    idle = np.tile(np.array([1, 0], np.uint8), 200)
    tail = np.tile(np.array([1, 0], np.uint8), 500)
    tx = np.concatenate([idle, np.asarray(raw, np.uint8), tail])
    iq = add_awgn(gfsk_mod(tx, 96000, 4800, 2, 0.0, 50000, bt=1.0),
                  16.0, 96000, 4800)
    planes = np.stack([iq.real, iq.imag]).astype(np.float32)
    st = Station({"capture_rate": 2_400_000, "num_channels": 25,
                  "sonde_time_threshold": 1e9,
                  "enable_realtime_filter": False},
                 exporters=[_Col()], center_freq_hz=402.5e6)
    assert st.fs_ch == 96000
    telems = st.decode_channel(jnp.asarray(planes), 3, "WXR301")
    assert telems, "no Weathex telemetry through the wideband chain"
    assert abs(telems[-1][fld] - want) < 1e-3


def test_rs92_station_chain_with_ephemeris():
    """RS92 through the station chain: the config-injected ephemeris
    feeds the raw-pseudorange Bancroft navigation
    (reference decode.py:423-446 supplies rs92_ephemeris)."""
    from radiosonde_auto_rx_jax.models.rs92 import (encode_flight_bits,
                                                    make_test_ephemeris)
    import jax.numpy as jnp
    ephs = make_test_ephemeris()
    raw = encode_flight_bits(n_frames=2, ephs=ephs, lat=-34.95,
                             lon=138.52, alt=12000.0)
    idle = np.tile(np.array([1, 0], np.uint8), 200)
    tail = np.tile(np.array([1, 0], np.uint8), 700)
    tx = np.concatenate([idle, np.asarray(raw, np.uint8), tail])
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 4800, bt=0.5),
                  16.0, 48000, 4800)
    planes = np.stack([iq.real, iq.imag]).astype(np.float32)
    st = Station({"capture_rate": 2_400_000, "num_channels": 50,
                  "sonde_time_threshold": 1e9,
                  "enable_realtime_filter": False,
                  "rs92_ephemeris": ephs},
                 exporters=[_Col()], center_freq_hz=402.5e6)
    telems = st.decode_channel(jnp.asarray(planes), 7, "RS92")
    assert telems, "no RS92 telemetry through the station chain"
    t = telems[-1]
    assert t["id"] == "R1234567"
    assert abs(t["lat"] + 34.95) < 5e-4
