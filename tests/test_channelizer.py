"""PFB channelizer tests + full wideband station end-to-end."""

import numpy as np
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.ops.channelizer import (
    channel_freqs, channelize, pfb_prototype)

FS_WIDE = 2_400_000
N_CHAN = 50          # 48 kHz channels


def test_tone_channel_mapping():
    T = FS_WIDE // 10
    t = np.arange(T) / FS_WIDE
    freqs = channel_freqs(N_CHAN, FS_WIDE)
    iq = (np.exp(2j * np.pi * freqs[7] * t) +
          0.5 * np.exp(2j * np.pi * freqs[30] * t)).astype(np.complex64)
    ch = np.asarray(channelize(jnp.asarray(iq), N_CHAN))
    power = (ch ** 2).sum(axis=(1, 2))
    top = np.argsort(power)[::-1]
    assert set(top[:2]) == {7, 30}
    # adjacent-channel leakage well below -40 dB
    assert power[6] / power[7] < 1e-4
    assert power[8] / power[7] < 1e-4


def test_in_channel_offset_preserved():
    T = FS_WIDE // 10
    t = np.arange(T) / FS_WIDE
    freqs = channel_freqs(N_CHAN, FS_WIDE)
    iq = np.exp(2j * np.pi * (freqs[7] + 10e3) * t).astype(np.complex64)
    z = np.asarray(channelize(jnp.asarray(iq), N_CHAN))[7]
    zz = z[0] + 1j * z[1]
    inst = np.diff(np.unwrap(np.angle(zz[1000:2000]))) * \
        (FS_WIDE / N_CHAN) / (2 * np.pi)
    assert abs(inst.mean() - 10e3) < 100


def test_wideband_station_end_to_end():
    """2.4 MHz capture with an RS41 and a DFM at different frequencies:
    channelize -> PSD peak scan -> type detect -> demod -> telemetry.

    This is the reference's whole station loop (scan.py sonde_search ->
    detect_sonde -> decode.py chain) as one batched dataflow.
    """
    from radiosonde_auto_rx_jax.demod import FSKConfig, fsk_demod_stream
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod
    from radiosonde_auto_rx_jax.detect import power_spectrum, scan_peaks
    from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
    from radiosonde_auto_rx_jax.models.rs41 import (
        RS41Decoder, encode_frame, frame_to_bits, make_calibytes)

    fs_ch = FS_WIDE // N_CHAN
    freqs = channel_freqs(N_CHAN, FS_WIDE)
    rng = np.random.default_rng(11)

    # RS41 frames on channel 5, plus a plain-carrier interferer on ch 44
    cal = make_calibytes()
    tx_bits = np.concatenate(
        [rng.integers(0, 2, 400)] +
        [frame_to_bits(encode_frame(
            frame_nb=700 + i, sonde_id="S2468101", week=2200,
            tow_ms=(86400 + 7200) * 1000 + i * 1000, lat=52.2, lon=0.12,
            alt=18000.0, calibytes=cal, calfr=i)) for i in range(3)] +
        [rng.integers(0, 2, 400)])
    # synthesize the RS41 directly at the wideband rate, centered on ch 5
    wide = gfsk_mod(tx_bits, FS_WIDE, 4800, 2, freqs[5], 4800, bt=0.5)
    T = len(wide)
    t = np.arange(T) / FS_WIDE
    wide = wide + 0.3 * np.exp(2j * np.pi * (freqs[44] + 3e3) * t)
    wide += (rng.standard_normal(T) + 1j * rng.standard_normal(T)
             ).astype(np.complex64) * 0.002
    wide = wide.astype(np.complex64)

    # 1. PSD scan finds both carriers
    pfreqs, psd = power_spectrum(jnp.asarray(wide), nfft=2048, fs=FS_WIDE)
    peaks, nf = scan_peaks(psd, pfreqs, snr_threshold=10.0,
                           min_distance_hz=40e3, quantization_hz=48e3)
    assert any(abs(p - freqs[5]) < 24e3 for p in peaks), peaks
    assert any(abs(p - freqs[44]) < 24e3 for p in peaks), peaks

    # 2. channelize + detect type per candidate channel
    ch = channelize(jnp.asarray(wide), N_CHAN)
    det = SondeDetector(fs_ch)
    res = det.detect(ch[np.array([5, 44])])
    assert res[0] and res[0][0].name == "RS41", res[0]
    assert not res[1], f"carrier-only channel misdetected: {res[1]}"

    # 3. demodulate + decode channel 5 to telemetry
    cfg = FSKConfig(fs=fs_ch, rs=4800, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    soft, bits, stats, _ = fsk_demod_stream(cfg, ch[5][None])
    telems = RS41Decoder().decode_bits(np.asarray(bits)[0])
    assert telems, "no telemetry from wideband chain"
    assert telems[-1]["id"] == "S2468101"
    assert abs(telems[-1]["lat"] - 52.2) < 1e-4
