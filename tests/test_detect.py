"""Detection subsystem tests: template bank, correlation detection across
sonde types, PSD peak scanning, and behavior parity vs dft_detect."""

import numpy as np
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_jax.detect import (
    TEMPLATES, build_template_bank, correlate_bank, detect_types,
    power_spectrum, detect_peaks, scan_peaks)
from tests import oracle

FS = 48000


def _fm_of_header(name, fs=FS, ebno=20.0, lead=400):
    """Synthesize the FM-discriminator stream of a sonde header burst."""
    spec = next(s for s in TEMPLATES if s.name == name)
    bits = np.array([int(c) for c in spec.header], dtype=np.uint8)
    rng = np.random.default_rng(42)
    pre = rng.integers(0, 2, lead)
    post = rng.integers(0, 2, lead)
    tx = np.concatenate([pre, bits, post])
    # NRZ frequency trajectory with Gaussian shaping ~ matched to template
    spb = fs / spec.sps
    import math
    sigma = math.sqrt(math.log(2.0)) / (2 * math.pi * spec.bt) * spb
    T = int(len(tx) * spb)
    i = np.arange(T)
    sym = tx[np.minimum((i / spb).astype(int), len(tx) - 1)]
    fm = sym.astype(np.float64) * 2 - 1
    klen = int(8 * sigma) | 1
    kx = np.arange(klen) - klen // 2
    g = np.exp(-0.5 * (kx / max(sigma, 1e-6)) ** 2)
    fm = np.convolve(fm, g / g.sum(), mode="same")
    noise = rng.normal(0, 10 ** (-ebno / 20), T)
    hdr_end = int((lead + len(bits)) * spb)
    return (fm + noise).astype(np.float32), hdr_end


@pytest.mark.parametrize("name", ["RS41", "DFM", "M10", "MRZ", "LMS6",
                                  "MEISEI", "MTS01", "IMET5"])
def test_detects_each_type(name):
    fm, hdr_end = _fm_of_header(name)
    bank, lens, specs = build_template_bank(FS)
    dets = detect_types(fm, bank, lens, specs, max_det=1)
    assert dets, f"no detection for {name}"
    assert dets[0].name == name, \
        f"wrong type: got {dets[0].name} for {name} (score {dets[0].score})"
    assert dets[0].score >= 0.7
    assert abs(dets[0].position - hdr_end) < 50


def test_inverted_detection():
    fm, _ = _fm_of_header("RS41")
    bank, lens, specs = build_template_bank(FS)
    dets = detect_types(-fm, bank, lens, specs, max_det=1)
    assert dets and dets[0].name == "RS41" and dets[0].inverted


def test_noise_no_detection(rng):
    noise = rng.normal(0, 1.0, FS).astype(np.float32)
    bank, lens, specs = build_template_bank(FS)
    dets = detect_types(noise, bank, lens, specs, max_det=0)
    assert dets == [], f"false positives on noise: {dets}"


def test_batch_channels():
    fm1, _ = _fm_of_header("RS41")
    fm2, _ = _fm_of_header("DFM")
    n = max(len(fm1), len(fm2))
    x = np.zeros((2, n), dtype=np.float32)
    x[0, :len(fm1)] = fm1
    x[1, :len(fm2)] = fm2
    bank, lens, specs = build_template_bank(FS)
    dets = detect_types(x, bank, lens, specs, max_det=1)
    assert dets[0][0].name == "RS41"
    assert dets[1][0].name == "DFM"


def test_freq_offset_estimate():
    fm, _ = _fm_of_header("RS41")
    off = 0.12
    bank, lens, specs = build_template_bank(FS)
    dets = detect_types(fm + off, bank, lens, specs, fm_gain_hz=24000.0)
    assert dets and abs(dets[0].freq_offset - off * 24000) < 600


def test_psd_scan_peaks(rng):
    # two carriers at -100 kHz and +250 kHz in 1 MHz bandwidth
    fs = 1_000_000
    t = np.arange(fs // 4) / fs
    iq = (np.exp(2j * np.pi * -100e3 * t) +
          np.exp(2j * np.pi * 250e3 * t)).astype(np.complex64)
    iq += (rng.standard_normal(len(t)) + 1j * rng.standard_normal(len(t))
           ).astype(np.complex64) * 0.05
    freqs, psd = power_spectrum(jnp.asarray(iq), nfft=1024, fs=fs)
    peaks, nf = scan_peaks(psd, freqs, snr_threshold=10.0)
    assert len(peaks) == 2, f"peaks: {peaks}"
    assert abs(peaks[0] + 100e3) <= 5e3
    assert abs(peaks[1] - 250e3) <= 5e3


def test_detect_peaks_semantics():
    x = np.array([0, 1, 0, 3, 0, 2, 0, 1, 0], dtype=float)
    assert list(detect_peaks(x)) == [1, 3, 5, 7]
    assert list(detect_peaks(x, mph=1.5)) == [3, 5]
    assert list(detect_peaks(x, mpd=3)) == [3, 7]  # 5 suppressed by 3


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_behavior_parity_vs_dft_detect(tmp_path):
    """Same GFSK IQ burst through dft_detect (IQ mode) and our detector:
    both must identify RS41."""
    binp = oracle.binary("dft_detect")
    if binp is None:
        pytest.skip("could not build dft_detect")
    spec = next(s for s in TEMPLATES if s.name == "RS41")
    rng = np.random.default_rng(7)
    bits = np.concatenate([rng.integers(0, 2, 600),
                           np.array([int(c) for c in spec.header]),
                           rng.integers(0, 2, 2000)])
    iq = gfsk_mod(bits, FS, 4800, 2, 0.0, 4800, bt=0.5)
    iq = add_awgn(iq, 15.0, FS, 4800, rng=rng)
    import subprocess
    r = subprocess.run(
        f"{binp} --iq - {FS} 32", shell=True, input=iq.astype(np.complex64
                                                              ).tobytes(),
        capture_output=True, cwd="/tmp/refbuild")
    ref_out = r.stdout.decode()
    assert "RS41" in ref_out, f"reference did not detect RS41: {ref_out!r}"

    # ours: the reference's IQ conditioning (IF lowpass -> FM discriminator
    # -> FM-audio lowpass, dft_detect.c:1021-1111 + :396) then correlate
    from radiosonde_auto_rx_jax.ops.fm import fm_discriminate
    from radiosonde_auto_rx_jax.ops.fir import design_lowpass, fir_filter
    zi = jnp.asarray(iq)[None, :]
    h_if = design_lowpass(6e3 / FS, 97)        # 12 kHz IF class (lpIQ=1)
    zi = fir_filter(zi.real, h_if) + 1j * fir_filter(zi.imag, h_if)
    fm = fm_discriminate(zi)
    h_fm = design_lowpass(4e3 / FS, 97)        # FM-audio lowpass
    fm = np.asarray(fir_filter(fm, h_fm))[0]
    bank, lens, specs = build_template_bank(FS)
    dets = detect_types(fm.astype(np.float32), bank, lens, specs, max_det=1)
    assert dets and dets[0].name == "RS41", f"ours: {dets}"


def test_sonde_detector_end_to_end():
    """SondeDetector: raw IQ in, typed detection out (multi channel)."""
    from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
    rng = np.random.default_rng(3)
    spec_rs41 = next(s for s in TEMPLATES if s.name == "RS41")
    spec_dfm = next(s for s in TEMPLATES if s.name == "DFM")

    def burst(spec, rs, spacing):
        bits = np.concatenate([rng.integers(0, 2, 500),
                               np.array([int(c) for c in spec.header]),
                               rng.integers(0, 2, 1500)])
        iq = gfsk_mod(bits, FS, rs, 2, 0.0, spacing, bt=spec.bt)
        return add_awgn(iq, 15.0, FS, rs, rng=rng)

    iq1 = burst(spec_rs41, 4800, 4800)
    iq2 = burst(spec_dfm, 2500, 6000)
    n = max(len(iq1), len(iq2))
    x = np.zeros((2, n), dtype=np.complex64)
    x[0, :len(iq1)] = iq1
    x[1, :len(iq2)] = iq2

    det = SondeDetector(FS)
    res = det.detect(jnp.asarray(x))
    assert res[0] and res[0][0].name == "RS41", res[0]
    assert res[1] and res[1][0].name == "DFM", res[1]


def test_m10_vs_m20_disambiguation():
    """Detector decodes the flen/type bytes after the M10 header to split
    M10 from M20 (reference frm_M10, dft_detect.c:932-965)."""
    from radiosonde_auto_rx_jax.models.m10 import (
        encode_frame_m10, encode_frame_m20, frame_to_raw_bits)
    spec = next(s for s in TEMPLATES if s.name == "M10")
    bank, lens, specs = build_template_bank(FS)
    for enc, want in ((encode_frame_m10, "M10"), (encode_frame_m20, "M20")):
        raw = frame_to_raw_bits(enc())
        # frame_to_raw_bits includes the raw header; skip template's lead
        rng = np.random.default_rng(7)
        tx = np.concatenate([np.tile([1, 0], 200), raw,
                             rng.integers(0, 2, 200)])
        spb = FS / spec.sps
        T = int(len(tx) * spb)
        i = np.arange(T)
        sym = tx[np.minimum((i / spb).astype(int), len(tx) - 1)]
        fm = (sym.astype(np.float64) * 2 - 1).astype(np.float32)
        fm += np.random.default_rng(8).normal(0, 0.05, T).astype(np.float32)
        dets = detect_types(fm, bank, lens, specs, max_det=1)
        assert dets, f"no detection for {want}"
        assert dets[0].name == want, \
            f"got {dets[0].name}, want {want}"


def test_imet_tone_disambiguation():
    """The shared iMet AFSK preamble resolves to IMET4 by the 2200-Hz
    tone-power check; 2400-Hz-dominant audio (iMet-1 AB) is dropped
    (dft_detect.c:1542-1607)."""
    from radiosonde_auto_rx_jax.detect.correlator import _imet_subtype
    fs = 48000
    t = np.arange(fs) / fs
    # Bell-202-ish audio: 1200 Hz mark + 2200 Hz space energy
    audio = (np.sin(2 * np.pi * 1200 * t)
             + 0.8 * np.sin(2 * np.pi * 2200 * t)).astype(np.float32)
    assert _imet_subtype(audio, 0, fs) == "IMET4"
    assert _imet_subtype(audio, 0, fs, wideband=True) == "IMET1RS"
    # 2400 Hz dominant -> iMet-1 AB territory: dropped
    audio_ab = (np.sin(2 * np.pi * 1200 * t)
                + 0.8 * np.sin(2 * np.pi * 2400 * t)).astype(np.float32)
    assert _imet_subtype(audio_ab, 0, fs) is None


def test_rs41_not_misdetected_as_imet():
    """Regression: RS41 GFSK payload content must not be claimed by the
    iMet templates (the short IMET4/IMET1RS headers false-matched payload
    until they were made redirect-only, dft_detect.c:1517-1518)."""
    from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
    rng = np.random.default_rng(3)
    det = SondeDetector(48000)
    for trial in range(6):
        tx = rng.integers(0, 2, 4000).astype(np.uint8)
        iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 4800, bt=0.5),
                      20.0, 48000, 4800)
        dets = det.detect(iq, max_det=0)
        for d in dets:
            assert not d.name.startswith("IMET"), (trial, d)


def test_fft_correlate_matches_direct():
    """Overlap-save FFT correlation must equal the grouped conv bit-close
    (the detector defaults to the FFT path on long streams)."""
    from radiosonde_auto_rx_jax.detect.correlator import (_corr_direct,
                                                          _corr_fft)
    from radiosonde_auto_rx_jax.detect.templates import build_template_bank
    bank, lens, _ = build_template_bank(48000)
    bj = jnp.asarray(bank)
    rng = np.random.default_rng(11)
    for C, T in [(2, 20000), (1, 2 * bank.shape[1] + 1)]:
        x = jnp.asarray(rng.standard_normal((C, T)).astype(np.float32))
        a = np.asarray(_corr_direct(x, bj))
        b = np.asarray(_corr_fft(x, bj))
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=5e-5)


def test_corr_toeplitz_matches_direct():
    """Blocked-Toeplitz correlation (RSX_DETECT_CORR=toeplitz) == direct grouped conv,
    including nvalid not a multiple of the block size."""
    from radiosonde_auto_rx_jax.detect.correlator import (_corr_direct,
                                                          _corr_toeplitz)
    rng = np.random.default_rng(1)
    bank = jnp.asarray(rng.standard_normal((8, 800)).astype(np.float32))
    for T in (4800, 4000):
        x = jnp.asarray(rng.standard_normal((3, T)).astype(np.float32))
        a = np.asarray(_corr_direct(x, bank))
        b = np.asarray(_corr_toeplitz(x, bank))
        assert a.shape == b.shape
        assert np.abs(a - b).max() < 2e-3 * np.abs(a).max()


def test_detection_bf16_streams(monkeypatch):
    """RSX_DETECT_DTYPE=bfloat16 runs the detector on bf16 FM streams —
    force the dtype and check a clean burst is still detected with a score
    close to the f32 path."""
    monkeypatch.setenv("RSX_DETECT_DTYPE", "bfloat16")
    from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn
    spec = next(s for s in TEMPLATES if s.name == "RS41")
    fs = 48000
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 2, 600)
    bits = np.concatenate([np.array([int(c) for c in spec.header] * 2),
                           payload])
    iq = add_awgn(gfsk_mod(bits, fs, int(spec.sps), 2, 0.0, 4800,
                           bt=spec.bt), 12.0, fs, int(spec.sps))
    x = np.zeros(fs, np.complex64)
    x[2000:2000 + len(iq)] = iq
    det = SondeDetector(fs)
    d16 = det.detect(np.stack([x.real, x.imag]).astype(np.float32)[None])[0]
    monkeypatch.setenv("RSX_DETECT_DTYPE", "float32")
    d32 = det.detect(np.stack([x.real, x.imag]).astype(np.float32)[None])[0]
    assert d16 and d16[0].name == "RS41", d16
    assert d32 and d32[0].name == "RS41"
    assert abs(d16[0].score - d32[0].score) < 0.02


def test_welch_hop_modes_agree():
    """Non-overlapping Welch (hop=nfft, the station-scan default) must
    agree with 50%-overlap Welch on the noise floor and peak location."""
    from radiosonde_auto_rx_jax.detect.psd import _welch
    rng = np.random.default_rng(0)
    fs, T = 480000, 480000
    t = np.arange(T) / fs
    x = (0.3 * np.exp(2j * np.pi * 50e3 * t)).astype(np.complex64)
    x += (rng.standard_normal(T) + 1j * rng.standard_normal(T)) \
        .astype(np.complex64) * 0.02
    planes = jnp.asarray(np.stack([x.real, x.imag])[None])
    a = 10 * np.log10(np.asarray(_welch(planes, 1024)) + 1e-20)[0]
    b = 10 * np.log10(np.asarray(_welch(planes, 1024, 1024)) + 1e-20)[0]
    assert np.argmax(a) == np.argmax(b)
    assert abs(np.median(a) - np.median(b)) < 0.5       # noise floor
    assert abs(a.max() - b.max()) < 1.0                 # peak power
    # sparse hop (one window per 4*nfft, the station-scan default):
    # fewer segments raise the per-bin variance but floor/peaks hold
    c = 10 * np.log10(np.asarray(_welch(planes, 1024, 4096)) + 1e-20)[0]
    assert np.argmax(a) == np.argmax(c)
    assert abs(np.median(a) - np.median(c)) < 0.5
    assert abs(a.max() - c.max()) < 1.0


def test_blocknorm_scan_matches_monolithic():
    """The chunked-scan blocknorm form must match the monolithic cube
    form bit-for-bit (same einsum reductions, same block norms, same
    first-occurrence argmax tie-breaking, same exact rescore)."""
    import jax.numpy as jnp
    from radiosonde_auto_rx_jax.detect.correlator import (
        _correlate_peaks_blocknorm, _correlate_peaks_blocknorm_scan)
    from radiosonde_auto_rx_jax.detect.templates import (
        build_template_bank, TEMPLATES)
    rng = np.random.default_rng(42)
    specs = [s for s in TEMPLATES if s.lp_iq == 1]
    bank, lens, _ = build_template_bank(48000, specs)
    lens_t = tuple(int(v) for v in lens)
    for T in (9000, 40000):
        x = rng.standard_normal((5, T)).astype(np.float32)
        # plant a template burst so real peaks exist
        L = int(lens[0])
        x[2, 1000:1000 + L] += 3.0 * np.asarray(bank[0][:L])
        a = _correlate_peaks_blocknorm(jnp.asarray(x),
                                       jnp.asarray(bank), lens_t)
        b = _correlate_peaks_blocknorm_scan(jnp.asarray(x),
                                            jnp.asarray(bank), lens_t,
                                            m_chunk=64)
        for va, vb, name in zip(a, b, ("val", "t_pk", "dc", "xm")):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                          err_msg=name)
        # screening mode: max |score| per (channel, type) must match the
        # monolithic screening pass
        a0 = _correlate_peaks_blocknorm(jnp.asarray(x),
                                        jnp.asarray(bank), lens_t,
                                        rescore=False, positions=False)[0]
        b0 = _correlate_peaks_blocknorm_scan(jnp.asarray(x),
                                             jnp.asarray(bank), lens_t,
                                             m_chunk=64,
                                             positions=False)[0]
        np.testing.assert_allclose(np.asarray(b0), np.asarray(a0),
                                   rtol=1e-6, atol=1e-6)


def test_detect_peaks_threshold_boundaries():
    """threshold>0 at array edges: a one-neighbor peak is judged
    against that neighbor alone, and never indexes out of bounds
    (round-4 review: x[i+1] raised IndexError for a last-sample peak;
    the first guard then folded x[i] into the max, silently rejecting
    every boundary peak)."""
    import numpy as np
    x = np.array([0.0, 1.0, 3.0])
    assert list(detect_peaks(x, threshold=1.5)) == [2]
    assert list(detect_peaks(x, threshold=2.5)) == []
    x2 = np.array([0.0, 2.0, 0.5, 0.4, 0.3])
    assert list(detect_peaks(x2, threshold=1.0)) == [1]
