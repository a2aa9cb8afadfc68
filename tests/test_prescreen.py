"""Phase-1 prescreen: the half-rate reject must never drop a channel the
full detector accepts (reference analogue: dft_detect's single full-rate
pass, scan/dft_detect.c:737-819 — the prescreen must be conservatively
transparent in front of our equivalent)."""

import numpy as np
import pytest

from radiosonde_auto_rx_jax.demod.modulate import add_awgn, gfsk_mod
from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
from radiosonde_auto_rx_jax.detect.templates import TEMPLATES
from radiosonde_auto_rx_jax.ops.fir import (design_lowpass, fir_filter,
                                            fir_filter_block)

FS = 48000


def test_fir_filter_block_stride():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    hs = np.stack([design_lowpass(0.1, 31), design_lowpass(0.2, 31)])
    full = np.asarray(fir_filter_block(x, hs))
    for stride in (2, 4):
        got = np.asarray(fir_filter_block(x, hs, stride=stride))
        want = full[:, :, ::stride]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_fir_filter_block_stride_matches_fir_filter():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 777)).astype(np.float32)
    h = design_lowpass(0.15, 49)
    want = np.asarray(fir_filter(x, h))[:, ::2]
    got = np.asarray(fir_filter_block(x, h[None], stride=2))[:, 0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_blocknorm_peaks_match_exact_on_signal():
    """The blocknorm peak path (block-granular argmax + exact rescore) must
    agree with the exact per-position path on a real header burst."""
    from radiosonde_auto_rx_jax.detect.correlator import (
        _correlate_peaks_blocknorm, _correlate_peaks_exact)
    from radiosonde_auto_rx_jax.detect.templates import build_template_bank
    from radiosonde_auto_rx_jax.ops.fir import fir_filter
    from radiosonde_auto_rx_jax.ops.fm import fm_discriminate
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    spec = next(t for t in TEMPLATES if t.name == "RS41")
    iq = add_awgn(_burst(spec, rng, t_samples=24000), 14.0, FS, spec.sps,
                  rng=rng)
    h = design_lowpass(6000 / FS, 97)
    z = fir_filter(np.asarray([iq.real]), h) + \
        1j * fir_filter(np.asarray([iq.imag]), h)
    fm = jnp.asarray(np.asarray(fm_discriminate(z)))
    bank, lens, specs = build_template_bank(
        FS, [t for t in TEMPLATES if t.lp_iq == 1])
    lens_t = tuple(int(v) for v in lens)
    ve, te, de, me = (np.asarray(v) for v in
                      _correlate_peaks_exact(fm, jnp.asarray(bank), lens_t))
    vb, tb, db, mb = (np.asarray(v) for v in _correlate_peaks_blocknorm(
        fm, jnp.asarray(bank), lens_t))
    k = [s.name for s in specs].index("RS41")
    # the detected header: same position, same (exactly-normalized) score
    assert abs(ve[0, k]) > spec.thres
    assert te[0, k] == tb[0, k]
    np.testing.assert_allclose(vb[0, k], ve[0, k], rtol=1e-4)
    np.testing.assert_allclose(db[0, k], de[0, k], rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(mb, me, rtol=1e-5)


def _burst(spec, rng, t_samples=FS, f_off=0.0):
    n_bits = int(np.ceil(t_samples / (FS / spec.sps))) + 4
    hdr = np.array([int(c) for c in spec.header])
    tail = max(0, n_bits - 400 - len(hdr))
    bits = np.concatenate([rng.integers(0, 2, 400), hdr,
                           rng.integers(0, 2, tail)])
    spacing = min(2 * spec.sps, 20000)
    iq = gfsk_mod(bits, FS, spec.sps, 2, f_off, spacing, bt=spec.bt)
    return iq[:t_samples]


def _planes(iqs):
    a = np.stack(iqs)
    return np.stack([a.real, a.imag], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def detector():
    return SondeDetector(FS)


def test_prescreen_built(detector):
    assert detector.prescreen is not None


def test_prescreen_never_rejects_full_pass_detections(detector):
    """Sweep types x Eb/N0 x frequency offset; every channel the full
    pass detects must clear the prescreen margin."""
    specs = [t for t in TEMPLATES if t.name != "IMETafsk"]
    rng = np.random.default_rng(99)
    cases = []
    for spec in specs:
        for eb in (8.0, 11.0, 20.0):
            for f_off in (0.0, 3000.0):
                iq = add_awgn(_burst(spec, rng, f_off=f_off), eb, FS,
                              spec.sps, rng=rng)
                cases.append((spec.name, eb, f_off, iq))
    x = _planes([c[3] for c in cases])
    x = x - x.mean(axis=-1, keepdims=True) * 0.98
    full = detector._detect_full(x, max_det=1)
    ratio = np.asarray(detector.prescreen.scores(x))
    missed = []
    for i, (name, eb, f_off, _) in enumerate(cases):
        if full[i] and ratio[i] < detector.prescreen_margin:
            missed.append((name, eb, f_off, full[i][0].score,
                           float(ratio[i])))
    assert not missed, f"prescreen rejected full-pass detections: {missed}"


def test_detect_with_prescreen_matches_full(detector):
    """On a mixed batch (sondes + noise) the prescreened detect() yields
    the same detections as the full pass on every detected channel."""
    rng = np.random.default_rng(5)
    specs = {t.name: t for t in TEMPLATES}
    iqs = []
    for name in ("RS41", "DFM", "M10", "WXR301"):
        iqs.append(add_awgn(_burst(specs[name], rng), 14.0, FS,
                            specs[name].sps, rng=rng))
    for k in range(8):
        iqs.append((rng.standard_normal(FS) + 1j *
                    rng.standard_normal(FS)).astype(np.complex64) * 0.3)
    x = _planes(iqs)
    with_pre = detector.detect(x, prescreen=True)
    without = detector.detect(x, prescreen=False)
    for c, dets in enumerate(without):
        if dets:
            assert with_pre[c], f"channel {c} lost by prescreen"
            assert with_pre[c][0].name == dets[0].name
            assert with_pre[c][0].position == dets[0].position
            assert abs(with_pre[c][0].score - dets[0].score) < 1e-3


def test_prescreen_rejects_noise(detector):
    """Pure-noise channels should (mostly) not survive phase 1 — the
    point of the prescreen is that empty channels are cheap."""
    rng = np.random.default_rng(6)
    iqs = [(rng.standard_normal(FS) + 1j *
            rng.standard_normal(FS)).astype(np.complex64) * 0.3
           for _ in range(16)]
    x = _planes(iqs)
    ratio = np.asarray(detector.prescreen.scores(x))
    # no correctness requirement here — an occasional noise survivor just
    # costs a full-pass slot — but >half surviving would mean the margin
    # buys nothing
    assert (ratio >= detector.prescreen_margin).sum() <= len(iqs) // 2
