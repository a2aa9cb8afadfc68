"""Precision and path selection are stated in the code, not inherited
from the platform.

Every dot and convolution on the decode path runs at
``Precision.HIGHEST`` (exact f32; a GPU would otherwise run f32 dots in
TF32), and the sites that used to branch on the platform pick the same
path whatever ``jax.devices()`` reports."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
from jax import lax

DOTS = ("dot_general", "conv_general_dilated")


def _eqns(jaxpr):
    """Every equation of a (closed) jaxpr, sub-jaxprs included."""
    jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
    for eqn in jaxpr.eqns:
        yield eqn
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                if hasattr(sub, "eqns") or hasattr(sub, "jaxpr"):
                    yield from _eqns(sub)


def _dot_precisions(fn, *args):
    out = []
    for eqn in _eqns(jax.make_jaxpr(fn)(*args)):
        if eqn.primitive.name in DOTS:
            p = eqn.params.get("precision")
            out.append(tuple(p) if isinstance(p, (tuple, list)) else (p,))
    return out


def _channelize():
    from radiosonde_auto_rx_jax.ops.channelizer import (_channelize,
                                                        pfb_prototype)
    x = jnp.zeros((2, 16 * 64), jnp.float32)
    return (lambda x: _channelize(x, jnp.asarray(pfb_prototype(16)), 16),
            x)


def _extraction():
    from radiosonde_auto_rx_jax.ops.channelizer import (_extract,
                                                        pfb_prototype)
    h = jnp.asarray(pfb_prototype(16))
    return (lambda x: _extract(x, h, jnp.zeros((1, 64)),
                               jnp.zeros((1, 16)), 16),
            jnp.zeros((1, 2, 16 * 64), jnp.float32))


def _demod_scan():
    from radiosonde_auto_rx_jax.demod.fsk import (
        _fsk_demod_scan_buffered, fsk_init_state, fsk_num_blocks_buffered)
    from radiosonde_auto_rx_jax.station.station import _demod_cfg
    cfg = _demod_cfg(48000, 4800, 5000, 5000)
    T = 12000
    nb = fsk_num_blocks_buffered(cfg, T)
    st = fsk_init_state(cfg, 2)
    return (lambda x: _fsk_demod_scan_buffered(cfg, x, st, nb),
            jnp.zeros((2, 2, T), jnp.float32))


def _detector():
    from radiosonde_auto_rx_jax.detect.correlator import (
        _corr_direct, _corr_toeplitz, _correlate_peaks_blocknorm,
        _correlate_peaks_exact)
    from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
    det = SondeDetector(48000, prescreen=False)
    bank = jnp.ones((3, 40), jnp.float32)
    lens = (40, 30, 20)

    def fn(x):
        fm = det._condition(jnp.stack([x, x], axis=1))
        return (_corr_direct(x, bank), _corr_toeplitz(x, bank),
                _correlate_peaks_exact(x, bank, lens),
                _correlate_peaks_blocknorm(x, bank, lens), fm)
    return fn, jnp.zeros((2, 4096), jnp.float32)


def _psd():
    from radiosonde_auto_rx_jax.detect.psd import _welch
    return (lambda x: (_welch(x, 256), _welch(x, 256, 1024)),
            jnp.zeros((1, 2, 4096), jnp.float32))


def _resampler():
    from radiosonde_auto_rx_jax.ops.resample import resample_planes
    return (lambda x: resample_planes(x, 48000, 48080),
            jnp.zeros((2, 2, 4800), jnp.float32))


def _fir():
    from radiosonde_auto_rx_jax.ops.fir import (decimate, fir_filter,
                                                fir_filter_block)
    h = jnp.ones(9, jnp.float32) / 9
    return (lambda x: (fir_filter(x, h), fir_filter_block(x, h[None]),
                       decimate(x, 4)),
            jnp.zeros((2, 1024), jnp.float32))


STAGES = {"channelize": _channelize, "extraction": _extraction,
          "demod_scan": _demod_scan, "detector": _detector, "psd": _psd,
          "resampler": _resampler, "fir": _fir}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_decode_path_dots_run_at_highest(stage):
    fn, x = STAGES[stage]()
    precs = _dot_precisions(fn, x)
    if stage != "extraction":       # its branch sum has no dot at all
        assert precs, f"{stage}: no dot/conv traced"
    bad = [p for p in precs
           if any(q != lax.Precision.HIGHEST for q in p)]
    assert not bad, f"{stage}: dots below HIGHEST: {bad}"


def _fake_devices(platform):
    dev = SimpleNamespace(platform=platform, device_kind=platform)
    return lambda *a, **k: [dev]


def _gate_channelizer():
    from radiosonde_auto_rx_jax.ops.channelizer import _branch_dtype
    return _branch_dtype()


def _gate_stream():
    from radiosonde_auto_rx_jax.detect.scanner import stream_dtype
    return stream_dtype()


def _gate_corr():
    from radiosonde_auto_rx_jax.detect import correlator
    return correlator._corr_method()


def _gate_peaks():
    from radiosonde_auto_rx_jax.detect import correlator
    return correlator._peaks_method()


def _gate_psd():
    """dtypes the Welch PSD's jaxpr computes in."""
    from radiosonde_auto_rx_jax.detect.psd import _welch
    jaxpr = jax.make_jaxpr(lambda x: _welch.__wrapped__(x, 256))(
        jnp.zeros((1, 2, 2048), jnp.float32))
    return sorted({str(v.aval.dtype) for e in _eqns(jaxpr)
                   for v in e.outvars})


GATES = {"channelizer_dtype": (_gate_channelizer, jnp.dtype(jnp.float32)),
         "stream_dtype": (_gate_stream, jnp.dtype(jnp.float32)),
         "correlation": (_gate_corr, "fft"),
         "peaks": (_gate_peaks, "exact"),
         "psd_dtype": (_gate_psd, None)}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_former_platform_gates_ignore_platform(gate, monkeypatch):
    for var in ("RSX_CHANNELIZER_DTYPE", "RSX_DETECT_DTYPE"):
        monkeypatch.delenv(var, raising=False)
    from radiosonde_auto_rx_jax.detect import correlator
    monkeypatch.setattr(correlator, "_CORR_METHOD", "auto")
    monkeypatch.setattr(correlator, "_PEAKS_METHOD", "auto")
    fn, want = GATES[gate]
    seen = []
    for platform in ("tpu", "gpu", "cpu"):
        monkeypatch.setattr(jax, "devices", _fake_devices(platform))
        seen.append(fn())
    assert all(s == seen[0] for s in seen), seen
    if want is not None:
        assert seen[0] == want
    else:
        assert "bfloat16" not in seen[0]
