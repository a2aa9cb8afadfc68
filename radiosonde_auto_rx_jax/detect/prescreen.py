"""Phase-1 detector prescreen: cheap reduced-rate reject before the full pass.

The full detector conditions four IF/FM streams and correlates 16+
templates per candidate channel (detect/scanner.py) — measured ~8x the
per-channel-sample cost of the whole FSK demod, on channels that are
mostly *not* sondes (PSD peaks from other transmitters or noise bursts).
The reference pays the same shape of cost: its dft_detect runs 4 FIRs +
4 FM discriminators per input sample before any correlation
(reference scan/dft_detect.c:737-819).

This prescreen rejects empty channels at a fraction of that cost by
running the same class structure at HALF rate wherever that is safe:

* a class decimates 2:1 only when (a) its IF cutoff sits below the
  decimated Nyquist (alias-free: the 6/12/22 kHz classes at 48 kHz all
  qualify) AND (b) its fastest *effective* header baud keeps >= 4
  samples per symbol at the low rate — below that the half-rate
  correlation's timing quantization costs ~40-50% of the score
  (measured: M10/C34C50/MK2LMS floors 0.44-0.56 at 24 kHz vs >= 0.85
  at 48 kHz), which no sane margin survives.  Effective baud counts the
  shortest same-bit run (the iMet AFSK preamble's 9600 sps "11110000"
  pattern is a 2400 Bd pulse train);
* decimating classes run the IF lowpass with a fused output stride of 2
  (ops/fir.fir_filter_block(stride=2)), the FM discriminator on the
  decimated IQ, and template banks synthesized at 24 kHz — ~1/4 the
  full-rate correlation cost;
* the unfiltered (raw) class discriminates at full rate and decimates
  after its FM audio lowpass (which doubles as the anti-alias filter);
* correlation peaks use the block-normalized path WITHOUT the exact
  rescore (detect/correlator._correlate_peaks_blocknorm(rescore=False))
  — approximate scores suffice against a derated margin.

A channel survives when any type's |score| clears ``margin * thres``;
the default margin 0.55 sits >= 20% below every type's measured
worst-case phase-1/full-pass score ratio across the Eb/N0 x frequency-
offset sweep (tests/test_prescreen.py asserts the prescreen never
rejects a channel the full detector accepts).  Survivors then get the
UNCHANGED full-rate pass, so accepted detections keep the exact
production scores/positions.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from radiosonde_auto_rx_jax.detect.correlator import (
    _correlate_peaks_blocknorm_scan, _correlate_peaks_exact)
from radiosonde_auto_rx_jax.detect.templates import build_template_bank
from radiosonde_auto_rx_jax.ops.fir import design_lowpass, fir_filter_block
from radiosonde_auto_rx_jax.ops.fm import FM_GAIN

# default survivor margin (see module docstring; validated by
# tests/test_prescreen.py across types, Eb/N0 and frequency offsets)
MARGIN = 0.55


def _eff_sps(spec) -> float:
    """Effective baud of a header: sps / shortest same-bit run."""
    run = 1
    mn = len(spec.header)
    for a, b in zip(spec.header, spec.header[1:]):
        if a == b:
            run += 1
        else:
            mn = min(mn, run)
            run = 1
    mn = min(mn, run)
    return spec.sps / max(1, mn)


class Prescreen:
    """Reduced-rate screening scores for a template-spec set.

    ``scores(x)`` -> per-channel max over types of |corr score| / thres:
    >= MARGIN means "could clear the full detector's threshold".
    """

    DECIM = 2

    def __init__(self, fs: int, specs, bw_table, lpfm_table,
                 taps: int = 97):
        self.fs = fs
        self.classes = []
        # template order of the [C, K_total] ratio matrix: classes in
        # ascending lp_iq order, specs in their in-class order
        self.spec_order = []
        for cls in sorted({s.lp_iq for s in specs}):
            cls_specs = [s for s in specs if s.lp_iq == cls]
            self.spec_order.extend(cls_specs)
            bw = bw_table[cls]
            # class decimation: alias-free AND >= 4 samples per
            # effective symbol at the low rate
            d = self.DECIM
            if max(_eff_sps(s) for s in cls_specs) * 4 > fs / self.DECIM:
                d = 1
            fs_cls = fs // d
            if bw < fs and bw / 2 >= fs_cls / 2:
                raise ValueError(f"class bw {bw} too wide for fs {fs}/{d}")
            bank, lens, _ = build_template_bank(fs_cls, cls_specs)
            thres = np.array([s.thres for s in cls_specs], np.float32)
            h_if = None if bw >= fs else design_lowpass(bw / 2 / fs, taps)
            lpfm = lpfm_table[1] if any(s.sps > 6000 for s in cls_specs) \
                else lpfm_table[0]
            # FM audio lowpass applied at the class rate (the raw class
            # gets it at full rate: it doubles as the anti-alias filter
            # for its post-discriminator decimation)
            fm_rate = fs if h_if is None else fs_cls
            h_fm = design_lowpass(lpfm / fm_rate,
                                  max(25, taps * fs_cls // fs) | 1)
            self.classes.append((
                None if h_if is None else jnp.asarray(h_if),
                jnp.asarray(h_fm), jnp.asarray(bank),
                tuple(int(v) for v in lens), jnp.asarray(thres), d))

    @partial(jax.jit, static_argnames=("self",))
    def scores(self, x):
        """x: [C, 2, T] IQ planes -> ratio [C] (max_k |score_k|/thres_k)."""
        return self.template_ratios(x).max(axis=1)

    @partial(jax.jit, static_argnames=("self",))
    def template_ratios(self, x):
        """x: [C, 2, T] IQ planes -> [C, K_total] per-template
        |score|/thres ratios, templates ordered as ``spec_order``
        (used by the sharded station step to pick each channel's
        expert type on device, parallel/station_step.py)."""
        from radiosonde_auto_rx_jax.detect.scanner import stream_dtype
        C, _, T = x.shape
        sdt = stream_dtype()
        x = x.astype(sdt)

        from radiosonde_auto_rx_jax.ops.fm import \
            fm_discriminate_planes_mixed

        def discr(re, im):
            return fm_discriminate_planes_mixed(re, im, sdt)

        # one strided filter-bank pass per distinct stride over the
        # stacked re/im rows (as scanner._condition, but emitting the
        # class-rate stream straight out of the Toeplitz matmul)
        streams = [None] * len(self.classes)
        by_d = {}
        for i, cl in enumerate(self.classes):
            if cl[0] is not None:
                by_d.setdefault(cl[5], []).append(i)
        for d, idxs in by_d.items():
            hs = jnp.stack([self.classes[i][0] for i in idxs]).astype(sdt)
            y = fir_filter_block(x.reshape(C * 2, T), hs, stride=d) \
                .reshape(C, 2, len(idxs), -1)
            fmf = discr(y[:, 0], y[:, 1])                 # [C, F, T/d]
            for fi, i in enumerate(idxs):
                streams[i] = fmf[:, fi]
        raw_idx = [i for i, cl in enumerate(self.classes) if cl[0] is None]
        if raw_idx:
            fm_raw = discr(x[:, 0], x[:, 1])              # [C, T] full rate
            for i in raw_idx:
                streams[i] = fm_raw
        ratios = []
        for i, (h_if, h_fm, bank, lens_t, thres, d) in \
                enumerate(self.classes):
            s = streams[i]
            # FM lowpass at the class rate; the raw class decimates
            # here (h_fm is its anti-alias filter)
            stride = d if h_if is None else 1
            fm = fir_filter_block(s, h_fm[None, :].astype(sdt),
                                  stride=stride)[:, 0]
            # always the blocknorm path (platform-independent semantics:
            # CPU tests validate exactly what the card runs); approximate
            # peak scores suffice against the derated margin
            if fm.shape[-1] >= 2 * bank.shape[-1]:
                # positions=False: screening needs only |score| ratios —
                # the chunked-scan form runs one fused max pass per
                # M-chunk with no materialized corr cube (no argmax
                # reduce, no peak gathers)
                val, _, _, _ = _correlate_peaks_blocknorm_scan(
                    fm, bank.astype(fm.dtype), lens_t, positions=False)
            else:
                val, _, _, _ = _correlate_peaks_exact(
                    fm, bank.astype(fm.dtype), lens_t)
            ratios.append(jnp.abs(val.astype(jnp.float32)) / thres[None, :])
        return jnp.concatenate(ratios, axis=1)               # [C, K_total]
