"""Sonde detector: IQ conditioning + template-bank correlation.

The reference's dft_detect IQ mode runs 3 parallel IF lowpass bandwidths
(6/12/22 kHz [+200k L-band]) into 4 parallel FM discriminator streams and
correlates each type against its bandwidth class
(reference scan/dft_detect.c:148-149,751-819,1021-1111,1404-1410).  Here
the same structure is one jitted dataflow over IQ planes ``[C, 2, T]``:
per-class FIR (grouped over re/im), one discriminator per class, one
grouped convolution per class — everything batched over channels.
"""

import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from radiosonde_auto_rx_jax.detect.templates import build_template_bank, \
    TEMPLATES
from radiosonde_auto_rx_jax.detect.correlator import detect_types
from radiosonde_auto_rx_jax.ops.fir import design_lowpass, fir_filter_block
from radiosonde_auto_rx_jax.ops.fm import FM_GAIN

# IF lowpass bandwidth per class (dft_detect.c:148-149)
LPIQ_BW = (6e3, 12e3, 22e3, 200e3)
# L-band rescaled class table (dft_detect.c -L flag :1405-1410): wider
# deviations at 1680 MHz, incl. the RS92-NGP 32 kHz tweak (scan.py:461)
LPIQ_BW_LBAND = (20e3, 32e3, 200e3, 400e3)
# FM-audio lowpass (dft_detect.c:148: 4k narrow, 10k wide)
LPFM_BW = (4e3, 10e3)


def stream_dtype():
    """dtype of the conditioned FM streams: f32 (the path the CPU tests
    and PER gates validated).  RSX_DETECT_DTYPE=bfloat16 forces bf16
    streams (correlation scores are thresholded at 0.55-0.8, so the
    0.4% stream quantization is immaterial to the decisions)."""
    forced = os.environ.get("RSX_DETECT_DTYPE")
    if forced:
        return jnp.dtype(forced)
    return jnp.dtype(jnp.float32)


class SondeDetector:
    """Detect sonde type(s) in 48 kHz IQ channels.

    Usage: ``SondeDetector(fs).detect(iq)`` -> list of Detection
    (per channel when input is batched).  ``lband=True`` selects the
    1680 MHz IF bandwidth table.
    """

    def __init__(self, fs: int = 48000, specs=None, taps: int = 97,
                 lband: bool = False, prescreen: bool = True,
                 prescreen_margin: float | None = None,
                 bw_table=None):
        self.fs = fs
        self.lband = lband
        if bw_table is None:
            bw_table = LPIQ_BW_LBAND if lband else LPIQ_BW
        specs = TEMPLATES if specs is None else specs
        # phase-1 reduced-rate prescreen (detect/prescreen.py): rejects
        # empty channels before the full 4-stream multi-template pass.
        # The default margin (prescreen.MARGIN) is validated by
        # tests/test_prescreen.py across types/SNRs/offsets.  L-band
        # profiles skip it (few channels).
        self.prescreen = None
        if prescreen and not lband:
            from radiosonde_auto_rx_jax.detect.prescreen import (
                MARGIN, Prescreen)
            try:
                self.prescreen = Prescreen(fs, specs, bw_table, LPFM_BW,
                                           taps)
            except ValueError:      # a class too wide for fs/2
                self.prescreen = None
            if prescreen_margin is None:
                prescreen_margin = MARGIN
        self.prescreen_margin = float(prescreen_margin
                                      if prescreen_margin is not None
                                      else 0.55)
        # group templates by IF bandwidth class present at this rate
        self.classes = []
        for cls in sorted({s.lp_iq for s in specs}):
            bw = bw_table[cls]
            if bw >= fs:
                cls_specs = [s for s in specs if s.lp_iq == cls]
                bank, lens, _ = build_template_bank(fs, cls_specs)
                self.classes.append((None, None, cls_specs,
                                     jnp.asarray(bank), lens))
                continue
            cls_specs = [s for s in specs if s.lp_iq == cls]
            bank, lens, _ = build_template_bank(fs, cls_specs)
            h_if = jnp.asarray(design_lowpass(bw / 2 / fs, taps))
            lpfm = LPFM_BW[1] if any(s.sps > 6000 for s in cls_specs) \
                else LPFM_BW[0]
            h_fm = jnp.asarray(design_lowpass(lpfm / fs, taps))
            self.classes.append((h_if, h_fm, cls_specs,
                                 jnp.asarray(bank), lens))

    @partial(jax.jit, static_argnames=("self",))
    def _condition(self, x):
        """x: [C, 2, T] planes -> list of FM streams [C, T] per class.

        All per-class IF lowpasses run as ONE blocked-Toeplitz filter-bank
        pass over the stacked re/im rows (fir_filter_block: a dense
        matmul instead of per-class single-output convs), then one
        discriminator over the class-stacked planes, then the FM
        lowpasses grouped by distinct taps.
        """
        C, _, T = x.shape
        sdt = stream_dtype()
        x = x.astype(sdt)

        from radiosonde_auto_rx_jax.ops.fm import \
            fm_discriminate_planes_mixed

        def discr(re, im):
            # w = z * conj(z_prev); atan2 evaluates f32 in-register
            return fm_discriminate_planes_mixed(re, im, sdt)

        filt_idx = [i for i, cl in enumerate(self.classes)
                    if cl[0] is not None]
        out = [None] * len(self.classes)
        if filt_idx:
            hs = jnp.stack([self.classes[i][0]
                            for i in filt_idx]).astype(sdt)   # [F, K]
            y = fir_filter_block(x.reshape(C * 2, T), hs) \
                .reshape(C, 2, len(filt_idx), T)
            fmf = discr(y[:, 0], y[:, 1])                     # [C, F, T]
            for fi, i in enumerate(filt_idx):
                out[i] = fmf[:, fi]
        for i, cl in enumerate(self.classes):
            if cl[0] is None:
                out[i] = discr(x[:, 0], x[:, 1])
        # FM audio lowpass, grouped by distinct taps
        groups = {}
        for i, (_, h_fm, _, _, _) in enumerate(self.classes):
            if h_fm is not None:
                groups.setdefault(bytes(np.asarray(h_fm).tobytes()),
                                  (h_fm, []))[1].append(i)
        for h_fm, idxs in groups.values():
            sub = jnp.stack([out[i] for i in idxs],
                            axis=1).reshape(C * len(idxs), T)
            flt = fir_filter_block(sub, h_fm[None, :].astype(sdt))[:, 0]
            flt = flt.reshape(C, len(idxs), T)
            for k, i in enumerate(idxs):
                out[i] = flt[:, k]
        return out

    def detect(self, iq, max_det: int = 1, dc_block: bool = True,
               prescreen: bool | None = None):
        """iq: complex [T]/[C,T] or planes [C,2,T] -> detections.

        Returns a list of Detection for 1-D input, else a list per channel.
        Frequency offsets are in Hz (df = fs*dc/(2*FM_GAIN), the
        discriminator's normalization, demod/mod/demod_mod.c:298).

        ``prescreen``: None = auto (use the half-rate phase-1 reject when
        built and the batch is big enough to pay for it); True/False
        forces.  Accepted channels always get the full-rate pass, so
        detections are identical to ``prescreen=False`` except on
        channels the prescreen rejects (validated to not include any
        full-pass detections, tests/test_prescreen.py).
        """
        from radiosonde_auto_rx_jax.demod.fsk import iq_planes
        single = np.ndim(iq) == 1
        x = iq_planes(iq)
        if dc_block:
            x = x - jnp.mean(x, axis=-1, keepdims=True) * 0.98
        C = x.shape[0]
        use_pre = self.prescreen is not None and \
            (prescreen if prescreen is not None else C >= 8)
        if use_pre:
            ratio = np.asarray(self.prescreen.scores(x))
            surv = np.flatnonzero(ratio >= self.prescreen_margin)
            merged = [[] for _ in range(C)]
            if surv.size:
                # pad the survivor batch to a power of two so the full
                # pass compiles for O(log C) shapes, not every count
                n = 1 << max(0, int(np.ceil(np.log2(surv.size))))
                pad = np.concatenate(
                    [surv, np.full(n - surv.size, surv[0], surv.dtype)])
                sub = self._detect_full(x[jnp.asarray(pad)], max_det)
                for i, c in enumerate(surv):
                    merged[int(c)] = sub[i]
            return merged[0] if single else merged
        merged = self._detect_full(x, max_det)
        return merged[0] if single else merged

    def _detect_full(self, x, max_det: int):
        """Full-rate 4-stream multi-template pass on [C, 2, T] planes."""
        streams = self._condition(x)
        C = x.shape[0]
        merged = [[] for _ in range(C)]
        for fm, (h_if, h_fm, cls_specs, bank, lens) in zip(streams,
                                                           self.classes):
            dets = detect_types(fm, bank, lens, cls_specs,
                                fm_gain_hz=self.fs / (2.0 * FM_GAIN),
                                max_det=0, fs=self.fs,
                                wideband=self.lband or self.fs > 50000)
            for c in range(C):
                merged[c].extend(dets[c])
        for c in range(C):
            merged[c].sort(key=lambda d: d.score, reverse=True)
            if max_det:
                merged[c] = merged[c][:max_det]
        return merged
