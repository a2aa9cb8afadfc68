"""PSD scanning + peak detection for the sonde scanner.

Replaces the reference scan pass (reference auto_rx/autorx/scan.py:948-1097:
rtl_power CSV -> median noise floor -> detect_peaks -> 10 kHz quantize) with
an on-device Welch PSD over IQ planes (a dense windowed-DFT matmul)
and a host-side peak picker with the same mph/mpd semantics as the
Marcos-Duarte detector the reference vendors (auto_rx/autorx/utils.py:437).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp


def _dft_mats(nfft):
    n = np.arange(nfft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / (nfft - 1))   # hann
    win = win / np.sqrt(np.sum(win**2) / nfft)
    kcol = np.arange(nfft) - nfft // 2                     # fftshifted
    ang = 2 * np.pi * np.outer(n, kcol) / nfft
    wc = (win[:, None] * np.cos(ang)).astype(np.float32)
    ws = (win[:, None] * np.sin(ang)).astype(np.float32)
    return wc, ws


@partial(jax.jit, static_argnames=("nfft", "hop"))
def _welch(x, nfft, hop=None):
    """x: [C, 2, T] planes -> mean |DFT|^2 over hops, fftshifted [C, nfft].

    ``hop`` defaults to nfft//2 (50%-overlap Welch).  hop=nfft gives
    non-overlapping segments — with the hundreds-to-thousands of
    segments a wideband scan integrates, the noise-floor/peak estimate
    is statistically indistinguishable at half the flops and bytes (the
    station scan and bench use it).
    """
    C, _, T = x.shape
    hop = nfft // 2 if hop is None else hop
    if hop <= nfft:
        assert nfft % hop == 0, "hop must divide nfft"
        # the segment set at hop = nfft/k is exactly k interleaved
        # non-overlapping tilings -> k reshaped VIEWS (a per-segment
        # slice stack unrolls to thousands of XLA ops at wideband T).
        # The mean over segments is order-invariant so the tilings are
        # reduced independently — no interleave copy.
        nseg = (T - nfft) // hop + 1
        groups = []                          # [(segs view, n_segs), ...]
        for k in range(nfft // hop):
            nk = (nseg - k + (nfft // hop) - 1) // (nfft // hop)
            if nk > 0:
                off = k * hop
                groups.append(x[:, :, off:off + nk * nfft]
                              .reshape(C, 2, nk, nfft))
    else:
        # sparse sampling (hop = k*nfft, integration duty 1/k): one
        # nfft window per hop stride.  Welch variance per bin is
        # 1/sqrt(n_segs); a wideband scan block still integrates
        # hundreds of segments, so floor/peak estimates are unchanged
        # within noise (tests/test_ops.py gates the agreement) at 1/k
        # of the input traffic and DFT flops.
        assert hop % nfft == 0, "sparse hop must be a multiple of nfft"
        nseg = T // hop
        assert nseg > 0, "capture shorter than one hop"
        groups = [x[:, :, :nseg * hop]
                  .reshape(C, 2, nseg, hop)[..., :nfft]]
    wc, ws = _dft_mats(nfft)
    wc = jnp.asarray(wc)
    ws = jnp.asarray(ws)

    # Precision: HIGHEST (exact f32).  The scan thresholds peaks at
    # ~10 dB over the median floor; TF32 was not shown to keep the
    # scan's peaks identical, so the PSD keeps the validated f32 path.
    def dot(a, m):
        return jax.lax.dot_general(a, m, (((2,), (0,)), ((), ())),
                                   precision=jax.lax.Precision.HIGHEST,
                                   preferred_element_type=jnp.float32)

    # ONE stacked matmul per group instead of four: [re|im] segments x
    # [cos|sin] operand — same flops, a quarter of the dot launches
    wcs = jnp.concatenate([wc, ws], axis=1)                # [nfft, 2nfft]
    acc = 0
    for segs in groups:
        C_g, _, nk, _ = segs.shape
        xcat = segs.astype(jnp.float32).reshape(C_g, 2 * nk, nfft)
        y = dot(xcat, wcs).reshape(C_g, 2, nk, 2, nfft)
        yrc, yrs = y[:, 0, :, 0], y[:, 0, :, 1]            # xr·wc, xr·ws
        yic, yis = y[:, 1, :, 0], y[:, 1, :, 1]            # xi·wc, xi·ws
        re = yrc + yis
        im = yic - yrs
        p = re ** 2 + im ** 2
        acc = acc + p.sum(axis=1)
    return acc / (nseg * nfft)                             # [C, nfft]


def power_spectrum(x, nfft=1024, fs=48000, hop=None):
    """IQ (complex [C,T]/[T] or planes [C,2,T]) -> (freqs, psd_db).

    freqs in Hz relative to center; psd_db [C, nfft].  ``hop`` as in
    ``_welch`` — scans over long captures pass hop=nfft (non-overlap).
    """
    from radiosonde_auto_rx_jax.demod.fsk import iq_planes
    single = (np.ndim(x) == 1) or (jnp.iscomplexobj(x) and x.ndim == 1)
    x = iq_planes(x)
    p = np.asarray(_welch(x, nfft, hop))
    psd_db = 10.0 * np.log10(np.maximum(p, 1e-20))
    freqs = (np.arange(nfft) - nfft // 2) * (fs / nfft)
    return freqs, (psd_db[0] if single else psd_db)


def detect_peaks(x, mph=None, mpd=1, threshold=0.0):
    """Peak indices: amplitude >= mph, separated by >= mpd samples.

    Same semantics as the reference's vendored Marcos-Duarte detector
    (auto_rx/autorx/utils.py:437): local maxima on rising edges, highest
    peaks win within the minimum-distance window.
    """
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    if x.size < 3:
        return np.array([], dtype=int)
    dx = np.diff(x)
    rise = np.flatnonzero((np.hstack((dx, 0)) <= 0) & (np.hstack((0, dx)) > 0))
    if rise.size and mph is not None:
        rise = rise[x[rise] >= mph]
    if rise.size and threshold > 0:
        # a "peak" flagged at the very first/last sample has only one
        # neighbor — compare against that neighbor ALONE (folding the
        # sample into the max would always reject boundary peaks)
        def _prom(i):
            nbrs = [x[i - 1]] if i > 0 else []
            if i + 1 < x.size:
                nbrs.append(x[i + 1])
            return x[i] - max(nbrs)
        keep = np.array([_prom(i) > threshold for i in rise])
        rise = rise[keep]
    if rise.size and mpd > 1:
        order = rise[np.argsort(x[rise])][::-1]
        suppressed = np.zeros(x.size, dtype=bool)
        keep = []
        for i in order:
            if not suppressed[i]:
                keep.append(i)
                lo = max(0, i - int(mpd))
                suppressed[lo:i + int(mpd) + 1] = True
        rise = np.sort(np.array(keep, dtype=int))
    return rise


def scan_peaks(psd_db, freqs, snr_threshold=10.0, min_distance_hz=10e3,
               quantization_hz=10e3, never_scan=()):
    """PSD -> candidate frequencies (Hz, relative to capture center).

    Mirrors the reference scan pass (auto_rx/autorx/scan.py:1009-1097):
    noise floor = median(power); peaks above floor+threshold; quantize;
    dedupe; drop blocked frequencies.
    """
    psd_db = np.asarray(psd_db)
    noise_floor = float(np.median(psd_db))
    df = abs(freqs[1] - freqs[0])
    mpd = max(1, int(min_distance_hz / df))
    idx = detect_peaks(psd_db, mph=noise_floor + snr_threshold, mpd=mpd)
    if len(idx) == 0:
        return np.array([]), noise_floor
    pf = freqs[idx]
    if quantization_hz:
        pf = np.round(pf / quantization_hz) * quantization_hz
    pf = np.unique(pf)
    if never_scan:
        pf = np.array([f for f in pf
                       if not any(abs(f - b) < quantization_hz / 2
                                  for b in never_scan)])
    return pf, noise_floor
