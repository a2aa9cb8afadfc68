"""The station: one object owning the whole capture→telemetry dataflow.

Replaces the reference's task manager + scanner + decoder threads
(reference auto_rx/auto_rx.py:101-537, autorx/scan.py SondeScanner :662,
autorx/decode.py SondeDecoder :55): instead of allocating SDRs to
subprocess pipelines, each ``process_capture`` call takes one wideband IQ
block, channelizes it on device, scans/detects/demodulates as channel
batches, decodes frames on the host, and fans validated telemetry out to
the exporters.  Task state (temporary blocks, active decoders, timeouts)
matches the reference's bookkeeping (auto_rx.py:304-537).
"""

import logging
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from radiosonde_auto_rx_jax.demod.fsk import FSKConfig, fsk_demod_stream
from radiosonde_auto_rx_jax.detect.psd import power_spectrum, scan_peaks
from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
from radiosonde_auto_rx_jax.models import get_model
from radiosonde_auto_rx_jax.ops.channelizer import (
    channel_freqs, channelize, extract_channels, pfb_prototype)
from radiosonde_auto_rx_jax.parallel.mesh import CH_AXIS, T_AXIS
from radiosonde_auto_rx_jax.station.config import default_config
from radiosonde_auto_rx_jax.station.telemetry import (
    RealtimeVelocityFilter, enrich_telemetry, telemetry_filter)

log = logging.getLogger("station")

# Offsets below this demodulate fine at the channel center (every narrow
# chain's estimator window is >= +-5 kHz); above it the candidate is
# re-extracted from the wideband block recentered on its scan peak — the
# batch-pipeline analogue of the reference retuning its SDR to the detected
# peak (reference auto_rx/autorx/scan.py:1034-1097,
# autorx/sdr_wrappers.py:270-376).
RECENTER_MIN_HZ = 1000.0
# Spectral-width gate for wideband candidates: a floor-subtracted RMS
# width above this (Weathex tones sit at ±25 kHz → RMS ≈ 25 kHz; every
# narrow chain's tones are within ±5 kHz → RMS ≈ 2-6 kHz) sends the
# candidate through the 96 kHz wide-scan detector instead of the 48 kHz
# channel bank.  Width is measured over ±WIDE_SCAN_WIN_HZ.
WIDE_WIDTH_HZ = 12e3
WIDE_SCAN_WIN_HZ = 35e3
WIDE_SCAN_FS = 96000
# Demod-tracked drift below this is noise (the tone estimator's DFT bin
# is 375-750 Hz for the narrow chains); above it the task frequency
# follows the sonde (the reference's Df rotate, demod/mod/demod_mod.c
# :758-761, does the same inside each decoder).
DRIFT_MIN_HZ = 500.0


def _wire_scale(x):
    """Device-side wire scaling of native-width [.., 2, T] planes to f32.
    cs16: exact power-of-two scale (value-identical to the host-side
    /32768.0 float conversion); cu8: (x - 127.5)/128, as the reference
    decoders.  Shipping int16/uint8 halves/quarters the host->device
    transfer."""
    if x.dtype == jnp.int16:
        return x.astype(jnp.float32) * jnp.float32(1.0 / 32768.0)
    if x.dtype == jnp.uint8:
        return (x.astype(jnp.float32) - 127.5) * jnp.float32(1 / 128)
    return x.astype(jnp.float32)


def _demod_cfg(fs: int, rs: int, est: int = 10000, mask: int = 0):
    p = 5
    ts = fs // rs
    while ts % p and p > 1:
        p -= 1
    nsym = max(50, min(300, 4800 * 300 // rs))
    while (fs // rs) * nsym < 2 ** int(np.ceil(np.log2(fs / (0.1 * rs)))):
        nsym *= 2
    return FSKConfig(fs=fs, rs=rs, m=2, p=p, nsym=nsym,
                     est_min=-est, est_max=est,
                     tone_spacing=mask, freq_est_type=1 if mask else 0)


# Per-type demod chain parameters: raw symbol rate on the 48 kHz channel
# and soft-bit polarity for the decoder, following the reference's
# experimental fsk_demod chains (reference auto_rx/autorx/decode.py
# :846-1476).  Types whose raw rate does not divide the channel rate use
# the nearest divisor (the demod's nin clock tracking absorbs the ppm).
CHAIN_TABLE = {
    "RS41": dict(rs=4800, mask=5000, est=5000),
    # RS92's Manchester stream has a strong 2.4 kHz line comb; the mask
    # (tone-pair) estimator is required to lock the true FSK tones
    "RS92": dict(rs=4800, est=5000, mask=4800),
    # DFM: 2500 Bd raw Manchester (reference decode.py:1039) — resample
    # the 48 kHz channel to 50 kHz so Ts = 20 exactly (2400 Bd on 48 kHz
    # would be 4% off, far beyond the demod's clock tracking)
    "DFM": dict(rs=2500, est=5000, resample_to=50000),
    # M10 runs at 9615.4 Bd: resample the 48 kHz channel to 48.08 kHz so
    # Ts = 5 exactly (reference uses tsrc for the same ratio,
    # auto_rx/test/README.md:13-22).  M20 is 9600 Bd (dft_detect.c:70-75)
    # which divides 48 kHz exactly — no resampling.
    "M10": dict(rs=9616, est=10000, resample_to=48080),
    "M20": dict(rs=9600, est=10000),
    "LMS6": dict(rs=4800, est=10000),
    "IMET5": dict(rs=4800, est=5000, mask=5000),
    "MEISEI": dict(rs=2400, est=10000),
    "MRZ": dict(rs=4800, est=10000),
    "MTS01": dict(rs=1200, est=5000),
    # iMet-1/4: Bell-202 AFSK rides on the FM audio — discriminate first,
    # then run the FSK engine on the audio tones (imet/imet4iq.c chain,
    # decode.py:608-660)
    "IMET4": dict(afsk=True),
    "IMET1RS": dict(afsk=True),
    "IMET1AB": dict(afsk=True),
    # Weathex: 50 kHz tone spacing on a 96 kHz channel (reference
    # decode.py:1388-1458: 96 kHz IQ, mask 50000) — needs a wideband
    # station (fs_ch = 96 kHz, e.g. 25 channels of 2.4 MHz); wide_fs
    # documents the required channel rate
    "WXR301": dict(rs=4800, est=55000, mask=50000, wide_fs=96000),
    # PN9 variant runs 5 kBd: resample the 96 kHz channel to 100 kHz
    "WXRPN9": dict(rs=5000, est=55000, mask=50000, wide_fs=96000,
                   resample_to=100000),
    "RD94RD41": dict(rs=4800, est=20000),   # ref decode.py:995
    # LMS6-1680/MK2A: 9616 Bd wide-deviation 2FSK on a 240 kHz channel
    # (reference decode.py:661-699: 240 kHz IQ, mk2a1680mod --decFM; the
    # fsk_demod chain used mask=100000).  Needs a wideband station
    # (num_channels sized so fs_ch=240 kHz); resample 601/600 -> Ts=25.
    "MK2LMS": dict(rs=9616, est=110000, mask=100000, resample_to=240400),
    # RS92-NGP: 1680 MHz RS92-D — same 4800 Bd Manchester frame as SGP but
    # wider deviation (h~4.2 -> ~20 kHz tone spacing, reference
    # rs92mod.c:1940-1941) and scrambled cal/PTU; decoded on a wideband
    # (240 kHz) channel (reference scan.py:488-498 uses --bw 32 at 1680)
    "RS92NGP": dict(rs=4800, est=32000, mask=20000, wide_fs=240000),
}

# detector type name -> models registry name
MODEL_NAME = {"RD94RD41": "DROPSONDE", "IMET4": "IMET", "IMET1RS": "IMET",
              "IMET1AB": "IMET", "RS92NGP": "RS92"}


class _BandProfile:
    """Channelizer + detector geometry for one capture configuration.

    The narrow profile carves the capture into 48 kHz sonde channels;
    the wide profile (used above 1 GHz, reference scan.py:488-547 1680 MHz
    mode) uses few wide channels for MK2LMS/RS92-NGP."""

    def __init__(self, n_chan: int, fs_wide: int, wide: bool = False):
        from radiosonde_auto_rx_jax.detect.templates import \
            WIDEBAND_TEMPLATES
        self.n_chan = n_chan
        self.fs_ch = fs_wide // n_chan
        self.freqs = channel_freqs(n_chan, fs_wide)
        self.pfb_taps = pfb_prototype(n_chan)
        self.wide = wide
        self.detector = SondeDetector(
            self.fs_ch, specs=WIDEBAND_TEMPLATES if wide else None,
            lband=wide)


class Station:
    """Batch station: wideband IQ blocks in, telemetry out.

    The capture center frequency is retunable per block
    (``process_capture(block, center_freq_hz=...)``) so one station hops a
    band plan covering ``min_freq..max_freq`` (reference scan.py retunes
    rtl_power/dft_detect per pass, :413-656); task state is keyed by
    absolute frequency so decoders survive retunes."""

    def __init__(self, config: dict | None = None, exporters=None,
                 center_freq_hz: float = 402.5e6, mesh=None):
        self.config = {**default_config(), **(config or {})}
        self.exporters = exporters or []
        self.center_freq = center_freq_hz
        self.fs_wide = int(self.config["capture_rate"])
        self.n_chan = int(self.config["num_channels"])
        self._narrow = _BandProfile(self.n_chan, self.fs_wide)
        self._wide = None            # built lazily for >1 GHz captures
        # Build a (ch, t) mesh over ALL devices and run the full sharded
        # station step (parallel/station_step.py) as the per-block
        # device program via ``process_captures`` — one code path from
        # one chip to a pod (a 1-device mesh is the single-chip program;
        # tests value-check it against the legacy per-block path).
        # Default n_t=1: at production block lengths a time shard cannot
        # hold the demod halo (nmem + frame margin ~= 0.8 s);
        # ``mesh_time_shards`` only pays on multi-second blocks.
        if mesh is None and bool(self.config.get("use_mesh", True)):
            from radiosonde_auto_rx_jax.parallel.mesh import make_mesh
            mesh = make_mesh(
                n_t=int(self.config.get("mesh_time_shards", 1)))
        self.mesh = mesh
        self._sharded_steps = {}     # (n_chan, fs_ch) -> ShardedStationStep
        self.rt_filter = RealtimeVelocityFilter(self.config["max_velocity"])
        # parallel host frame plane: decoder worker pool (0 = inline,
        # -1 = auto-size; workers spawn lazily on first decode).
        # Replaces the reference's process-per-sonde decoder subprocesses
        # (reference decode.py:1602-2002) with an affinity-routed pool.
        from radiosonde_auto_rx_jax.station.frame_plane import FramePlane
        n_workers = int(self.config.get("frame_plane_workers", -1))
        if n_workers < 0:
            import os as _os
            n_workers = min(4, max(1, (_os.cpu_count() or 2) - 1))
        self.frame_plane = FramePlane(n_workers)
        # task state (reference auto_rx.py task_list / temporary_block_list)
        self.active = {}             # freq_hz (int) -> dict(type, decoder, last_ok)
        self.temporary_blocks = {}   # freq_hz -> unblock time
        self.scan_results = []
        self.stats = dict(frames_ok=0, frames_filtered=0, detections=0)
        # web-control state (reference web.py control endpoints :445-661)
        self.scan_enabled = True
        self.manual_tasks = {}       # freq_hz (int) -> forced type name
        # per-block recentering state: channel index -> offset (Hz) of
        # the task/candidate frequency from the channel center.  Set by
        # the scan/forced-task mapping each block; freq_of_channel folds
        # it in so every downstream fz is the recentered frequency.
        self._offsets = {}
        self._ext_off = {}           # row -> offset its row was
                                     # EXTRACTED at (0 = PFB center);
                                     # the drift-retune anchor
        self._ex_taps = {}           # n_dec -> wide-extraction prototype
        self._cur_wide = None        # current block's [2, T] planes
        self._wide_freqs = set()     # last scan's wideband candidates
        self._defer_retunes = None   # fz -> target while a multi-block
                                     # collect is in flight (a mid-batch
                                     # rekey would orphan the old key's
                                     # later blocks into a zombie task)
        self._defer_scan = set()     # deferred keys whose target came
                                     # from a scan peak (absorb): more
                                     # current than any resid target

    # ------------------------------------------------------------------ #

    def profile(self, center_freq_hz: float | None = None) -> _BandProfile:
        """Channel geometry for a capture centered here: wide channels
        above 1 GHz (1680 MHz band), narrow below."""
        c = self.center_freq if center_freq_hz is None else center_freq_hz
        if c < 1e9:
            return self._narrow
        if self._wide is None:
            n_wide = int(self.config.get("num_channels_wide", 0)) or \
                max(1, self.fs_wide // 240000)
            self._wide = _BandProfile(n_wide, self.fs_wide, wide=True)
        return self._wide

    # back-compat accessors: geometry of the current center's profile
    @property
    def fs_ch(self):
        return self.profile().fs_ch

    @property
    def freqs(self):
        return self.profile().freqs

    @property
    def pfb_taps(self):
        return self.profile().pfb_taps

    @property
    def detector(self):
        return self.profile().detector

    def channel_of_freq(self, freq_hz: float) -> int:
        prof = self.profile()
        rel = freq_hz - self.center_freq
        return int(np.argmin(np.abs(prof.freqs - rel)))

    def _chan_center(self, ci: int) -> float:
        """Absolute center frequency of channel ``ci`` (no offset)."""
        return self.center_freq + float(self.profile().freqs[ci])

    def freq_of_channel(self, ci: int) -> int:
        """Absolute (task-key) frequency of row ``ci`` in the current
        profile, including any recentering offset registered for it this
        block (off-grid candidates/tasks).  Rows beyond the PFB grid
        (second sonde in one channel) store their absolute frequency
        directly."""
        if ci >= self.profile().n_chan:
            return int(round(self._offsets.get(ci, 0.0)))
        return int(round(self._chan_center(ci) +
                         self._offsets.get(ci, 0.0)))

    def in_capture(self, freq_hz: float) -> bool:
        return abs(freq_hz - self.center_freq) <= self.fs_wide / 2

    def _blocked(self, freq_hz: float) -> bool:
        now = time.time()
        for f, until in list(self.temporary_blocks.items()):
            if until < now:
                del self.temporary_blocks[f]
        return any(abs(freq_hz - f) < self.config["quantization"]
                   for f in self.temporary_blocks)

    # ------------------------------------------------------------------ #

    @staticmethod
    def _wide_planes(x):
        """Normalize wideband input to float32 [2, T] planes (accepts
        complex [T] or planes — the block sources emit planes).  Host
        complex input is split into planes on the host."""
        if np.iscomplexobj(x) and not isinstance(x, jnp.ndarray):
            x = np.asarray(x)
            return jnp.asarray(
                np.stack([x.real, x.imag]).astype(np.float32))
        x = jnp.asarray(x)      # native-width planes transfer as-is
        if jnp.iscomplexobj(x):
            return jnp.stack([x.real, x.imag]).astype(jnp.float32)
        assert x.ndim == 2 and x.shape[0] == 2, "expect [2, T] planes"
        return _wire_scale(x)

    def _wide_batch(self, blocks, n_rows: int, sharding):
        """[n_rows, 2, T] f32 wideband batch (zero rows pad ``blocks``)
        placed straight onto ``sharding``: each ch shard's captures go
        to its own device, and the batch is never staged whole on one.
        Native-width host blocks (the block sources' cs16/cu8 planes)
        transfer as-is and are scaled on their devices."""
        host = [np.asarray(b) for b in blocks
                if isinstance(b, np.ndarray) and not np.iscomplexobj(b)]
        if len(host) == len(blocks) and \
                len({(b.dtype, b.shape) for b in host}) == 1:
            arr = np.zeros((n_rows,) + host[0].shape, host[0].dtype)
            arr[:len(host)] = host
            return _wire_scale(jax.device_put(arr, sharding))
        planes = [self._wide_planes(b) for b in blocks]
        assert len({p.shape for p in planes}) == 1, \
            "sharded batch blocks must share a length"
        pad = [jnp.zeros_like(planes[0])] * (n_rows - len(planes))
        return jax.device_put(jnp.stack(planes + pad), sharding)

    def _cand_of_freq(self, f_abs: float,
                      snap_hz: float = RECENTER_MIN_HZ):
        """Absolute frequency -> (channel, offset-from-channel-center)
        candidate.  Offsets below ``snap_hz`` demodulate at the channel
        center (PFB row as-is); larger ones are recentered."""
        ci = self.channel_of_freq(f_abs)
        off = f_abs - self._chan_center(ci)
        return (ci, 0.0 if abs(off) < snap_hz else float(off))

    def scan(self, wideband_iq) -> list:
        """PSD scan -> candidate (channel, offset_hz) pairs in the
        current capture (reference scan.py sonde_search :948-1097;
        only_scan/always_scan semantics from scan.py:1034-1097).  The
        offset carries ``peak − channel_center`` for off-grid sondes
        (the real 10 kHz raster); the capture path recenters those
        candidates from the wideband block.  Configured frequencies
        outside the current capture span are skipped — the band
        scheduler brings their segment around."""
        if self.config["only_scan"]:
            return self.scan_from_psd(None)
        planes = self._wide_planes(wideband_iq)
        # sparse Welch (one 2048-segment per 8192 samples): a block
        # still integrates hundreds of segments, so floor/peaks are
        # unchanged within noise (tests/test_ops.py) at 1/4 the
        # input traffic — the reference integrates its PSD over
        # ~20 s of rtl_power dwell for the same reason in reverse
        # (reference autorx/scan.py:948-1009)
        pfreqs, psd = power_spectrum(planes[None], nfft=2048, hop=8192,
                                     fs=self.fs_wide)
        return self.scan_from_psd(psd[0], db=True)

    def scan_from_psd(self, psd, db: bool = False) -> list:
        """Candidates from a precomputed wideband PSD (raw ``_welch``
        power, or dB with ``db=True``).  The sharded station path feeds
        ``ShardedStationStep.analyze``'s per-capture PSD rows here so
        the scan policy is computed exactly once per block.

        Wideband candidates (spectral RMS width > WIDE_WIDTH_HZ —
        Weathex & friends) are flagged in ``self._wide_freqs`` for the
        96 kHz wide-scan pass."""
        self._wide_freqs = set()
        if self.config["only_scan"]:
            # whitelist mode: skip the PSD pass entirely
            cands = [self._cand_of_freq(f * 1e6)
                     for f in self.config["only_scan"]
                     if self.in_capture(f * 1e6)]
            return self._scan_tail(cands)
        q = float(self.config["quantization"]) or 10e3
        psd = np.asarray(psd)
        psd_db = psd if db else 10.0 * np.log10(np.maximum(psd, 1e-20))
        nfft = psd_db.shape[-1]
        pfreqs = (np.arange(nfft) - nfft // 2) * (self.fs_wide / nfft)
        peaks, nf = scan_peaks(
            psd_db, pfreqs,
            snr_threshold=self.config["snr_threshold"],
            min_distance_hz=self.config["min_distance"],
            quantization_hz=0)
        # quantize peaks to the ABSOLUTE 10 kHz sonde raster (reference
        # scan.py:1034: real sondes transmit on 10 kHz multiples) and
        # apply never_scan blocks
        fq_abs = np.unique(np.round((np.asarray(peaks) +
                                     self.center_freq) / q) * q)
        fq_abs = [float(f) for f in fq_abs
                  if not any(abs(f - b * 1e6) < q / 2
                             for b in self.config["never_scan"])]
        # refine each raster point to the local spectral CENTROID: the
        # PSD peak of an FSK signal sits on a TONE, not the carrier
        # (M10/M20 tones are ±5 kHz out), so one sonde can nominate two
        # raster points and the raster point itself can be a tone.  The
        # floor-subtracted power centroid over ±q recovers the carrier
        # to ~the scan bin; candidates within min_distance then collapse
        # to the strongest (the reference gets the same collapse from
        # detect_peaks' mpd before its quantize, scan.py:1034-1097).
        bin_hz = self.fs_wide / nfft
        p_lin = np.maximum(10 ** (psd_db / 10.0) - 10 ** (nf / 10.0), 0.0)

        def _centroid(f_abs, win_hz):
            """(centroid f_abs, RMS width Hz) of the floor-subtracted
            power within ±win_hz."""
            k = (f_abs - self.center_freq) / bin_hz + nfft // 2
            lo = max(0, int(round(k - win_hz / bin_hz)))
            hi = min(nfft, int(round(k + win_hz / bin_hz)) + 1)
            w = p_lin[lo:hi]
            if w.sum() <= 0:
                return f_abs, 0.0
            ks = np.arange(lo, hi)
            kc = float((w * ks).sum() / w.sum())
            var = float((w * (ks - kc) ** 2).sum() / w.sum())
            return ((kc - nfft // 2) * bin_hz + self.center_freq,
                    np.sqrt(max(var, 0.0)) * bin_hz)

        # can this station wide-scan?  (the ``wideband_sondes`` config
        # enables Weathex-class detection, as in the reference
        # config.py; plus: narrow profile, and a capture rate the
        # 96 kHz extraction divides — the L-band profile's channels
        # are already wide)
        can_wide = (bool(self.config.get("wideband_sondes", False)) and
                    not self.profile().wide and
                    self.fs_wide % WIDE_SCAN_FS == 0)
        refined = []                 # (strength_db, f_abs, is_wide)
        for f in fq_abs:
            k = (f - self.center_freq) / bin_hz + nfft // 2
            fc, _ = _centroid(f, q)
            wide_c = False
            if can_wide:
                # a wideband signal's PSD peaks are its TONES (±25 kHz
                # for Weathex): re-center over the wide window so the
                # candidate lands on the carrier, and flag it for the
                # 96 kHz wide-scan detector
                fw, width = _centroid(fc, WIDE_SCAN_WIN_HZ)
                if width > WIDE_WIDTH_HZ:
                    fc, wide_c = fw, True
            ki = min(nfft - 1, max(0, int(round(k))))
            refined.append((float(psd_db[ki]), round(float(fc), -2),
                            wide_c))
        # strongest-first collapse within decoder_spacing_limit: one
        # sonde's spectral sidelobes nominate several raster points —
        # the reference gets the same collapse sequentially (each
        # detection within spacing of a just-started decoder is dropped,
        # auto_rx.py:304-419); block-parallel detection applies it here
        spacing = max(float(self.config["min_distance"]),
                      float(self.config.get("decoder_spacing_limit",
                                            15e3)))
        fq_abs, kept = [], []
        self._wide_freqs = set()
        for s, f, wide_c in sorted(refined, reverse=True):
            # re-apply never_scan AFTER the centroid refinement: a
            # blocked interferer's power dominates a neighboring raster
            # point's centroid window, walking that candidate right
            # back onto the blocked frequency
            if any(abs(f - b * 1e6) < q / 2
                   for b in self.config["never_scan"]):
                continue
            if all(abs(f - g) >= spacing for g in kept):
                kept.append(f)
                fq_abs.append(f)
                if wide_c:
                    # key by the SNAPPED candidate frequency — the
                    # capture path reconstructs it as channel_center +
                    # snapped offset (_cand_of_freq), so a sub-snap
                    # (<1 kHz) carrier offset must round away here too
                    # or the wide candidate misses the lookup and is
                    # lost down the narrow path
                    ci_w, off_w = self._cand_of_freq(f)
                    self._wide_freqs.add(
                        int(round(self._chan_center(ci_w) + off_w)))
        fq_abs.sort()
        # latest scan for the web UI (reference scan.py:47-54
        # pushes freq/power/peaks to the browser)
        self.scan_results = {
            "timestamp": time.time(),
            "freq": ((pfreqs + self.center_freq) / 1e6).round(4).tolist(),
            "power": np.round(psd_db, 1).tolist(),
            "peak_freq": [f / 1e6 for f in fq_abs],
            "noise_floor": round(nf, 1),
        }
        # channel + offset per candidate: centroid jitter below
        # RECENTER_MIN_HZ is the on-grid case (PFB row as-is); larger
        # offsets are true off-grid sondes
        cands = [self._cand_of_freq(f) for f in fq_abs]
        # always_scan frequencies join every detect pass
        for f_mhz in self.config["always_scan"]:
            if self.in_capture(f_mhz * 1e6):
                cands.append(self._cand_of_freq(f_mhz * 1e6))
        return self._scan_tail(cands)

    def _scan_tail(self, cands: list) -> list:
        spacing = float(self.config.get("decoder_spacing_limit", 15e3))
        for f_mhz in self.config["always_decode"]:
            if self.in_capture(f_mhz * 1e6):
                cands.append(self._cand_of_freq(f_mhz * 1e6))
        out, seen = [], set()
        for ci, off in sorted(cands):
            fq = self._chan_center(ci) + off
            if self._blocked(fq):
                continue
            if self._absorb_candidate(fq, spacing):
                continue
            key = (ci, int(round(off)))
            if key in seen:
                continue
            seen.add(key)
            out.append((ci, off))
        return out[: self.config["max_peaks"]]

    def _absorb_candidate(self, fq: float, spacing: float) -> bool:
        """A candidate within ``decoder_spacing_limit`` of an active or
        manual task is the SAME (possibly drifting) sonde — never spawn
        a second task (reference auto_rx.py:304-419).  If the active
        task's frequency lags the new peak by a full scan quantum, move
        the task to the peak: the reference leaves its SDR tuned and
        lets the decoder's Df rotate follow (demod_mod.c:758-761); here
        the recentering NCO is the Df analogue, so retuning the task IS
        the follow."""
        for fz in self.manual_tasks:
            if abs(fq - fz) <= spacing:
                return True
        for fz in list(self.active):
            if abs(fq - fz) <= spacing:
                if abs(fq - fz) >= float(self.config["quantization"]):
                    if self._defer_retunes is not None:
                        # mid-batch (multi-block collect policy): a
                        # rekey now would orphan the blocks that
                        # snapshotted fz before this one — defer, and
                        # mark the target as scan-sourced so a staler
                        # in-batch resid target cannot overwrite it
                        self._defer_retunes[fz] = fq
                        self._defer_scan.add(fz)
                    else:
                        self._retune(fz, fq)
                return True
        return False

    def _retune(self, old_fz: int, new_fz: float):
        """Move an active task to a new frequency, preserving decoder
        state (drift follow)."""
        new_fz = int(round(new_fz))
        if new_fz == old_fz or old_fz not in self.active \
                or new_fz in self.active:
            return
        self.active[new_fz] = self.active.pop(old_fz)
        self.frame_plane.rekey(old_fz, new_fz)
        log.info("drift: task %.4f MHz -> %.4f MHz",
                 old_fz / 1e6, new_fz / 1e6)

    # ------------------------------------------------------------------ #

    def process_capture(self, wideband_iq, center_freq_hz=None) -> list:
        """One full cycle: scan -> detect -> demod -> decode -> export.

        ``center_freq_hz`` retunes the station for this block (band-plan
        hopping; task state is frequency-keyed so decoders persist across
        hops).  Returns the accepted telemetry dicts."""
        if center_freq_hz is not None:
            self.center_freq = float(center_freq_hz)
        prof = self.profile()
        n_chan = prof.n_chan
        planes = self._wide_planes(wideband_iq)
        self._cur_wide = planes
        self._offsets = {}
        self._ext_off = {}
        cands = self.scan(planes) if self.scan_enabled else []
        # row allocation: each task/candidate frequency gets one row of
        # the channel bank.  On-grid rows are PFB channels; off-grid
        # rows are recentered extractions scattered over (or, when two
        # sondes share a channel, appended after) the PFB rows.
        rec = {}                     # row < n_chan -> extraction f_rel
        extra = []                   # appended rows' extraction f_rel
        row_alloc = {}               # row -> f_abs

        def _alloc(f_abs: float) -> int:
            ci = self.channel_of_freq(f_abs)
            off = f_abs - self._chan_center(ci)
            if ci not in row_alloc:
                row = ci
                if abs(off) >= RECENTER_MIN_HZ:
                    rec[row] = float(prof.freqs[ci]) + off
                    self._ext_off[row] = float(off)
            elif abs(row_alloc[ci] - f_abs) < 1.0:
                return ci
            else:
                # second task inside one channel (>= spacing apart):
                # its own recentered row, appended after the PFB rows
                row = n_chan + len(extra)
                extra.append(float(prof.freqs[ci]) + off)
                # the drift-retune anchor: this row is EXTRACTED at
                # f_abs; a later detector freq_offset refinement bumps
                # the task key but not the extraction
                self._ext_off[row] = float(f_abs)
            row_alloc[row] = float(f_abs)
            self._offsets[row] = f_abs - (
                self._chan_center(row) if row < n_chan else 0.0)
            return row

        # manual tasks + known-active sondes within this capture
        # re-decode every visit without needing a fresh detection
        forced = {}                  # row -> type name
        for fz, name in self.manual_tasks.items():
            if self.in_capture(fz):
                forced[_alloc(fz)] = name
        for fz, st in self.active.items():
            if self.in_capture(fz):
                forced.setdefault(_alloc(fz), st["type"])
        cand_rows = []
        wide_cands = []
        for ci, off in cands:
            fq = self._chan_center(ci) + off
            if int(round(fq)) in self._wide_freqs:
                wide_cands.append(fq)
                continue
            row = _alloc(fq)
            if row not in forced:
                cand_rows.append(row)
        ch = channelize(planes, n_chan, prof.pfb_taps)
        ch = self._apply_recenter(ch, planes, prof, rec, extra)
        n_rows = n_chan + len(extra)
        tasks = [(row, name, None) for row, name in forced.items()]
        if cand_rows:
            detections = prof.detector.detect(ch[np.array(cand_rows)])
            for row, dets in zip(cand_rows, detections):
                if not dets:
                    continue
                det = dets[0]
                self.stats["detections"] += 1
                name = det.name
                if prof.wide and name == "RS92":
                    # an RS92 header at 1680 MHz is an RS92-NGP
                    # (reference decode.py:948 starts rs92mod --ngp)
                    name = "RS92NGP"
                if name in CHAIN_TABLE or name in MODEL_NAME:
                    # the detector's FM-DC offset estimate refines the
                    # task frequency when it shows the scan center was
                    # materially off (the Df refinement of
                    # demod_mod.c:758-761); the demod's own f_est
                    # feedback trims the rest after decode
                    if det.freq_offset and \
                            RECENTER_MIN_HZ <= abs(det.freq_offset) <= 5e3:
                        self._offsets[row] = self._offsets.get(row, 0.0) \
                            + float(det.freq_offset)
                    tasks.append((row, name, det))
        tasks = self._dedupe_tasks(tasks)
        # group same-type channels into one batched demod call — the
        # channel batch IS the parallel axis, one device dispatch per
        # type.  Grouping runs through the EP-routing compaction
        # primitive (parallel/routing.compact_by_type — the same slot
        # layout route_to_experts ships over the mesh all_to_all;
        # value-tested against a host dict grouping in
        # tests/test_routing.py).
        telemetry_out = []
        for name, items in self.group_tasks_by_type(
                tasks, n_rows).items():
            telemetry_out.extend(self.decode_channels(ch, items, name))
        # wideband candidates (Weathex & friends): 96 kHz wide-scan
        # detect + decode from the retained wideband block
        for fq in wide_cands:
            telemetry_out.extend(
                self._process_wide_candidate(prof, planes, fq))
        return telemetry_out

    def _wide_scan_detector(self):
        """Lazy 96 kHz detector for wideband types: the real ±25 kHz
        tone pairs are outside any 48 kHz channel, so wide candidates
        re-detect on a 96 kHz extraction with a 64 kHz IF class (the
        audio lowpass then recovers the baud pattern — dft_detect's
        structure at the rate the signal actually needs)."""
        det = getattr(self, "_wide_det", None)
        if det is None:
            import dataclasses
            from radiosonde_auto_rx_jax.detect.templates import TEMPLATES
            specs = [dataclasses.replace(s, lp_iq=0)
                     for s in TEMPLATES if s.name.startswith("WXR")]
            det = SondeDetector(WIDE_SCAN_FS, specs=specs,
                                prescreen=False,
                                bw_table=(64e3, 64e3, 64e3, 200e3))
            self._wide_det = det
        return det

    def _process_wide_candidate(self, prof, planes, f_abs: float) -> list:
        """Wide-scan one flagged candidate: extract a 96 kHz channel at
        its carrier from the wideband block, detect with the wide bank,
        decode through the wideband chain.  Falls back to the narrow
        single-channel path when no wide type confirms (the width gate
        can fire on overlapping narrow signals)."""
        n_dec = self.fs_wide // WIDE_SCAN_FS
        h = self._ex_taps.get(n_dec)
        if h is None:
            h = self._ex_taps.setdefault(n_dec, pfb_prototype(n_dec))
        f_rel = float(f_abs) - self.center_freq
        row96 = extract_channels(planes, self.fs_wide, [f_rel],
                                 n_dec, h)[0]
        dets = self._wide_scan_detector().detect(row96[None],
                                                 prescreen=False)[0]
        if not dets:
            return self._process_collision(prof, planes, f_abs)
        det = dets[0]
        self.stats["detections"] += 1
        name = det.name
        if name not in CHAIN_TABLE:
            return []
        n_chan = prof.n_chan
        self._offsets[n_chan] = float(f_abs)     # virtual row
        self._ext_off[n_chan] = float(f_abs)     # demod anchor = here
        # the detection row is already at WIDE_SCAN_FS — reuse it when
        # that IS the chain's rate (WXR*); other rates re-extract
        ready = int(CHAIN_TABLE[name].get("wide_fs", 0)) == WIDE_SCAN_FS
        return self.decode_channels(row96[None], [(0, det)], name,
                                    chan_map={0: n_chan},
                                    wide_ready=ready)

    def _dedupe_tasks(self, tasks: list) -> list:
        """Spacing rule over a block's freshly detected tasks: a
        detection within ``decoder_spacing_limit`` of an existing
        (forced) task or of a stronger detection is the same sonde —
        exactly the reference's sequential handle_scan_results check
        (auto_rx.py:304-419) applied to block-parallel detections."""
        spacing = float(self.config.get("decoder_spacing_limit", 15e3))
        order = sorted(tasks, key=lambda t: (
            t[2] is not None, -(t[2].score if t[2] is not None else 0.0)))
        kept, out = [], []
        for row, name, det in order:
            fz = self.freq_of_channel(row)
            if det is not None and any(abs(fz - g) < spacing
                                       for g in kept):
                continue
            kept.append(fz)
            out.append((row, name, det))
        return out

    def _apply_recenter(self, ch, planes, prof, rec: dict, extra: list):
        """Recenter off-grid rows from the wideband block: one
        ``extract_channels`` call covers scattered replacements (``rec``:
        row -> f_rel) and appended rows (``extra``: list of f_rel).  The
        extraction slot count pads to a power of two so the device
        program compiles for O(log n) shapes."""
        n_work = len(rec) + len(extra)
        if n_work == 0:
            return ch
        f_list = [f for _, f in sorted(rec.items())] + list(extra)
        S = 1 << max(0, int(np.ceil(np.log2(n_work))))
        f_list += [0.0] * (S - n_work)
        ext = extract_channels(planes, self.fs_wide, f_list,
                               prof.n_chan, prof.pfb_taps)
        if rec:
            rows = np.fromiter(sorted(rec), np.int32, len(rec))
            ch = ch.at[jnp.asarray(rows)].set(ext[:len(rec)])
        if extra:
            ch = jnp.concatenate(
                [ch, ext[len(rec):len(rec) + len(extra)]])
        return ch

    # ------------------------------------------------------------------ #
    # multi-chip production path: the sharded station step

    def _sharded_step(self, prof):
        """Build/cache the mesh program for this channel geometry."""
        key = (prof.n_chan, prof.fs_ch)
        st = self._sharded_steps.get(key)
        if st is None:
            from radiosonde_auto_rx_jax.parallel.station_step import \
                ShardedStationStep
            # confirmation slots must cover a scan's worth of candidates
            # regardless of mesh size (2 slots/shard on an 8-way mesh
            # equals the old top-16 survivor cap; a 1-device mesh gets
            # the same TOTAL slots, just all on one shard)
            n_sh = self.mesh.shape["ch"]
            conf_default = max(2, -(-2 * int(self.config.get(
                "max_peaks", 10)) // n_sh))
            st = ShardedStationStep(
                self.mesh, n_chan=prof.n_chan, fs_ch=prof.fs_ch,
                capacity=int(self.config.get("expert_capacity", 4)),
                conf_capacity=int(self.config.get("confirm_capacity",
                                                  conf_default)))
            self._sharded_steps[key] = st
        return st

    def process_captures(self, blocks, centers=None) -> list:
        """Multi-block cycle: B wideband blocks through ONE sharded
        device program when a mesh is configured.

        This is the production multi-chip path (round-3 verdict #1): the
        reference runs all SDR tasks concurrently as subprocesses
        (reference auto_rx/auto_rx.py:101-128); here each source's block
        becomes one row of the batched ``ShardedStationStep`` dataflow —
        channelize → PSD → prescreen ratios on the mesh, scan policy +
        full-rate confirmation for type decisions, expert all-to-all
        routing + per-type demod on the mesh, frame decode on the host.
        Telemetry equals the per-block single-device ``process_capture``
        (tests/test_station_sharded.py).  Falls back to the sequential
        path without a mesh or for wideband (L-band) captures."""
        return self.captures_collect(self.captures_dispatch(blocks,
                                                            centers))

    def captures_dispatch(self, blocks, centers=None):
        """Enqueue the data-independent device analysis for a block
        batch (channelize + PSD + prescreen ratios); pair with
        ``captures_collect``.  Splitting lets the driver double-buffer:
        batch N+1's device work is in flight while batch N's host
        policy/decode runs."""
        if centers is None:
            centers = [self.center_freq] * len(blocks)
        centers = [float(c) for c in centers]
        if self.mesh is None or any(
                self.profile(c).wide for c in centers):
            return ("seq", list(blocks), centers)
        prof = self.profile(centers[0])
        step = self._sharded_step(prof)
        B_pad = -(-len(blocks) // step.n_sh) * step.n_sh
        wide = self._wide_batch(blocks, B_pad,
                                step.sharding(P(CH_AXIS, None, T_AXIS)))
        if self.mesh.size == 1 and \
                bool(self.config.get("fused_steady_step", True)):
            return self._dispatch_steady(step, prof, wide, len(blocks),
                                         centers)
        # screen=False: candidates come from the PSD scan peaks and go
        # straight to the full-rate confirm pass (screening all channels
        # costs more than confirming <= max_peaks candidates exactly)
        chf, psd, _ = step.analyze(wide, screen=False)
        return ("sharded", step, prof, wide, chf, psd, len(blocks),
                centers)

    def _dispatch_steady(self, step, prof, wide, B, centers):
        """Speculative fused dispatch (round-4 verdict #6): predict the
        block's tasks from current task state and run channelize + PSD
        + forced-row recentering + per-type demod as ONE device program.
        ``captures_collect`` validates the prediction against the real
        scan policy; mismatched channels re-demodulate via the split
        path (the overwhelmingly common block matches)."""
        n_chan = prof.n_chan
        pred = {}                    # cid -> (name, f_abs)
        rec = {}                     # cid -> extraction f_rel
        for b in range(B):
            self.center_freq = centers[b]
            for fz, name in self.manual_tasks.items():
                if self.in_capture(fz):
                    ci = self.channel_of_freq(fz)
                    pred.setdefault(b * n_chan + ci, (name, float(fz)))
            for fz, st_a in self.active.items():
                if self.in_capture(fz):
                    ci = self.channel_of_freq(fz)
                    pred.setdefault(b * n_chan + ci,
                                    (st_a["type"], float(fz)))
        type_cids = {}
        for cid, (name, f_abs) in pred.items():
            b, ci = divmod(cid, n_chan)
            chain = CHAIN_TABLE.get(name)
            if chain is None or chain.get("wide_fs", 0) > prof.fs_ch:
                continue             # wide chains extract per-task
            type_cids.setdefault(name, []).append(cid)
            off = f_abs - (centers[b] + float(prof.freqs[ci]))
            if abs(off) >= RECENTER_MIN_HZ:
                rec[cid] = float(prof.freqs[ci]) + off
        # static plan with power-of-two padded counts (pads repeat the
        # first id — dropped on the host) so the compile cache covers
        # active-set sizes in O(log) signatures per type mix
        plan, idx, fused_pos = [], [], {}
        for name in sorted(type_cids):
            cids = sorted(type_cids[name])
            n = 1 << max(0, int(np.ceil(np.log2(len(cids)))))
            fused_pos.update({cid: (name, k)
                              for k, cid in enumerate(cids)})
            plan.append((name, n))
            idx.extend(cids + [cids[0]] * (n - len(cids)))
        # recentering slot arrays (power-of-two padded)
        items = sorted(rec.items())
        S = (1 << max(0, int(np.ceil(np.log2(len(items)))))) \
            if items else 0
        T = int(wide.shape[-1])
        M = T // n_chan
        ph_m = np.zeros((S, M), np.float32)
        ph_r = np.zeros((S, n_chan), np.float32)
        blk = np.zeros(S, np.int32)
        rows = np.full(S, int(wide.shape[0]) * n_chan, np.int32)
        for s, (cid, f_rel) in enumerate(items):
            from radiosonde_auto_rx_jax.ops.channelizer import \
                extract_phases
            ph_m[s], ph_r[s] = extract_phases(f_rel, self.fs_wide, T,
                                              n_chan)
            blk[s] = cid // n_chan
            rows[s] = cid
        # scan duty: while decoding, scan the PSD only every
        # ``scan_every`` blocks (the reference's single-SDR stations
        # cannot scan AT ALL while a decoder holds the SDR —
        # 1-in-N is strictly better); with no active tasks every
        # block scans
        scan = bool(self.scan_enabled)
        if scan and pred:
            n = max(1, int(self.config.get("scan_every", 4)))
            self._steady_tick = getattr(self, "_steady_tick", -1) + 1
            scan = (self._steady_tick % n) == 0
        chf, psd, fused = step.steady_step(
            wide, jnp.asarray(np.asarray(idx, np.int32)),
            jnp.asarray(blk), jnp.asarray(rows),
            jnp.asarray(ph_m), jnp.asarray(ph_r), tuple(plan),
            scan=scan)
        return ("steady", step, prof, wide, chf, psd, B, centers,
                dict(pred=pred, rec=rec, fused=fused,
                     fused_pos=fused_pos))

    def captures_collect(self, pending) -> list:
        """Finish a ``captures_dispatch`` batch: host scan/task policy,
        sharded confirmation + expert routing, host frame decode."""
        if pending[0] == "seq":
            _, blocks, centers = pending
            out = []
            for b, c in zip(blocks, centers):
                out.extend(self.process_capture(b, center_freq_hz=c))
            return out
        if pending[0] == "steady":
            _, step, prof, wide, chf, psd, B, centers, sinfo = pending
            return self._collect_sharded(step, prof, wide, chf, psd, B,
                                         centers, steady=sinfo)
        _, step, prof, wide, chf, psd, B, centers = pending
        return self._collect_sharded(step, prof, wide, chf, psd, B,
                                     centers)

    def _collect_sharded(self, step, prof, wide, chf, psd, B,
                         centers, steady=None) -> list:
        # drift retunes are deferred for the whole batch (see
        # _post_frames / _absorb_candidate); the freshest measurement
        # wins (scan peaks over resids)
        self._defer_retunes = {}
        self._defer_scan = set()
        try:
            return self._collect_sharded_inner(step, prof, wide, chf,
                                               psd, B, centers, steady)
        finally:
            pending, self._defer_retunes = self._defer_retunes, None
            self._defer_scan = set()
            for fz, target in pending.items():
                self._retune(fz, target)

    def _collect_sharded_inner(self, step, prof, wide, chf, psd, B,
                               centers, steady=None) -> list:
        from radiosonde_auto_rx_jax.parallel.station_step import \
            EXPERT_TYPES
        n_chan = prof.n_chan
        B_pad = -(-B // step.n_sh) * step.n_sh
        psd_np = None if psd is None else np.asarray(psd)

        # host policy per block: scan peaks + task state -> candidates
        # and forced tasks (manual/active)
        tasks = {}                   # global cid -> (name, det)
        cand = []
        cand_strength = {}           # cid -> PSD dB at the channel
        cid_off = {}                 # cid -> recentering offset (Hz)
        rec = {}                     # cid -> extraction f_rel
        collide = []                 # (b, f_abs): 2nd sonde in a channel
        wide_host = []               # (b, f_abs): wideband candidates
        for b in range(B):
            self.center_freq = centers[b]
            self._offsets = {}
            cands_b = (self.scan_from_psd(psd_np[b])
                       if self.scan_enabled and psd_np is not None
                       else [])
            forced = {}              # ci -> (name, f_abs)
            for fz, name in self.manual_tasks.items():
                if self.in_capture(fz):
                    ci = self.channel_of_freq(fz)
                    if ci in forced and abs(forced[ci][1] - fz) >= 1.0:
                        # second manual task inside one channel: host
                        # fallback with its forced type
                        collide.append((b, float(fz), name))
                        continue
                    forced[ci] = (name, float(fz))
            for fz, st_a in self.active.items():
                if self.in_capture(fz):
                    ci = self.channel_of_freq(fz)
                    if ci in forced and \
                            abs(forced[ci][1] - fz) >= 1.0:
                        # second active task inside one channel: its
                        # mesh row is taken — keep it alive through the
                        # host fallback (own extracted row).  Skip when
                        # a manual task already drives this frequency
                        # (its collide entry would decode it twice).
                        if not any(abs(fz - c_f) < 1.0
                                   for _, c_f, _ in collide):
                            collide.append((b, float(fz), None))
                        continue
                    forced.setdefault(ci, (st_a["type"], float(fz)))
            for ci, (name, f_abs) in forced.items():
                cid = b * n_chan + ci
                tasks[cid] = (name, None)
                off = f_abs - self._chan_center(ci)
                cid_off[cid] = off
                if abs(off) >= RECENTER_MIN_HZ:
                    rec[cid] = float(prof.freqs[ci]) + off
            if not cands_b:
                continue
            db = 10.0 * np.log10(np.maximum(psd_np[b], 1e-20))
            nfft = db.shape[-1]
            for ci, off in cands_b:
                cid = b * n_chan + ci
                fq = self._chan_center(ci) + off
                if int(round(fq)) in self._wide_freqs:
                    wide_host.append((b, fq))
                    continue
                if cid in tasks or cid in cid_off:
                    # the channel's mesh row is taken: a second sonde
                    # in the same 48 kHz channel rides the host
                    # fallback (own extracted row, detect + decode)
                    collide.append((b, fq, None))
                    continue
                cand.append(cid)
                cid_off[cid] = off
                if abs(off) >= RECENTER_MIN_HZ:
                    rec[cid] = float(prof.freqs[ci]) + off
                # the candidate's PSD neighborhood (for overflow rank)
                k = int(round((prof.freqs[ci] + off) / self.fs_wide *
                              nfft)) + nfft // 2
                lo = max(0, k - nfft // (2 * n_chan))
                cand_strength[cid] = float(
                    db[lo:k + nfft // (2 * n_chan) + 1].max())
        # recenter off-grid rows from the retained wideband blocks
        # BEFORE confirmation/routing: downstream sees centered signals.
        # The fused steady dispatch already recentered the predicted
        # forced rows in-device — only new/changed rows re-extract here;
        # rows the dispatch recentered but the (post-retune) policy no
        # longer wants are RESTORED to the channel center (an extraction
        # at the center reproduces the PFB row), so the fallback never
        # demodulates a stale-recentered row.
        ext_cid = {}                 # cid -> offset its row holds NOW
        if steady:
            for cid, f_rel in steady["rec"].items():
                ext_cid[cid] = f_rel - float(prof.freqs[cid % n_chan])
            restore = {cid: float(prof.freqs[cid % n_chan])
                       for cid in steady["rec"] if cid not in rec}
            rec = {cid: f for cid, f in rec.items()
                   if steady["rec"].get(cid) != f}
            rec.update(restore)
        for cid, f_rel in rec.items():
            ext_cid[cid] = f_rel - float(prof.freqs[cid % n_chan])
        chf = self._recenter_cids(chf, wide, prof, rec)

        # full-rate confirmation under the mesh: exact type decisions
        # (headcmp, M10/M20 + iMet disambiguation) identical to the
        # single-device two-phase detector
        S = step.n_conf_slots
        if len(cand) > S:
            order = np.argsort([cand_strength[c] for c in cand])[::-1]
            # no cross-block deferral: channel ids are relative to
            # this cycle's capture centers, which the scan scheduler may
            # retune next cycle — a persistent signal is simply
            # re-nominated by the next PSD scan's peaks
            log.warning("confirmation slots full: dropping the %d "
                        "weakest of %d candidates (re-nominated by the "
                        "next scan if still present)",
                        len(cand) - S, len(cand))
            cand = [cand[i] for i in order[:S]]
        if cand:
            slots = np.full(S, -1, np.int32)
            slots[:len(cand)] = cand
            conf = step.confirm(chf, jnp.asarray(slots))
            for cid, dets in step.decide_confirmed(conf, slots).items():
                if not dets:
                    continue
                det = dets[0]
                self.stats["detections"] += 1
                if det.name in CHAIN_TABLE or det.name in MODEL_NAME:
                    tasks[cid] = (det.name, det)
                    # detector FM-DC refinement of the task frequency
                    # (same rule as the single-device path)
                    foff = det.freq_offset or 0.0
                    if RECENTER_MIN_HZ <= abs(foff) <= 5e3:
                        cid_off[cid] = cid_off.get(cid, 0.0) + foff

        # spacing rule over the fresh detections (same sequential
        # handle_scan_results semantics as _dedupe_tasks): forced tasks
        # hold their ground, then stronger detections absorb weaker
        # ones within decoder_spacing_limit
        spacing = float(self.config.get("decoder_spacing_limit", 15e3))

        def _task_fz(cid):
            b, ci = divmod(cid, n_chan)
            self.center_freq = centers[b]
            return self._chan_center(ci) + cid_off.get(cid, 0.0)

        kept = [_task_fz(cid) for cid, (_, det) in tasks.items()
                if det is None]
        for cid, (nm, det) in sorted(
                ((c, v) for c, v in tasks.items() if v[1] is not None),
                key=lambda kv: -kv[1][1].score):
            fz = _task_fz(cid)
            if any(abs(fz - g) < spacing for g in kept):
                del tasks[cid]
            else:
                kept.append(fz)

        # expert routing over the mesh; non-expert types host-batched.
        # On a single ch shard there is nothing to route: the all-to-all
        # degenerates and the 12-expert switch would demod every
        # expert's capacity slots serially — the host-grouped per-type
        # batch (only the types actually present) is the same program
        # the legacy path runs, so use it.
        exp_ids = np.full(B_pad * n_chan, -1, np.int32)
        host_tasks = {}              # block -> [(ci, name, det)]
        for cid, (name, det) in tasks.items():
            if step.n_sh > 1 and name in EXPERT_TYPES:
                exp_ids[cid] = EXPERT_TYPES.index(name)
            else:
                b, ci = divmod(cid, n_chan)
                host_tasks.setdefault(b, []).append((ci, name, det))
        telems = []
        if (exp_ids >= 0).any():
            res = step.route_demod(chf, jnp.asarray(exp_ids))
            telems.extend(self._decode_routed(step, res, tasks, centers,
                                              n_chan, int(chf.shape[-1]),
                                              cid_off, ext_cid))
        fused_items = []             # (name, j, cid) served by steady
        for b, items in host_tasks.items():
            self.center_freq = centers[b]
            self._offsets = {ci: cid_off.get(b * n_chan + ci, 0.0)
                             for ci, _, _ in items}
            self._ext_off = {ci: ext_cid.get(b * n_chan + ci, 0.0)
                             for ci, _, _ in items}
            self._cur_wide = wide[b]
            legacy = items
            if steady:
                legacy = []
                for ci, name, det in items:
                    cid = b * n_chan + ci
                    fp = steady["fused_pos"].get(cid)
                    # speculation check: same type, same task frequency,
                    # and no re-extraction pending for the row — else
                    # the split path re-demodulates this channel
                    if det is None and fp is not None and \
                            fp[0] == name and cid not in rec and \
                            abs(steady["pred"][cid][1] -
                                (self._chan_center(ci) +
                                 cid_off.get(cid, 0.0))) < 1.0:
                        fused_items.append((name, fp[1], cid))
                    else:
                        legacy.append((ci, name, det))
            rows = chf[b * n_chan:(b + 1) * n_chan]
            for name, grp in self.group_tasks_by_type(
                    legacy, n_chan).items():
                telems.extend(self.decode_channels(rows, grp, name))
        if steady and fused_items:
            self.stats["fused_channels"] = \
                self.stats.get("fused_channels", 0) + len(fused_items)
            telems.extend(self._decode_fused(
                steady["fused"], fused_items, centers, n_chan, cid_off,
                ext_cid))
        # second-sonde-in-a-channel fallback: own extracted row through
        # the single-channel detect + decode path
        for b, f_abs, forced_name in collide:
            self.center_freq = centers[b]
            self._cur_wide = wide[b]
            telems.extend(self._process_collision(prof, wide[b], f_abs,
                                                  forced_name))
        # wideband candidates (Weathex & friends): 96 kHz wide scan
        for b, f_abs in wide_host:
            self.center_freq = centers[b]
            self._cur_wide = wide[b]
            telems.extend(self._process_wide_candidate(prof, wide[b],
                                                       f_abs))
        self.center_freq = centers[-1]
        return telems

    def _decode_fused(self, fused, fused_items, centers, n_chan,
                      cid_off, ext_cid=None) -> list:
        """Host frame plane over the fused steady-step demod outputs
        (same tail as ``decode_channels`` without re-dispatching any
        device work)."""
        ext_cid = ext_cid or {}
        out = []
        cache = {}
        meta = {}                    # pool ticket -> telemetry-tail args
        for name, j, cid in fused_items:
            if name not in cache:
                soft, bits, stats = fused[name]
                stats_np = {k: np.asarray(v) for k, v in stats.items()}
                chain = CHAIN_TABLE[name]
                cache[name] = (
                    np.asarray(soft), np.asarray(bits),
                    np.atleast_2d(stats_np["ebno_db"])
                    if "ebno_db" in stats_np else None,
                    self._freq_residuals(stats_np, chain,
                                         np.asarray(bits).shape[0]),
                    bool(chain.get("afsk")))
            soft_b, bits_b, eb, resid, afsk = cache[name]
            b, ci = divmod(cid, n_chan)
            self.center_freq = centers[b]
            self._offsets = {ci: cid_off.get(cid, 0.0)}
            fz = self.freq_of_channel(ci)
            bits = bits_b[j]
            soft = None if afsk else soft_b[j]
            if afsk:
                bits = 1 - bits
            snr = None if eb is None else float(eb[j].max())
            fr = None if resid is None else resid[j]
            fd = self._f_demod_of(ci, fz, ext=ext_cid.get(cid, 0.0))
            if self.frame_plane.workers > 0:
                # same pool routing as decode_channels: the worker owns
                # this task's decoder state — decoding inline here would
                # create a SECOND decoder whose state (RS41 calibration
                # subframes, DFM serial bits) diverges from the
                # worker's on every speculation-miss block
                model_name = MODEL_NAME.get(name, name)
                ticket = self.frame_plane.decode(
                    fz, model_name,
                    self._decoder_kwargs(name, model_name), bits,
                    None if soft is None else -soft)
                meta[ticket] = (name, fz, snr, fr, fd)
                continue
            try:
                out.extend(self._decode_frames(
                    fz, name, bits, soft, snr, None,
                    f_resid=fr, f_demod=fd))
            except Exception:
                log.exception("decode failed on %.3f MHz (%s)",
                              fz / 1e6, name)
        if meta:
            results = self.frame_plane.gather()
            for ticket in sorted(meta):
                name, fz, snr, fr, fd = meta[ticket]
                state = self.active.get(fz)
                if state is None or state["type"] != name:
                    state = dict(type=name, decoder=None,
                                 last_ok=time.time())
                    self.active[fz] = state
                try:
                    out.extend(self._post_frames(
                        fz, state, results.get(ticket, []), snr, None,
                        fr, fd))
                except Exception:
                    log.exception("telemetry tail failed on %.3f MHz "
                                  "(%s)", fz / 1e6, name)
        return out

    def _process_collision(self, prof, planes, f_abs: float,
                           forced_name: str | None = None) -> list:
        """Detect + decode one candidate whose channel row is already
        owned by another task (two sondes >= decoder_spacing_limit apart
        inside one 48 kHz channel): extract its recentered row from the
        wideband block and run the single-channel path on it.
        ``forced_name`` (a second manual task) skips detection."""
        f_rel = f_abs - self.center_freq
        row = extract_channels(planes, self.fs_wide, [f_rel],
                               prof.n_chan, prof.pfb_taps)[0]
        det = None
        name = forced_name
        if name is None:
            dets = prof.detector.detect(row[None], prescreen=False)[0]
            if not dets:
                return []
            det = dets[0]
            self.stats["detections"] += 1
            name = det.name
            if prof.wide and name == "RS92":
                name = "RS92NGP"
        if name not in CHAIN_TABLE and name not in MODEL_NAME:
            return []
        n_chan = prof.n_chan
        self._offsets = {n_chan: float(f_abs)}   # virtual row
        self._ext_off[n_chan] = float(f_abs)     # demod anchor = here
        return self.decode_channels(row[None], [(0, det)], name,
                                    chan_map={0: n_chan})

    def _recenter_cids(self, chf, wide, prof, rec: dict):
        """Scatter recentered extractions over the sharded channel rows
        (``rec``: global cid -> extraction f_rel); slot count pads to a
        power of two for compile stability."""
        if not rec:
            return chf
        items = sorted(rec.items())
        n = len(items)
        S = 1 << max(0, int(np.ceil(np.log2(n))))
        f_list = [f for _, f in items] + [0.0] * (S - n)
        n_chan = prof.n_chan
        blk = np.array([cid // n_chan for cid, _ in items] +
                       [0] * (S - n), np.int32)
        rows = np.array([cid for cid, _ in items] +
                        [int(chf.shape[0])] * (S - n), np.int32)
        xs = wide[jnp.asarray(blk)]                      # [S, 2, T]
        ext = extract_channels(xs, self.fs_wide, f_list,
                               n_chan, prof.pfb_taps)
        return chf.at[jnp.asarray(rows)].set(ext, mode="drop")

    def _decode_routed(self, step, res, tasks, centers, n_chan,
                       t_total, cid_off=None, ext_cid=None) -> list:
        """Host frame plane over ``route_demod`` outputs: slice each
        routed slot's valid bits/soft, apply the per-chain host tail
        (AFSK bit inversion), decode task-keyed by frequency."""
        from radiosonde_auto_rx_jax.parallel.station_step import \
            EXPERT_TYPES
        cid_off = cid_off or {}
        ext_cid = ext_cid or {}
        ids = np.asarray(res["ids"])
        mask = np.asarray(res["mask"])
        ebno = np.asarray(res["ebno"])
        fres = np.asarray(res.get("fres")) if "fres" in res else None
        fcnt = np.asarray(res.get("fcnt")) if "fcnt" in res else None
        dropped = int(np.asarray(res["dropped"]).sum())
        if dropped:
            # capacity overflow: same loss mode as the reference when
            # detections exceed available SDRs (auto_rx handle_scan_results)
            log.warning("expert routing dropped %d channel(s) — raise "
                        "expert_capacity", dropped)
        out = []
        for e, name in enumerate(EXPERT_TYPES):
            afsk = bool(CHAIN_TABLE[name].get("afsk"))
            for s in np.flatnonzero(mask[e]):
                cid = int(ids[e, s])
                b, ci = divmod(cid, n_chan)
                self.center_freq = centers[b]
                self._offsets = {ci: cid_off.get(cid, 0.0)}
                fz = self.freq_of_channel(ci)
                det = tasks.get(cid, (None, None))[1]
                bits, soft = step.slot_bits(res, e, int(s), t_total)
                if afsk:
                    bits, soft = 1 - bits, None
                f_resid = None
                if fres is not None and not afsk and \
                        (fcnt is None or fcnt[e, s] >= 1.0):
                    f_resid = float(np.clip(fres[e, s], -2500.0, 2500.0))
                try:
                    out.extend(self._decode_frames(
                        fz, name, bits, soft, float(ebno[e, s]), det,
                        f_resid=f_resid,
                        f_demod=self._f_demod_of(
                            ci, fz, ext=ext_cid.get(cid, 0.0))))
                except Exception:
                    log.exception("decode failed on %.3f MHz (%s)",
                                  fz / 1e6, name)
        return out

    @staticmethod
    def group_tasks_by_type(tasks, n_chan: int) -> dict:
        """Group (channel, type, det) tasks into per-type channel lists
        via the EP compaction primitive (parallel/routing.py)."""
        if not tasks:
            return {}
        from radiosonde_auto_rx_jax.parallel.routing import compact_by_type
        names = sorted({name for _, name, _ in tasks})
        type_ids = np.full(n_chan, -1, np.int32)
        dets = {}
        for ci, name, det in tasks:
            type_ids[ci] = names.index(name)
            dets[ci] = det
        slots, counts, _ = compact_by_type(jnp.asarray(type_ids),
                                           len(names), n_chan)
        slots = np.asarray(slots)
        counts = np.asarray(counts)
        return {name: [(int(ci), dets[int(ci)])
                       for ci in slots[k, :int(counts[k])]]
                for k, name in enumerate(names) if counts[k]}

    # ------------------------------------------------------------------ #
    # web-control hooks (reference web.py control endpoints :445-661)

    def start_manual_decoder(self, freq_hz: float, sonde_type: str):
        # validate before storing: an unknown type must not reach the
        # decode path (reference isolates decoder failures per-subprocess)
        if sonde_type not in CHAIN_TABLE and sonde_type not in MODEL_NAME:
            raise ValueError(f"unknown sonde type {sonde_type!r}")
        fz = int(round(freq_hz))
        self.manual_tasks[fz] = sonde_type
        return fz

    def stop_decoder(self, freq_hz: float, lockout_minutes: float = 0):
        """Stop any decoder on this frequency; optional temporary block
        (reference stop_decoder with lockout param)."""
        q = self.config["quantization"]
        for fz in list(self.manual_tasks):
            if abs(fz - freq_hz) <= q:
                del self.manual_tasks[fz]
        for fz in list(self.active):
            if abs(fz - freq_hz) <= q:
                del self.active[fz]
                self.frame_plane.drop(fz)
        fz = int(round(freq_hz))
        if lockout_minutes > 0:
            self.temporary_blocks[fz] = time.time() + lockout_minutes * 60
        return fz

    def decode_channel(self, iq_ch, ci: int, name: str, det=None) -> list:
        """Demod + decode one channel known to carry type ``name``."""
        self._offsets = {}           # manual API: channel-center task
        self._ext_off = {}
        self._cur_wide = None        # no wideband block to extract from
        return self.decode_channels(
            jnp.asarray(iq_ch)[None], [(0, det)], name,
            chan_map={0: ci})

    def decode_channels(self, ch, items, name: str,
                        chan_map=None, wide_ready: bool = False) -> list:
        """Batched demod + per-channel decode for one sonde type.

        ch: [N, 2, T] channel planes; items: [(channel_index, det)].
        One device dispatch demodulates every channel of this type.
        ``wide_ready``: ``ch`` is already extracted at the chain's
        wide_fs (skip the on-demand extraction)."""
        chain = CHAIN_TABLE.get(name, dict(rs=4800, est=10000))
        fs = self.fs_ch
        wide_mode = chain.get("wide_fs", 0) > fs
        if wide_mode and wide_ready:
            # caller already extracted the channel at the chain's rate
            # (the wide-scan pass reuses its detection row)
            iq = ch
            fs = int(chain["wide_fs"])
        elif wide_mode:
            # wideband chain on a narrow station: synthesize the wide
            # channel on demand around each task frequency from the
            # retained wideband block (the reference instead re-runs
            # the whole SDR task at the chain's own sample rate,
            # decode.py:846-1476 per-type rates)
            wfs = int(chain["wide_fs"])
            if self._cur_wide is None or self.fs_wide % wfs != 0:
                log.warning(
                    "%s needs a %d Hz channel (station capture %d Hz "
                    "%s) — use a capture rate divisible by %d",
                    name, wfs, self.fs_wide,
                    "not retained" if self._cur_wide is None
                    else "not divisible", wfs)
                return []
            n_dec = self.fs_wide // wfs
            h = self._ex_taps.get(n_dec)
            if h is None:
                h = self._ex_taps.setdefault(n_dec, pfb_prototype(n_dec))
            f_rel = [self.freq_of_channel(chan_map[ci] if chan_map
                                          else ci) - self.center_freq
                     for ci, _ in items]
            iq = extract_channels(self._cur_wide, self.fs_wide, f_rel,
                                  n_dec, h)
            fs = wfs
        else:
            idx = [ci for ci, _ in items]
            iq = ch[np.array(idx)] if chan_map is None else ch
        if "resample_to" in chain:
            from radiosonde_auto_rx_jax.ops.resample import resample_planes
            iq = resample_planes(iq, fs, chain["resample_to"])
            fs = chain["resample_to"]
        if chain.get("afsk"):
            # IF lowpass -> FM discriminate -> audio lowpass (imet4iq's
            # front-end), then FSK-demod the Bell-202 audio tones
            from radiosonde_auto_rx_jax.models.imet4 import \
                afsk_demod_config, afsk_fm_audio
            audio = afsk_fm_audio(iq, fs)                 # [K, T]
            planes = jnp.stack([audio, jnp.zeros_like(audio)], axis=1)
            cfg = afsk_demod_config(fs)
            _, bits_b, stats, _ = fsk_demod_stream(cfg, planes)
            bits_b = 1 - np.asarray(bits_b)   # sym 0 = 1200 Hz = bit 1
            soft_b = None
        else:
            cfg = _demod_cfg(fs, chain["rs"], chain.get("est", 10000),
                             chain.get("mask", 0))
            soft_b, bits_b, stats, _ = fsk_demod_stream(cfg, iq,
                                                        buffered=True)
            bits_b = np.asarray(bits_b)
            soft_b = np.asarray(soft_b)
        out = []
        ebno = np.atleast_2d(np.asarray(stats["ebno_db"])) \
            if "ebno_db" in stats else None
        resid = self._freq_residuals(stats, chain, len(items))
        if self.frame_plane.workers > 0:
            return self._decode_frames_pooled(items, name, bits_b, soft_b,
                                              ebno, chan_map, resid,
                                              wide_mode)
        for j, (ci, det) in enumerate(items):
            real_ci = chan_map[ci] if chan_map else ci
            fz = self.freq_of_channel(real_ci)
            try:
                out.extend(self._decode_frames(
                    fz, name, bits_b[j],
                    None if soft_b is None else soft_b[j],
                    None if ebno is None else float(ebno[j].max()), det,
                    f_resid=resid[j] if resid is not None else None,
                    f_demod=self._f_demod_of(real_ci, fz, wide_mode)))
            except Exception:
                # one bad channel/decoder must not kill the capture loop
                # (reference isolates each decoder in its own subprocess)
                log.exception("decode failed on %.3f MHz (%s)",
                              fz / 1e6, name)
        return out

    def _f_demod_of(self, real_ci: int, fz: int,
                    wide_mode: bool = False, ext=None) -> float:
        """Absolute frequency this row was DEMODULATED at: the task
        frequency for wide-extracted and virtual rows (extracted right
        on it), else the channel center plus the row's actual
        extraction offset (0 for plain PFB rows).  ``ext`` overrides
        the offset lookup for callers that track extraction offsets in
        cid-space (the sharded collect paths) — this is the drift-retune
        anchor, so every decode path must go through here."""
        if wide_mode:
            return float(fz)
        if real_ci >= self.profile().n_chan:
            # appended/virtual rows record their absolute extraction
            # frequency at _alloc time; fz may since have been bumped
            # by a detector freq_offset refinement the extraction never
            # saw, so anchoring on fz would overshoot the retune
            base = self._ext_off.get(real_ci)
            return float(fz) if base is None else float(base)
        if ext is None:
            ext = self._ext_off.get(real_ci, 0.0)
        return self._chan_center(real_ci) + float(ext)

    @staticmethod
    def _freq_residuals(stats, chain, n_items):
        """Per-channel carrier-offset residual (Hz) from the demod's
        tone-frequency estimates: the tone mean of a (symmetric) FSK
        pair is the carrier offset from the demod center.  This is the
        drift signal the reference's decoders track via the Df rotate
        (demod_mod.c:758-761); the station applies it to the task
        frequency after a successful decode (``_post_frames``).  AFSK
        chains carry no carrier info in their audio tones."""
        if chain.get("afsk") or "f_est" not in stats:
            return None
        fe = np.asarray(stats["f_est"], np.float32)  # [C, nb, M]
        eb = np.atleast_2d(np.asarray(stats["ebno_db"], np.float32))
        if fe.ndim == 2:
            fe = fe[None]
        cen = fe.mean(axis=2, dtype=np.float32)      # [C, nb]
        # NaN = "no locked blocks" — a 0.0 there would read as a real
        # residual and retune a sub-threshold off-grid task back to the
        # channel center whenever ECC pulls frames through at low SNR
        resid = np.full(n_items, np.nan)
        for j in range(min(n_items, cen.shape[0])):
            # same locked-block rule as the routed path (station_step
            # route_demod fres): within 10 dB of the best block, > 3 dB
            good = eb[j] > max(3.0, float(eb[j].max()) - 10.0)
            if good.any():
                resid[j] = float(np.clip(
                    np.float32(cen[j] * good).sum() /
                    max(float(good.sum()), 1.0), -2500.0, 2500.0))
        return resid

    def _decode_frames_pooled(self, items, name, bits_b, soft_b, ebno,
                              chan_map, resid=None,
                              wide_mode=False) -> list:
        """Fan this type's channels out to the frame-plane workers, then
        run the light main-process tail (enrich/filter/export) in ticket
        order so output ordering matches the inline path."""
        model_name = MODEL_NAME.get(name, name)
        meta = {}
        for j, (ci, det) in enumerate(items):
            real_ci = chan_map[ci] if chan_map else ci
            fz = self.freq_of_channel(real_ci)
            soft = None if soft_b is None else -soft_b[j]
            ticket = self.frame_plane.decode(
                fz, model_name, self._decoder_kwargs(name, model_name),
                bits_b[j], soft)
            meta[ticket] = (fz, det,
                            None if ebno is None else float(ebno[j].max()),
                            resid[j] if resid is not None else None,
                            self._f_demod_of(real_ci, fz, wide_mode))
        results = self.frame_plane.gather()
        out = []
        for ticket in sorted(meta):
            fz, det, snr_db, f_resid, f_demod = meta[ticket]
            state = self.active.get(fz)
            if state is None or state["type"] != name:
                # fresh tasks start their rx_timeout clock NOW: types
                # needing several blocks to confirm a serial (DFM) must
                # not be reaped (and their decoder state destroyed)
                # before the first accepted frame
                state = dict(type=name, decoder=None,
                             last_ok=time.time())
                self.active[fz] = state
            try:
                out.extend(self._post_frames(fz, state,
                                             results.get(ticket, []),
                                             snr_db, det, f_resid,
                                             f_demod))
            except Exception:
                # one bad telemetry dict must not kill the capture loop
                # (same isolation as the inline path)
                log.exception("telemetry tail failed on %.3f MHz (%s)",
                              fz / 1e6, name)
        return out

    def _decoder_kwargs(self, name, model_name) -> dict:
        """Constructor args for a type's frame decoder."""
        kwargs = {}
        if name == "RS92NGP":
            # 1680 MHz RS92-NGP: scrambled cal/PTU + frequency table
            # offset (reference rs92mod.c --ngp :1803)
            kwargs["ngp"] = True
        if model_name == "RS92":
            # RS92 needs GPS ephemeris for its raw-pseudorange nav
            # (reference decode.py:423-446)
            eph = self.config.get("rs92_ephemeris")
            if eph is None:
                from radiosonde_auto_rx_jax.station.gps_ephem import \
                    get_ephemeris
                eph = get_ephemeris()
                self.config["rs92_ephemeris"] = eph
            if eph:
                kwargs["ephemeris"] = eph
        return kwargs

    def _decode_frames(self, fz, name, bits, soft, snr_db, det,
                       f_resid=None, f_demod=None) -> list:
        """Host frame plane for one channel (task-keyed by absolute
        frequency ``fz``): decoder state, frame decode,
        enrich/filter/export."""
        model_name = MODEL_NAME.get(name, name)
        state = self.active.get(fz)
        # decoder is None after checkpoint resume: rebuild (decoders are
        # stateless by design and re-lock on the next block)
        if state is None or state["type"] != name or \
                state.get("decoder") is None:
            decoder_cls = get_model(model_name)
            # fresh tasks start the rx_timeout clock NOW (multi-block
            # serial confirmation must survive until the first accepted
            # frame); a checkpoint-resumed task keeps its original clock
            prev_ok = state["last_ok"] if state is not None and \
                state.get("type") == name else time.time()
            state = dict(
                type=name,
                decoder=decoder_cls(**self._decoder_kwargs(name,
                                                           model_name)),
                last_ok=prev_ok)
            self.active[fz] = state
        decoder = state["decoder"]

        raw_telems = decoder.decode_bits(
            bits, None if soft is None else -soft)
        return self._post_frames(fz, state, raw_telems, snr_db, det,
                                 f_resid, f_demod)

    def _post_frames(self, fz, state, raw_telems, snr_db, det,
                     f_resid=None, f_demod=None) -> list:
        """Main-process telemetry tail: enrich, filter, export, task
        bookkeeping.  Shared by the inline and pooled frame planes."""
        freq_hz = float(fz)
        out = []
        for t in raw_telems:
            t = enrich_telemetry(
                t, freq_hz=freq_hz, snr=snr_db,
                f_error=det.freq_offset if det else None,
                station_code=self.config["station_code"])
            if t.get("encrypted") and self.config["close_on_encrypted"]:
                self._drop_channel(fz, encrypted=True)
                break
            verdict = telemetry_filter(t, self.config)
            if verdict == "TempBlock":
                self._drop_channel(fz)
                break
            if verdict is not True and verdict != "OK":
                self.stats["frames_filtered"] += 1
                continue
            if self.config["enable_realtime_filter"] and \
                    not self.rt_filter.check(t):
                self.stats["frames_filtered"] += 1
                continue
            state["last_ok"] = time.time()
            self.stats["frames_ok"] += 1
            out.append(t)
            for exporter in self.exporters:
                try:
                    exporter.add(t)
                except Exception:
                    log.exception("exporter error")
        if out and f_resid is not None and np.isfinite(f_resid):
            # follow the sonde's drift: the demod measured its carrier
            # ``f_resid`` Hz above the DEMOD CENTER (``f_demod`` — the
            # frequency the row was actually extracted at, which is the
            # channel center when the task offset was below
            # RECENTER_MIN_HZ).  Anchoring the retune to f_demod, not
            # fz, avoids double-counting sub-threshold offsets (a task
            # 800 Hz off center would otherwise walk +800 Hz per block
            # forever).  100 Hz rounding keeps the two (host/routed)
            # residual computations convergent despite float
            # summation-order differences.
            anchor = fz if f_demod is None else f_demod
            target = round(anchor + f_resid, -2)
            if abs(target - fz) >= DRIFT_MIN_HZ:
                if self._defer_retunes is not None:
                    # a multi-block collect decodes the SAME task once
                    # per block under its policy-time key: rekeying now
                    # would make the later blocks' _decode_frames miss
                    # self.active[fz] and resurrect a duplicate task —
                    # apply the retune after the whole batch instead.
                    # A scan-peak (absorb) target wins over this resid
                    # target: the resid is measured against the
                    # policy-time extraction, which predates the move
                    # the scan peak just reported
                    if fz not in self._defer_scan:
                        self._defer_retunes[fz] = target
                else:
                    self._retune(fz, target)
        return out

    def _drop_channel(self, fz, encrypted=False):
        self.active.pop(fz, None)
        self.frame_plane.drop(fz)
        self.temporary_blocks[fz] = time.time() + \
            self.config["temporary_block_time"] * 60
        if encrypted:
            log.warning("Encrypted sonde on %.3f MHz — blocked", fz / 1e6)

    def clean_task_list(self):
        """Reap idle decoders (reference auto_rx.py clean_task_list
        :422-537)."""
        now = time.time()
        for fz in list(self.active):
            if now - self.active[fz]["last_ok"] > self.config["rx_timeout"]:
                self.active.pop(fz)
                self.frame_plane.drop(fz)

    def close(self):
        self.frame_plane.close()
        for e in self.exporters:
            try:
                e.close()
            except Exception:
                pass
