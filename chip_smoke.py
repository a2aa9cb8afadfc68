"""On-card smoke test: the station's main path on one NVIDIA GPU.

    python chip_smoke.py                 # one card (the default)
    python chip_smoke.py --four          # the 4-card mesh path only
    python chip_smoke.py --rehearse      # phases 2-4, tiny, on the CPU
    python chip_smoke.py --four --rehearse

Phases (each prints its lines; any failure raises and exits non-zero):

1. device   — JAX must find a GPU; card name and power limit from
               ``nvidia-smi`` (run in a child process that stays off JAX).
2. parity   — each device stage at real width (one 2.4 MHz capture,
               50 channels, 1 s) against a reference that does not depend
               on the card: PFB channelizer and Welch PSD against NumPy
               float64, detector peaks and FSK demod against the same jitted
               code on the CPU backend.  Stage times on the card.
3. served   — ``station.main --replay`` of a synthesized cs16 capture
               (RS41, M20, DFM and an off-grid M10) with the default
               configuration; every sonde must report the serial and frame
               numbers the synthesizer encoded.
4. aggregate — ``Station.process_captures`` over 10 x 2.4 MHz captures for
               5 cycles (a scan block, then fused steady blocks).
5. PER      — one PER point per type (RS41, M20, DFM, M10) through the PER
               gate's own measurement, held to the gate's own limit.

``--four`` runs only the 4-card check: a (ch=4, t=1) mesh station and a
1-card station on the same 8-capture batches must emit equal telemetry.
The last line of a passing card run is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
A rehearsal never prints it.
"""

import argparse
import json
import os
import subprocess
import sys
import time

SONDE_TYPES = ("RS41", "M20", "DFM", "M10")


def log(msg=""):
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def require(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


class Geometry:
    """Sizes of one run: the real ones on the card, tiny in rehearsal."""

    def __init__(self, rehearse: bool):
        self.rehearse = rehearse
        self.n_chan = 16 if rehearse else 50
        self.fs = self.n_chan * 48000           # 768 kHz | 2.4 MHz
        self.parity_s = 0.5 if rehearse else 1.0
        self.served_s = 6.0 if rehearse else 12.0
        self.agg_captures = 4 if rehearse else 10
        self.agg_cycles = 3 if rehearse else 5
        self.psd_captures = 2 if rehearse else 10
        self.block_s = 2.0
        self.center = 402.5e6
        # carrier offsets from the capture center, all on the 10 kHz
        # raster; M10 sits 20 kHz off its channel's center (off-grid)
        if rehearse:
            self.placements = [("RS41", -240e3), ("M20", 240e3),
                               ("DFM", -100e3), ("M10", 130e3)]
        else:
            self.placements = [("RS41", -480e3), ("M20", 240e3),
                               ("DFM", 720e3), ("M10", 980e3)]


def station_config(g):
    """The default station configuration minus the network uploader
    (this run must not reach any outside host); the rehearsal shrinks
    the capture."""
    cfg = {"sondehub_enabled": False}
    if g.rehearse:
        cfg.update(capture_rate=g.fs, num_channels=g.n_chan)
    return cfg


# --------------------------------------------------------------------- #
# timing helpers (host clock around work that ends in block_until_ready)

def time_ms(fn, *args, reps=10):
    """(median, min) ms of ``fn(*args)`` after one warm-up call."""
    import jax
    import numpy as np
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts)), float(np.min(ts))


class CacheCounter:
    """Counts persistent compilation cache lookups and hits."""

    def __init__(self):
        import jax
        self.requests = self.hits = 0

        def on_event(event, **kw):
            if event == "/jax/compilation_cache/compile_requests_use_cache":
                self.requests += 1
            elif event == "/jax/compilation_cache/cache_hits":
                self.hits += 1
        jax.monitoring.register_event_listener(on_event)


class BlockClock:
    """Block latency of the station's dispatch/collect pairs: from the
    dispatch of a batch to the end of its collect, device work included
    (``block_until_ready`` on the batch's device arrays)."""

    def __init__(self):
        self.lat = []                # (path kind, seconds)

    def __enter__(self):
        import jax
        from radiosonde_auto_rx_jax.station.station import Station
        self._orig = (Station.captures_dispatch, Station.captures_collect)
        starts = {}
        orig_dispatch, orig_collect = self._orig

        def dispatch(st, blocks, centers=None):
            t0 = time.perf_counter()
            pending = orig_dispatch(st, blocks, centers)
            starts[id(pending)] = t0
            return pending

        def collect(st, pending):
            out = orig_collect(st, pending)
            jax.block_until_ready(pending)
            self.lat.append((pending[0], time.perf_counter() -
                             starts.pop(id(pending))))
            return out

        Station.captures_dispatch = dispatch
        Station.captures_collect = collect
        return self

    def __exit__(self, *exc):
        from radiosonde_auto_rx_jax.station.station import Station
        Station.captures_dispatch, Station.captures_collect = self._orig

    def report(self, label):
        import numpy as np
        require(self.lat, f"{label}: no station block was timed")
        kinds = [k for k, _ in self.lat]
        secs = np.array([s for _, s in self.lat])
        steady = secs[1:] if len(secs) > 1 else secs
        log(f"  {label}: {len(secs)} batches, paths {kinds}")
        log(f"  {label}: latency per batch (s, dispatch to collected; a "
            f"batch that meets a new program shape includes its "
            f"compilation): {[round(float(v), 4) for v in secs]}")
        log(f"  {label}: later batches median {np.median(steady):.4f} s, "
            f"min {steady.min():.4f} s, max {steady.max():.4f} s")
        return secs


def peak_memory_line(dev):
    stats = dev.memory_stats()
    if not stats:
        return f"peak device memory: not reported by {dev.platform}"
    return (f"peak device memory: {stats.get('peak_bytes_in_use', 0)} "
            f"bytes in use (of {stats.get('bytes_limit', 0)} reserved)")


# --------------------------------------------------------------------- #
# phase 1

def phase_device(args):
    import jax
    log("== phase 1: device")
    devs = jax.devices()
    d = devs[0]
    log(f"  jax {jax.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"  platform {d.platform}, kind {d.device_kind!r}, "
        f"count {len(devs)}")
    if args.rehearse:
        log("  rehearsal: CPU backend, nvidia-smi not run")
        return d
    require(d.platform == "gpu",
            f"JAX found no GPU (platform {d.platform!r}); this check "
            f"runs only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(f"  nvidia-smi: {line.strip()}")
    if args.four:
        require(len(devs) >= 4, f"--four needs 4 cards, found {len(devs)}")
    return d


# --------------------------------------------------------------------- #
# phase 2: stage parity

def pfb_reference(x, h, n_chan):
    """NumPy float64 polyphase channelizer: channel k of
    y[m, r] = sum_p h[pN + N-1-r] x[(m-p)N + r], z = DFT_r(y)."""
    import numpy as np
    z = x[0].astype(np.float64) + 1j * x[1].astype(np.float64)
    P = len(h) // n_chan
    M = len(z) // n_chan
    xb = z[:M * n_chan].reshape(M, n_chan)
    hb = h.astype(np.float64).reshape(P, n_chan)[:, ::-1]
    y = np.zeros((M, n_chan), np.complex128)
    for p in range(P):
        y[p:] += xb[:M - p] * hb[p]
    return np.fft.fft(y, axis=1).T                        # [N, M]


def welch_reference(x, nfft, hop):
    """NumPy float64 sparse Welch (one hann window per ``hop``),
    fftshifted, normalized as ``detect.psd._welch``."""
    import numpy as np
    n = np.arange(nfft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / (nfft - 1))
    win = win / np.sqrt(np.sum(win ** 2) / nfft)
    z = x[:, 0].astype(np.float64) + 1j * x[:, 1].astype(np.float64)
    nseg = z.shape[-1] // hop
    segs = z[:, :nseg * hop].reshape(z.shape[0], nseg, hop)[..., :nfft]
    X = np.fft.fftshift(np.fft.fft(segs * win, axis=-1), axes=-1)
    return (np.abs(X) ** 2).sum(axis=1) / (nseg * nfft)


def psd_errors(p, ref):
    """(max |p - ref| relative to the peak bin, max |dB difference|)."""
    import numpy as np
    return (float(np.abs(p - ref).max() / ref.max()),
            float(np.abs(10 * np.log10(p / ref)).max()))


def welch_fft(x, nfft, hop):
    """The same sparse Welch through ``jnp.fft`` (cuFFT on the card) —
    the alternative formulation timed beside the dense DFT matmul."""
    import jax.numpy as jnp
    import numpy as np
    n = np.arange(nfft)
    win = 0.5 - 0.5 * np.cos(2 * np.pi * n / (nfft - 1))
    win = (win / np.sqrt(np.sum(win ** 2) / nfft)).astype(np.float32)
    C, _, T = x.shape
    nseg = T // hop
    segs = x[:, :, :nseg * hop].reshape(C, 2, nseg, hop)[..., :nfft]
    z = (segs[:, 0] + 1j * segs[:, 1]) * win
    X = jnp.fft.fftshift(jnp.fft.fft(z, axis=-1), axes=-1)
    return (jnp.abs(X) ** 2).sum(axis=1) / (nseg * nfft)


def channel_signals(n, fs, seconds, rng):
    """[n, 2, T] planes: one RS41-rate GFSK burst per channel, tone
    centers spread over +-3 kHz, ~15 dB Eb/N0."""
    import numpy as np
    from radiosonde_auto_rx_jax.demod.modulate import add_awgn, gfsk_mod
    T = int(fs * seconds)
    out = np.zeros((n, 2, T), np.float32)
    for c in range(n):
        bits = rng.integers(0, 2, int(4800 * seconds) + 8)
        sig = gfsk_mod(bits, fs, 4800, 2, -3000 + 6000 * c / max(1, n - 1),
                       4800, bt=0.5)[:T]
        sig = add_awgn(sig, 15.0, fs, 4800, rng=rng)
        out[c, 0], out[c, 1] = sig.real, sig.imag
    return out


def phase_parity(g, dev):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from functools import partial
    from radiosonde_auto_rx_jax.demod.fsk import (
        _freq_est, _fsk_demod_scan_buffered, fsk_init_state,
        fsk_num_blocks_buffered)
    from radiosonde_auto_rx_jax.detect.correlator import _correlate_peaks
    from radiosonde_auto_rx_jax.detect.psd import _welch
    from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
    from radiosonde_auto_rx_jax.ops.channelizer import (_channelize,
                                                        pfb_prototype)
    from radiosonde_auto_rx_jax.station.station import _demod_cfg
    from radiosonde_auto_rx_jax.tools.synth import wideband_capture

    log(f"== phase 2: stage parity ({g.fs / 1e6:.3f} MHz capture, "
        f"{g.n_chan} channels, {g.parity_s:g} s)")
    cpu = jax.devices("cpu")[0]
    iq, _ = wideband_capture(g.placements, g.fs, g.parity_s, g.center,
                             time.time(), seed=1)
    x_np = np.stack([iq.real, iq.imag]).astype(np.float32)
    x = jax.device_put(x_np, dev)

    # -- PFB channelizer: f32 planes, DFT at Precision.HIGHEST
    h = pfb_prototype(g.n_chan)
    hj = jax.device_put(h, dev)
    ch = _channelize(x, hj, g.n_chan)
    got = np.asarray(ch[:, 0]) + 1j * np.asarray(ch[:, 1])
    ref = pfb_reference(x_np, h, g.n_chan)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    tol = 1e-5
    log(f"  channelizer: max |err|/max|ref| = {err:.3e} (tol {tol:g}: f32 "
        f"rounding over a {len(h) // g.n_chan}-tap MAC and a "
        f"{g.n_chan}-point DFT is ~1e-7 of full scale; TF32 would show "
        f"~1e-3) [precision HIGHEST, f32 planes]")
    require(err <= tol, "channelizer disagrees with the float64 reference")
    ms = time_ms(partial(_channelize, n_chan=g.n_chan), x, hj)
    log(f"  channelizer time: median {ms[0]:.3f} ms, min {ms[1]:.3f} ms "
        f"per {g.parity_s:g} s capture")

    # -- Welch PSD (dense windowed-DFT matmul), nfft 2048, sparse hop
    nfft, hop = 2048, 8192
    p = np.asarray(_welch(x[None], nfft, hop))
    pref = welch_reference(x_np[None], nfft, hop)
    rel, db = psd_errors(p, pref)
    log(f"  welch psd: max |err| = {rel:.3e} of the peak bin (tol 1e-5: "
        f"f32 2048-term sums err ~1e-7 of the peak; TF32 would show "
        f"~1e-4), {db:.2e} dB at worst over {nfft} bins spanning "
        f"{10 * np.log10(pref.max() / np.median(pref)):.0f} dB (tol 0.01 "
        f"dB; the scan thresholds at 10 dB over the floor) [precision "
        f"HIGHEST, f32]")
    require(rel <= 1e-5 and db <= 0.01,
            "Welch PSD disagrees with the float64 reference")
    # production scan geometry: psd_captures x 1 s, one window per 8192
    rng = np.random.default_rng(2)
    xw = jax.device_put(rng.standard_normal(
        (g.psd_captures, 2, g.fs)).astype(np.float32), dev)
    dense = jax.jit(partial(_welch, nfft=nfft, hop=hop))
    fftw = jax.jit(partial(welch_fft, nfft=nfft, hop=hop))
    rel, db = psd_errors(np.asarray(fftw(xw)), np.asarray(dense(xw)))
    t_dense = time_ms(dense, xw)
    t_fft = time_ms(fftw, xw)
    log(f"  welch psd time ({g.psd_captures} x {g.fs / 1e6:.1f} Ms, nfft "
        f"{nfft}, hop {hop}): dense DFT matmul median {t_dense[0]:.3f} ms"
        f" (min {t_dense[1]:.3f}); jnp.fft median {t_fft[0]:.3f} ms "
        f"(min {t_fft[1]:.3f}); formulations agree to {rel:.1e} of the "
        f"peak, {db:.1e} dB")
    require(rel <= 1e-5 and db <= 0.01,
            "dense and FFT Welch formulations disagree")

    # -- detector: conditioned FM streams, correlation peaks vs CPU
    det = SondeDetector(48000, prescreen=False)
    chf = ch - jnp.mean(ch, axis=-1, keepdims=True) * 0.98
    streams = det._condition(chf)
    worst, moved = 0.0, 0
    for fm, (_, _, specs, bank, lens) in zip(streams, det.classes):
        lens_t = tuple(int(v) for v in lens)
        bk = bank.astype(fm.dtype)
        g_out = [np.asarray(v) for v in _correlate_peaks(fm, bk, lens_t)]
        c_out = [np.asarray(v) for v in _correlate_peaks(
            jax.device_put(fm, cpu), jax.device_put(bk, cpu), lens_t)]
        worst = max(worst, float(np.abs(g_out[0] - c_out[0]).max()))
        strong = np.abs(c_out[0]) >= 0.5
        moved += int((g_out[1][strong] != c_out[1][strong]).sum())
    tol_s = 1e-3
    log(f"  detector peaks: max |score err| = {worst:.3e} (tol {tol_s:g}: "
        f"f32 FFT correlation and running sums in another reduction "
        f"order; decisions threshold at 0.55-0.8); peak positions moved "
        f"on {moved} strong (|score| >= 0.5) channel/type pairs (tol 0) "
        f"[FFT correlation, exact peaks, f32 streams]")
    require(worst <= tol_s and moved == 0,
            "detector peaks disagree with the CPU backend")
    fm0, (_, _, _, bank0, lens0) = streams[0], det.classes[0]
    corr0 = jax.jit(partial(_correlate_peaks,
                            lens_t=tuple(int(v) for v in lens0)))
    ms = time_ms(corr0, fm0, bank0.astype(fm0.dtype))
    log(f"  detector correlate+peaks time (class 0, {fm0.shape[0]} "
        f"channels): median {ms[0]:.3f} ms")

    # -- FSK demod (RS41 chain) on n_chan synthesized channels vs CPU
    cfg = _demod_cfg(48000, 4800, 5000, 5000)
    xs = channel_signals(g.n_chan, 48000, g.parity_s,
                         np.random.default_rng(3))
    nb = fsk_num_blocks_buffered(cfg, xs.shape[-1])
    st0 = fsk_init_state(cfg, g.n_chan)
    _, og = _fsk_demod_scan_buffered(cfg, jax.device_put(xs, dev),
                                     jax.device_put(st0, dev), nb)
    _, oc = _fsk_demod_scan_buffered(cfg, jax.device_put(xs, cpu),
                                     jax.device_put(st0, cpu), nb)
    sg, sc = np.asarray(og["soft"]), np.asarray(oc["soft"])
    fg, fc = np.asarray(og["f_est"]), np.asarray(oc["f_est"])
    bit_mis = float(((sg > 0) != (sc > 0)).mean())
    f_mis = float((np.abs(fg - fc) > 1e-3).any(axis=-1).mean())
    rel = np.abs(sg - sc) / np.sqrt(np.mean(sc ** 2))
    p99 = float(np.quantile(rel, 0.99))
    log(f"  fsk demod: soft err p99 {p99:.3e} / max {rel.max():.3e} of rms "
        f"(tol p99 1e-3), hard-bit mismatch {bit_mis:.2e} (tol 1e-3), "
        f"f_est mismatch {f_mis:.2e} of blocks (tol 1e-2) — f32 sums in "
        f"another order can flip a timing or tone decision that sits on "
        f"a boundary [precision HIGHEST, f32]")
    require(p99 <= 1e-3 and bit_mis <= 1e-3 and f_mis <= 1e-2,
            "FSK demod disagrees with the CPU backend")
    xd = jax.device_put(xs, dev)
    scan = jax.jit(partial(_fsk_demod_scan_buffered, cfg, n_blocks=nb))
    ms = time_ms(scan, xd, jax.device_put(st0, dev))
    log(f"  fsk demod scan time ({g.n_chan} ch x {g.parity_s:g} s, {nb} "
        f"blocks): median {ms[0]:.3f} ms")
    win = xd[:, :, :cfg.nmem]
    fe = jax.jit(partial(_freq_est, cfg))
    ms = time_ms(fe, win, jax.device_put(st0["sf"], dev))
    log(f"  frequency estimate time (one block, {g.n_chan} ch, ndft "
        f"{cfg.ndft}): median {ms[0]:.3f} ms")


# --------------------------------------------------------------------- #
# phase 3: served path through station.main

def read_sonde_logs(logdir):
    import glob
    import csv
    out = []
    for path in sorted(glob.glob(os.path.join(logdir, "*_sonde.log"))):
        with open(path) as f:
            for row in csv.reader(f):
                if not row or row[0] == "timestamp":
                    continue
                out.append({"id": row[1], "frame": int(row[2]),
                            "lat": float(row[3]), "lon": float(row[4])})
    return out


def phase_served(g, dev, out_dir):
    import numpy as np
    from radiosonde_auto_rx_jax.station import main as station_main
    from radiosonde_auto_rx_jax.tools.synth import (
        check_telemetry, wideband_capture, write_cs16)

    log(f"== phase 3: served path (station.main --replay, "
        f"{g.fs / 1e6:.3f} MHz cs16, {g.served_s:g} s)")
    t0 = time.perf_counter()
    iq, sondes = wideband_capture(g.placements, g.fs, g.served_s,
                                  g.center, time.time(), seed=4)
    cap = os.path.join(out_dir, "served_capture.cs16")
    write_cs16(cap, iq)
    del iq
    for s in sondes:
        log(f"  synthesized {s.kind} {s.serial} at {s.freq_hz / 1e6:.4f} "
            f"MHz, {len(s.frames)} frames")
    log(f"  synthesis + cs16 write: {time.perf_counter() - t0:.1f} s -> "
        f"{cap}")
    sections = {"sondehub_enabled": "sondehub", "capture_rate": "advanced",
                "num_channels": "advanced"}
    by_section = {}
    for key, val in station_config(g).items():
        by_section.setdefault(sections[key], []).append(f"{key} = {val}")
    cfg = os.path.join(out_dir, "station.cfg")
    with open(cfg, "w") as f:
        for sec, lines in by_section.items():
            f.write(f"[{sec}]\n" + "\n".join(lines) + "\n")
    logdir = os.path.join(out_dir, "served_log")
    if os.path.isdir(logdir):
        for name in os.listdir(logdir):
            os.unlink(os.path.join(logdir, name))
    t0 = time.perf_counter()
    with BlockClock() as clock:
        rc = station_main.main(["-c", cfg, "--replay", cap,
                                "--center", str(g.center / 1e6),
                                "--block-seconds", str(g.block_s),
                                "--no-web", "--log-dir", logdir])
    wall = time.perf_counter() - t0
    require(rc == station_main.EXIT_OK, f"station main exited {rc}")
    secs = clock.report("served blocks")
    log(f"  set-up: main() wall {wall:.1f} s for {len(secs)} blocks of "
        f"{g.block_s:g} s; first block {secs[0]:.2f} s")
    telems = read_sonde_logs(logdir)
    log("  frames per type: " + ", ".join(
        f"{s.kind} {len({t['frame'] for t in telems if t['id'] == s.serial})}"
        f"/{len(s.frames)}" for s in sondes))
    problems = check_telemetry(telems, sondes, min_frames=2)
    for p in problems:
        log(f"  MISMATCH: {p}")
    require(not problems, "served telemetry differs from what was encoded")
    log("  every synthesized sonde decoded with its encoded serial, frame "
        "numbers and position")
    log("  " + peak_memory_line(dev))


# --------------------------------------------------------------------- #
# phase 4 / --four: aggregate geometry through process_captures

def capture_batches(g, n_captures, sonde_captures, cycles, seed):
    """Per-cycle lists of int16 [2, T] planes (the block sources' cs16
    wire format) for ``n_captures`` captures 2.4 MHz apart; capture
    ``sonde_captures[i]`` carries sonde ``g.placements[i]``."""
    from radiosonde_auto_rx_jax.tools.synth import to_cs16, wideband_capture
    seconds = g.block_s * cycles
    T = int(g.fs * g.block_s)
    centers = [400.0e6 + g.fs * b for b in range(n_captures)]
    planes, sondes = [], []
    ts = time.time()
    for b in range(n_captures):
        place = [g.placements[sonde_captures.index(b)]] \
            if b in sonde_captures else []
        iq, ss = wideband_capture(place, g.fs, seconds, centers[b], ts,
                                  seed=seed + b)
        planes.append(to_cs16(iq))
        sondes.extend(ss)
    batches = [[p[:, k * T:(k + 1) * T] for p in planes]
               for k in range(cycles)]
    return batches, centers, sondes


class SteadyCalls:
    """Records the fused steady step's calls (the last one's arguments,
    so its compiled memory footprint can be read back)."""

    def __enter__(self):
        from radiosonde_auto_rx_jax.parallel.station_step import \
            ShardedStationStep
        self._orig = ShardedStationStep.steady_step
        self.last = None
        self.calls = []              # (demod types in the plan, scan)
        orig = self._orig

        def rec(step, *a, **kw):
            self.last = (step, a, kw)
            self.calls.append((len(a[6]), kw.get("scan", True)))
            return orig(step, *a, **kw)
        ShardedStationStep.steady_step = rec
        return self

    def __exit__(self, *exc):
        from radiosonde_auto_rx_jax.parallel.station_step import \
            ShardedStationStep
        ShardedStationStep.steady_step = self._orig

    def memory_analysis(self):
        step, a, kw = self.last
        return self._orig.lower(step, *a, **kw).compile().memory_analysis()


def run_cycles(station, batches, centers):
    out = []
    for blocks in batches:
        out.extend(station.process_captures(blocks, centers))
    return out


def phase_aggregate(g, dev):
    from radiosonde_auto_rx_jax.station.station import Station
    from radiosonde_auto_rx_jax.tools.synth import check_telemetry

    log(f"== phase 4: aggregate ({g.agg_captures} x {g.fs / 1e6:.3f} MHz "
        f"captures, {g.agg_cycles} cycles of {g.block_s:g} s)")
    t0 = time.perf_counter()
    batches, centers, sondes = capture_batches(
        g, g.agg_captures, [0, 1, 2, 3], g.agg_cycles, seed=10)
    log(f"  synthesis: {time.perf_counter() - t0:.1f} s")
    telems = []
    station = Station(config=station_config(g), exporters=[])
    try:
        require(station.mesh is not None and station.frame_plane.workers,
                "default config must run on the mesh with the frame plane")
        with BlockClock() as clock, SteadyCalls() as steady:
            telems = run_cycles(station, batches, centers)
        secs = clock.report("aggregate cycles")
        log(f"  fused steady calls (demod types, scan): {steady.calls}")
        # a cycle is warm when an earlier cycle ran the same program
        warm = [t for i, (t, sig) in enumerate(zip(secs, steady.calls))
                if sig in steady.calls[:i]]
        require(warm or g.rehearse, "no cycle repeated a compiled program")
        if warm:
            mean = sum(warm) / len(warm)
            log(f"  warm cycles (program already compiled): "
                f"{[round(float(t), 4) for t in warm]} s; "
                f"{g.agg_captures * g.fs * g.block_s / mean / 1e6:.1f} Msps "
                f"wideband; real time for {g.agg_captures} streams of "
                f"{g.fs / 1e6:.1f} Msps needs a cycle under {g.block_s:g} s")
        require(any(n for n, _ in steady.calls),
                "no cycle ran the fused steady demod")
        require(g.rehearse or any(n and not sc for n, sc in steady.calls),
                "no steady cycle skipped the scan")
        ma = steady.memory_analysis()
        log(f"  fused steady step memory_analysis: arguments "
            f"{ma.argument_size_in_bytes} B, outputs "
            f"{ma.output_size_in_bytes} B, temporaries "
            f"{ma.temp_size_in_bytes} B, code "
            f"{ma.generated_code_size_in_bytes} B")
    finally:
        station.close()
    problems = check_telemetry(telems, sondes, min_frames=2)
    for p in problems:
        log(f"  MISMATCH: {p}")
    require(not problems, "aggregate telemetry differs from what was "
            "encoded")
    log(f"  {len(telems)} telemetry frames; every sonde decoded with its "
        f"encoded serial, frame numbers and position")
    log("  " + peak_memory_line(dev))


def telemetry_key(t):
    return (t["type"], t.get("id"), t.get("frame"), round(t["lat"], 4),
            round(t["lon"], 4), round(t.get("freq_float", 0.0), 4))


def phase_four(g):
    import jax
    from jax.sharding import PartitionSpec as P
    from radiosonde_auto_rx_jax.parallel.mesh import (CH_AXIS, T_AXIS,
                                                      make_mesh)
    from radiosonde_auto_rx_jax.station.station import Station
    from radiosonde_auto_rx_jax.tools.synth import check_telemetry

    devs = jax.devices()
    require(len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}")
    cycles = 3
    log(f"== phase 6: four cards (8 x {g.fs / 1e6:.3f} MHz captures, "
        f"{cycles} cycles of {g.block_s:g} s)")
    batches, centers, sondes = capture_batches(g, 8, [0, 2, 5, 7], cycles,
                                               seed=20)
    results = {}
    for name, mesh in (("4-card (ch=4, t=1)",
                        make_mesh(n_ch=4, n_t=1, devices=devs[:4])),
                       ("1-card", make_mesh(n_ch=1, n_t=1,
                                            devices=devs[:1]))):
        station = Station(config=station_config(g), exporters=[],
                          mesh=mesh)
        try:
            step = station._sharded_step(station.profile(centers[0]))
            wide = station._wide_batch(
                batches[0], 8, step.sharding(P(CH_AXIS, None, T_AXIS)))
            shards = sorted((str(s.device), s.data.shape)
                            for s in wide.addressable_shards)
            log(f"  {name}: batch placement {shards}")
            require(len({d for d, _ in shards}) == mesh.size and
                    all(sh[0] == 8 // mesh.size for _, sh in shards),
                    f"{name}: the batch is not split across the mesh")
            with BlockClock() as clock:
                results[name] = run_cycles(station, batches, centers)
            clock.report(name)
        finally:
            station.close()
        problems = check_telemetry(results[name], sondes, min_frames=1)
        for p in problems:
            log(f"  MISMATCH ({name}): {p}")
        require(not problems, f"{name}: telemetry differs from what was "
                f"encoded")
    a, b = (sorted(map(telemetry_key, r)) for r in results.values())
    log(f"  telemetry frames: 4-card {len(a)}, 1-card {len(b)}; "
        f"equal: {a == b}")
    require(a == b, "4-card and 1-card telemetry differ")


# --------------------------------------------------------------------- #
# phase 5: PER spot check

def phase_per():
    from radiosonde_auto_rx_jax.tools.per_harness import (
        gate_limit, gate_point, recorded_rows, run_point)
    log("== phase 5: PER spot check (100 frames per type, PER gate rule)")
    rows = recorded_rows()
    for kind in SONDE_TYPES:
        e_gate, p_rec, cliff = gate_point(rows, kind)
        t0 = time.perf_counter()
        p = run_point(kind, e_gate, n_frames=100, seed=123)[0]["per"]
        limit = gate_limit(p_rec)
        log(f"  {kind}: PER {p:.2f} at {e_gate:.1f} dB Eb/N0 (recorded "
            f"{p_rec:.2f}, cliff {cliff}, limit {limit:.2f}) "
            f"[{time.perf_counter() - t0:.1f} s]")
        require(p <= limit, f"{kind}: PER cliff moved on the card")


# --------------------------------------------------------------------- #

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 4-card mesh check (needs 4 cards)")
    ap.add_argument("--rehearse", action="store_true",
                    help="phases 2-4 at tiny size on the CPU; no ok line")
    ap.add_argument("--out", default="chip_smoke_out",
                    help="directory for the capture and logs")
    args = ap.parse_args(argv)
    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four and "device_count" not in os.environ.get("XLA_FLAGS",
                                                               ""):
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "") +
                " --xla_force_host_platform_device_count=4").strip()

    from radiosonde_auto_rx_jax.utils.compile_cache import \
        enable_compile_cache
    cache_dir = enable_compile_cache()
    import jax
    cache = CacheCounter()
    t_start = time.perf_counter()
    dev = phase_device(args)
    os.makedirs(args.out, exist_ok=True)
    g = Geometry(args.rehearse)
    if args.four:
        phase_four(g)
    else:
        phase_parity(g, dev)
        phase_served(g, dev, args.out)
        phase_aggregate(g, dev)
        if not args.rehearse:
            phase_per()
    log(f"compile cache: {cache_dir}: {cache.requests} programs looked "
        f"up, {cache.hits} hits")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    if args.rehearse:
        log("rehearsal on the CPU backend: no result line")
        return 0
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
