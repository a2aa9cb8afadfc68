"""Headline benchmark: IQ Msamples/s per card through the FSK demodulator,
plus the station's per-block device programs at production geometry.

Primary metric per BASELINE.json: complex IQ samples/s through the full
RS41-config 2FSK demod (freq estimation + tone integration + timing + soft
bits).  Baseline: the reference decodes ~5 concurrent 48 kHz channels in
real time on a Pi4 (reference auto_rx/station.cfg.example:36-38) =
0.24 Msamples/s/device.

The station metrics run the production device programs at production
geometry (10 wideband 2.4 MHz captures, 50-channel PFB): the split
dispatch (analyze + confirm + per-type demod) and the fused steady step.
Host-side peak picking / frame decode are excluded (the frame plane is
benched by tools/bench_frame_plane.py).  Every timing ends in
``block_until_ready``.  The run needs a GPU: with none it exits non-zero.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", "extra"}.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from radiosonde_auto_rx_jax.demod.fsk import (
    FSKConfig, fsk_init_state, fsk_num_blocks_buffered,
    _fsk_demod_scan_buffered)

BASELINE_MSPS = 0.24  # reference: ~5 real-time 48 kHz channels per device
REPS = 50


def _cfg():
    return FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                     est_min=-5000, est_max=5000,
                     tone_spacing=5000, freq_est_type=1)


def make_input(cfg, channels, t_samples, key):
    """Synthetic 2FSK on-device: random symbols + AWGN, as [C, 2, T]
    planes (the demod's input layout)."""
    k1, k2 = jax.random.split(key)
    nsym = t_samples // cfg.ts + 1
    bits = jax.random.bernoulli(k1, 0.5, (channels, nsym))
    f = jnp.where(jnp.repeat(bits, cfg.ts, axis=1)[:, :t_samples],
                  cfg.tone_spacing / 2.0, -cfg.tone_spacing / 2.0)
    ph = 2 * jnp.pi * jnp.cumsum(f, axis=1) / cfg.fs
    iq = jnp.stack([jnp.cos(ph), jnp.sin(ph)], axis=1)
    noise = jax.random.normal(k2, iq.shape, jnp.float32) * 0.07
    return (iq + noise).astype(jnp.float32)


def _timed(fn, args_pair, reps=REPS):
    """Per-call seconds of ``fn`` over ``reps`` pipelined calls on two
    alternating inputs (no caching layer can collapse repeated identical
    executions), best of 3; each trial ends in ``block_until_ready``."""
    dt = 1e30
    for _ in range(3):
        t0 = time.perf_counter()
        outs = [fn(args_pair[i % 2]) for i in range(reps)]
        jax.block_until_ready(outs)
        dt = min(dt, (time.perf_counter() - t0) / reps)
    return dt


def bench_demod():
    cfg = _cfg()
    channels, t_samples = 512, 48000 * 4
    x = jax.jit(make_input, static_argnums=(0, 1, 2))(
        cfg, channels, t_samples, jax.random.key(0))
    nb = fsk_num_blocks_buffered(cfg, t_samples)
    state0 = fsk_init_state(cfg, channels)

    def run(x):
        _, outs = _fsk_demod_scan_buffered(cfg, x, state0, nb)
        # reduce on device so timing includes no D2H of the full output
        return outs["soft"].sum(), outs["bits"].astype(jnp.int32).sum()

    runj = jax.jit(run)
    jax.block_until_ready(runj(x))                # compile + warm
    x2 = jax.jit(lambda v: v + 1e-4)(x)
    return channels * t_samples / _timed(runj, (x, x2)) / 1e6


def bench_station_production(n_cand=20, actives=None):
    """The PRODUCTION station's per-block device programs, measured as
    the station dispatches them (Station._collect_sharded on a 1-device
    mesh): ``analyze`` (PFB channelize + sparse-Welch PSD) → ``confirm``
    (full-rate 4-stream detection on ``n_cand`` scan candidates — the
    worst case: every block fills all confirmation slots) →
    ``route_demod`` (expert-routed demod of the active channels;
    12 expert programs x 4 capacity slots).  Host-side scan policy and
    frame decode are excluded as before (amortized control logic).

    Returns (wide Msps, step_ms, extra dict)."""
    import numpy as np
    from radiosonde_auto_rx_jax.parallel.mesh import make_mesh
    from radiosonde_auto_rx_jax.parallel.station_step import (
        EXPERT_TYPES, ShardedStationStep)

    n_chan = 50
    B = 10
    t_wide = 2_400_000
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
    step = ShardedStationStep(mesh, n_chan=n_chan, capacity=4,
                              conf_capacity=n_cand)
    # a realistic active-sonde load: ~1 sonde per capture across the
    # common types (reference stations run ~5 concurrent tasks max,
    # station.cfg.example:36-38 — this models 2x that)
    if actives is None:
        actives = ["RS41", "RS41", "RS41", "RS41", "DFM", "DFM",
                   "M10", "M10", "M20", "MTS01"]
    rng = np.random.default_rng(3)
    by_type = {}
    for i, name in enumerate(actives):
        by_type.setdefault(name, []).append(
            int(rng.integers(0, B * n_chan)))
    slots = np.full(step.n_conf_slots, -1, np.int32)
    slots[:n_cand] = rng.choice(B * n_chan, n_cand, replace=False)

    # per-present-type demod configs/resamplers: exactly what the
    # station's decode_channels dispatches on a 1-shard mesh
    from radiosonde_auto_rx_jax.demod.fsk import (fsk_demod_stream)
    from radiosonde_auto_rx_jax.ops.resample import resample_planes
    from radiosonde_auto_rx_jax.station.station import (CHAIN_TABLE,
                                                        _demod_cfg)
    type_plan = []
    for name, cids in by_type.items():
        chain = CHAIN_TABLE[name]
        fs = chain.get("resample_to") or 48000
        cfg_t = _demod_cfg(fs, chain["rs"], chain.get("est", 10000),
                           chain.get("mask", 0))
        type_plan.append((cfg_t, chain.get("resample_to"),
                          jnp.asarray(np.array(cids))))

    key = jax.random.key(1)
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P("ch", None, "t"))
    wide = jax.device_put(jax.random.normal(key, (B, 2, t_wide),
                                            jnp.float32), sh)
    wide2 = jax.device_put(jax.jit(lambda v: v + 1e-4)(wide), sh)
    slots_j = jnp.asarray(slots)

    @jax.jit
    def demod_actives(chf):
        acc = jnp.float32(0)
        bsum = jnp.int32(0)
        for cfg_t, rs_to, idx in type_plan:
            x = chf[idx].astype(jnp.float32)
            if rs_to:
                x = resample_planes(x, 48000, rs_to)
            soft, bits, _, _ = fsk_demod_stream(cfg_t, x)
            acc = acc + soft[:, ::257].sum()
            bsum = bsum + bits.astype(jnp.int32)[:, ::7].sum()
        return acc, bsum

    def one_step(w):
        chf, psd, _ = step.analyze(w, screen=False)
        conf = step.confirm(chf, slots_j)
        a, b = demod_actives(chf)
        # tiny consumption probes: psd + per-class peak stats + demod
        # sums keep every program live without charging full fetches
        return psd.sum() + sum(p[0].sum() for p in conf["peaks"]) + a, b

    jax.block_until_ready(one_step(wide))
    jax.block_until_ready(one_step(wide2))
    dt = _timed(one_step, (wide, wide2))
    msps = B * t_wide / dt / 1e6
    extra = {
        "model": "production device programs (analyze[no-screen] + "
                 "confirm@%d cands + %d-type demod@%d active)" % (
                     n_cand, len(type_plan), len(actives)),
        "confirm_slots": int(n_cand),
        "active_channels": len(actives),
    }
    return msps, dt * 1e3, extra


def bench_station_steady(actives=None, n_offgrid=2, scan=True):
    """The fused steady-state block (round-5): task state unchanged, no
    new candidates — channelize + PSD + recentered extraction of
    ``n_offgrid`` off-grid actives + per-type demod of the active
    channels, dispatched as ONE program
    (ShardedStationStep.steady_step).  This is the overwhelmingly
    common production block; the worst case (full confirmation slots)
    stays in ``bench_station_production``.

    Returns (wide Msps, step_ms)."""
    import numpy as np
    from radiosonde_auto_rx_jax.ops.channelizer import extract_phases
    from radiosonde_auto_rx_jax.parallel.mesh import make_mesh
    from radiosonde_auto_rx_jax.parallel.station_step import \
        ShardedStationStep

    n_chan = 50
    B = 10
    t_wide = 2_400_000
    mesh = make_mesh(n_ch=1, n_t=1, devices=jax.devices()[:1])
    step = ShardedStationStep(mesh, n_chan=n_chan, capacity=4)
    if actives is None:
        actives = ["RS41", "RS41", "RS41", "RS41", "DFM", "DFM",
                   "M10", "M10", "M20", "MTS01"]
    rng = np.random.default_rng(3)
    cids = rng.choice(B * n_chan, len(actives), replace=False)
    by_type = {}
    for name, cid in zip(actives, cids):
        by_type.setdefault(name, []).append(int(cid))
    plan, idx = [], []
    for name in sorted(by_type):
        ids = sorted(by_type[name])
        n = 1 << max(0, int(np.ceil(np.log2(len(ids)))))
        plan.append((name, n))
        idx.extend(ids + [ids[0]] * (n - len(ids)))
    # recentering slots: off-grid actives (the 10 kHz raster case)
    S = n_offgrid
    M = t_wide // n_chan
    ph_m = np.zeros((S, M), np.float32)
    ph_r = np.zeros((S, n_chan), np.float32)
    blk = np.zeros(S, np.int32)
    rows = np.zeros(S, np.int32)
    for s in range(S):
        cid = int(cids[s])
        f_rel = (cid % n_chan) * 48000.0 + 10e3
        ph_m[s], ph_r[s] = extract_phases(f_rel, n_chan * 48000,
                                          t_wide, n_chan)
        blk[s] = cid // n_chan
        rows[s] = cid
    idx_j = jnp.asarray(np.asarray(idx, np.int32))
    args = (idx_j, jnp.asarray(blk), jnp.asarray(rows),
            jnp.asarray(ph_m), jnp.asarray(ph_r))
    plan_t = tuple(plan)

    key = jax.random.key(1)
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P("ch", None, "t"))
    wide = jax.device_put(jax.random.normal(key, (B, 2, t_wide),
                                            jnp.float32), sh)
    wide2 = jax.device_put(jax.jit(lambda v: v + 1e-4)(wide), sh)

    @jax.jit
    def one_step(w):
        chf, psd, outs = step.steady_step(w, *args, plan_t, scan=scan)
        acc = psd.sum() if scan else chf[:, 0, ::4097].sum()
        bsum = jnp.int32(0)
        for name in outs:
            soft, bits, _ = outs[name]
            acc = acc + soft[:, ::257].sum()
            bsum = bsum + bits.astype(jnp.int32)[:, ::7].sum()
        return acc, bsum

    jax.block_until_ready(one_step(wide))
    jax.block_until_ready(one_step(wide2))
    dt = _timed(one_step, (wide, wide2))
    return B * t_wide / dt / 1e6, dt * 1e3


def bench_ablate(duty=0.2, cap=16):
    """Per-stage ablation of the station step at bench geometry:
    isolates channelize / PSD / prescreen / full-detect / demod with
    jitted single-stage programs (pipelined reps, best of 3) and prints
    a markdown table with per-stage ms, bytes and flops from XLA's cost
    analysis.  Evidence trail for the round's perf work."""
    from radiosonde_auto_rx_jax.demod.fsk import (fsk_init_state,
                                                  fsk_num_blocks_buffered,
                                                  _fsk_demod_scan_buffered)
    from radiosonde_auto_rx_jax.detect.correlator import _correlate_peaks
    from radiosonde_auto_rx_jax.detect.psd import _welch
    from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
    from radiosonde_auto_rx_jax.ops.channelizer import (_channelize,
                                                        pfb_prototype)

    n_chan = 50
    B = 10
    t_wide = 2_400_000
    cfg = _cfg()
    taps = jnp.asarray(pfb_prototype(n_chan))
    det = SondeDetector(48000)
    n_det = max(1, int(B * n_chan * duty))
    cap = min(cap, n_det)
    t_ch = t_wide // n_chan
    nb = fsk_num_blocks_buffered(cfg, t_ch)
    classes = [(bank, tuple(int(v) for v in lens))
               for _, _, _, bank, lens in det.classes]

    key = jax.random.key(1)
    wide = jax.random.normal(key, (B, 2, t_wide), jnp.float32)

    def s_channelize(w):
        ch = jax.vmap(lambda x: _channelize(x, taps, n_chan))(w)
        return ch.reshape(B * n_chan, 2, -1)

    chf = jax.jit(s_channelize)(wide)

    def s_psd(w):
        return _welch(w, 2048, hop=8192).sum()

    def s_prescreen(c):
        return det.prescreen.scores(c[:n_det]).sum()

    def s_fulldetect(c):
        ratio = det.prescreen.scores(c[:n_det])
        _, idx = jax.lax.top_k(ratio, cap)
        streams = det._condition(c[idx])
        acc = jnp.float32(0)
        for fm, (bank, lens_t) in zip(streams, classes):
            val, ipk, dcpk, xm = _correlate_peaks(
                fm, bank.astype(fm.dtype), lens_t)
            acc = acc + val.max() + xm.sum()
        return acc

    def s_demod(c):
        state = fsk_init_state(cfg, B * n_chan)
        _, outs = _fsk_demod_scan_buffered(cfg, c, state, nb)
        return (outs["bits"][:, :n_det].astype(jnp.int32).sum(),
                outs["soft"][:, :, ::257].sum())

    stages = [("channelize", s_channelize, wide),
              ("psd_scan", s_psd, wide),
              ("prescreen", s_prescreen, chf),
              ("full_detect_top%d" % cap, s_fulldetect, chf),
              ("fsk_demod", s_demod, chf)]

    total_ms = 0.0
    rows = []
    for name, fn, arg in stages:
        j = jax.jit(fn)
        arg2 = jax.jit(lambda v: v + 1e-4)(arg)
        jax.block_until_ready(j(arg))
        jax.block_until_ready(j(arg2))
        dt = _timed(j, (arg, arg2))
        ca = j.lower(arg).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0]
        flops = float(ca.get("flops", 0.0))
        nbytes = float(ca.get("bytes accessed", 0.0))
        total_ms += dt * 1e3
        rows.append((name, dt * 1e3, nbytes / 1e6, flops / 1e9,
                     nbytes / dt / 1e9))
    print("| stage | ms/step | MB accessed | GFLOP | GB/s |")
    print("|---|---|---|---|---|")
    for name, ms, mb, gf, gbs in rows:
        print(f"| {name} | {ms:.2f} | {mb:.0f} | {gf:.1f} | {gbs:.0f} |")
    print(f"| SUM (isolated) | {total_ms:.2f} | | | |")
    print(f"\ngeometry: B={B} x {t_wide / 1e6:.1f} Ms wide, {n_chan} ch, "
          f"duty={duty}, full-pass cap={cap}, reps={REPS}")
    print(f"wide Msps if fused step == sum: "
          f"{B * t_wide / total_ms / 1e3:.0f}")


def _device():
    """The card this run measures; exits non-zero without a GPU (a CPU
    run times nothing anyone deploys)."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found {d.platform!r}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    from radiosonde_auto_rx_jax.utils.compile_cache import \
        enable_compile_cache
    enable_compile_cache()
    device = _device()
    if "--ablate" in sys.argv:
        bench_ablate()
        return
    msps = bench_demod()
    extra = {}
    # the PRODUCTION device programs as Station._collect_sharded
    # dispatches them (worst-case full confirmation slots every block)
    pr_msps, pr_ms, pr_extra = bench_station_production()
    extra["station_step_msps_production"] = round(pr_msps, 3)
    extra["station_step_vs_baseline"] = round(pr_msps / BASELINE_MSPS, 2)
    extra["station_step_ms"] = round(pr_ms, 2)
    extra["station_step_model"] = pr_extra["model"]
    # fused steady-state block (the common case: no candidates, no task
    # change — analyze + recenter + demod as ONE program); while
    # decoding, the PSD scan runs 1-in-scan_every blocks, so the no-scan
    # variant is the majority block
    sd_msps, sd_ms = bench_station_steady()
    extra["station_step_msps_steady"] = round(sd_msps, 3)
    extra["station_step_ms_steady"] = round(sd_ms, 2)
    ns_msps, ns_ms = bench_station_steady(scan=False)
    extra["station_step_msps_steady_noscan"] = round(ns_msps, 3)
    extra["station_step_ms_steady_noscan"] = round(ns_ms, 2)
    # duty-weighted common block at the default scan_every=4
    extra["station_step_ms_steady_duty4"] = round((sd_ms + 3 * ns_ms) / 4,
                                                  2)
    print(json.dumps({
        "metric": "fsk_demod_iq_throughput",
        "value": round(msps, 3),
        "unit": "Msamples/s/card",
        "vs_baseline": round(msps / BASELINE_MSPS, 2),
        "device": device,
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
