"""REAL multi-process mesh execution (SURVEY §4.7 / VERDICT round-1
item 4): spawn N>=2 OS processes, initialize jax.distributed over a
coordinator, run the sharded station step on a global mesh, and assert
the gathered outputs are bit-identical to a single-process run."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "multiproc_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_matches_single_process(tmp_path):
    nproc = 2
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = []
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, coordinator, str(nproc), str(pid),
             str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=HERE))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=480)
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"

    # merge shards from both processes
    merged = {}
    for pid in range(nproc):
        with np.load(tmp_path / f"out_{pid}.npz") as z:
            for k in z.files:
                merged[int(k)] = z[k]
    assert merged, "no output shards written"

    # single-process reference on the same deterministic data
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from radiosonde_auto_rx_jax.demod.fsk import FSKConfig
    from radiosonde_auto_rx_jax.ops.fir import design_lowpass
    from radiosonde_auto_rx_jax.parallel.mesh import make_mesh
    from radiosonde_auto_rx_jax.parallel.pipeline import make_station_step

    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=50,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    n_dev = 4 * nproc
    C, T = n_dev * 2, 24000
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (C, T // 10 + 2))
    sym = np.repeat(bits, 10, axis=1)[:, :T]
    f = np.where(sym == 0, -2500, 2500).astype(np.float64)
    ph = 2 * np.pi * np.cumsum(f, axis=1) / 48000
    iq = np.exp(1j * ph).astype(np.complex64)
    iq += (rng.standard_normal(iq.shape)
           + 1j * rng.standard_normal(iq.shape)).astype(np.complex64) * 0.05
    x_np = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)

    mesh = make_mesh(n_ch=min(8, len(jax.devices())), n_t=1)
    x = jax.device_put(jnp.asarray(x_np),
                       NamedSharding(mesh, P("ch", None, "t")))
    step = make_station_step(cfg, mesh, if_taps=design_lowpass(0.2, 25))
    _, bits_ref = step(x)
    bits_ref = np.asarray(bits_ref)

    got = np.concatenate([merged[k] for k in sorted(merged)], axis=0)
    assert got.shape == bits_ref.shape, (got.shape, bits_ref.shape)
    np.testing.assert_array_equal(got, bits_ref)


def test_two_process_full_station_matches_single_process(tmp_path):
    """The COMPLETE ShardedStationStep dataflow — channelize → PSD →
    prescreen → full-rate confirm → expert all-to-all → per-type demod —
    executed over a (ch, t) = (4, 2) mesh spanning TWO OS processes via
    jax.distributed, compared BITWISE against the same mesh in one
    process.  Every cross-shard collective (channelizer halo exchange,
    PSD psum, prescreen pmax, confirm psum + all_gather, routing
    all_to_all, demod halo ppermute) really crosses a process boundary
    here (reference analogue: one decoder process per SDR/type across
    hosts, auto_rx.py:101-128 — re-architected as one SPMD program)."""
    import time as _time

    nproc = 2
    ts = float(int(_time.time()))       # shared fixture timestamp
    coordinator = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = []
    for pid in range(nproc):
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, coordinator, str(nproc), str(pid),
             str(tmp_path), "station", str(ts)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=HERE))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=900)
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"

    # ---- single-process reference on this process's 8 virtual devices
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from radiosonde_auto_rx_jax.parallel.mesh import make_mesh
    from radiosonde_auto_rx_jax.parallel.station_step import (
        EXPERT_TYPES, ShardedStationStep)
    import station_fixture as fx

    mesh = make_mesh(n_ch=4, n_t=2)
    step = ShardedStationStep(mesh, n_chan=fx.N_CHAN, capacity=2,
                              conf_capacity=2)
    wide = jax.device_put(jnp.asarray(fx.make_wide_captures(ts)),
                          NamedSharding(mesh, P("ch", None, "t")))
    chf, psd, ratios = step.analyze(wide)
    cands = [fx.RS41_CAP * fx.N_CHAN + fx.RS41_CH,
             fx.M20_CAP * fx.N_CHAN + fx.M20_CH,
             fx.DFM_CAP * fx.N_CHAN + fx.DFM_CH,
             fx.M10_CAP * fx.N_CHAN + fx.M10_CH,
             2 * fx.N_CHAN + 1]
    slots_np = np.full(step.n_conf_slots, -1, np.int32)
    slots_np[:len(cands)] = cands
    conf = step.confirm(chf, jnp.asarray(slots_np))
    exp_np = np.full(fx.B * fx.N_CHAN, -1, np.int32)
    for cap, ch, name in ((fx.RS41_CAP, fx.RS41_CH, "RS41"),
                          (fx.M20_CAP, fx.M20_CH, "M20"),
                          (fx.DFM_CAP, fx.DFM_CH, "DFM"),
                          (fx.M10_CAP, fx.M10_CH, "M10")):
        exp_np[cap * fx.N_CHAN + ch] = EXPERT_TYPES.index(name)
    res = step.route_demod(chf, jnp.asarray(exp_np))

    ref = {"ratios": np.asarray(ratios), "psd": np.asarray(psd),
           "streams": np.asarray(conf["streams"])}
    for ci, pk in enumerate(conf["peaks"]):
        for j, part in enumerate(("val", "ipk", "dc", "xm")):
            ref[f"peak{ci}_{part}"] = np.asarray(pk[j])
    for k in ("soft", "bits", "ebno", "ids", "mask"):
        ref[k] = np.asarray(res[k])

    # ---- reassemble the workers' shards and compare bitwise
    merged = {name: np.full_like(arr, -12345) for name, arr in ref.items()}
    filled = {name: np.zeros(arr.shape, bool) for name, arr in ref.items()}
    for pid in range(nproc):
        with np.load(tmp_path / f"station_{pid}.npz") as z:
            for key in z.files:
                name, starts = key.split("|")
                data = z[key]
                sl = tuple(slice(int(s0), int(s0) + d)
                           for s0, d in zip(starts.split(","), data.shape))
                prev = merged[name][sl]
                was = filled[name][sl]
                assert not was.any() or np.array_equal(prev, data), \
                    f"{name}: replicated shards disagree across processes"
                merged[name][sl] = data
                filled[name][sl] = True
    for name, arr in ref.items():
        assert filled[name].all(), f"{name}: missing shards"
        np.testing.assert_array_equal(
            merged[name], arr, err_msg=f"{name} differs from single-process")

    # ---- end-to-end: the RS41 telemetry decodes from the multi-process
    # routed bits exactly as from the single-process run
    from radiosonde_auto_rx_jax.models import get_model
    e = EXPERT_TYPES.index("RS41")
    srow = int(np.flatnonzero(np.asarray(merged["ids"][e]) ==
                              fx.RS41_CAP * fx.N_CHAN + fx.RS41_CH)[0])
    t_total = fx.T_WIDE // fx.N_CHAN
    bits_rs, _ = step.slot_bits(
        {k: jnp.asarray(v) for k, v in merged.items()
         if k in ("bits", "soft")}, e, srow, t_total)
    telems = get_model("RS41")().decode_bits(bits_rs, None)
    assert telems and telems[-1]["id"] == "T1357911"
