"""Worker for the real multi-process mesh tests (run as a subprocess).

Usage: python multiproc_worker.py <coordinator> <nproc> <pid> <outdir>
           [<mode> <ts>]

Each process owns 4 virtual CPU devices; the global (ch, t) mesh spans
all processes (SURVEY §4.7: multi-host tests via jax multi-process
execution — the collectives really cross process boundaries over the
distributed runtime, the closest this single-host environment gets to
DCN).

Modes:
  pipeline (default) — make_station_step (IF FIR + FSK demod) on a pure
      channel-DP mesh; writes per-channel bit shards.
  station — the FULL ShardedStationStep dataflow (PFB channelize →
      Welch PSD → prescreen ratios → full-rate confirm → expert
      all-to-all routing → per-type demod) on the (ch, t) = (4, 2)
      mesh, on the shared multi-sonde fixture (station_fixture.py,
      built deterministically from <ts>).  Writes every output's
      addressable shards keyed by global index so the parent can
      reassemble and compare bitwise against its own single-process
      8-device run.
"""

import os
import sys


def _save_sharded(npz, name, arr):
    """Collect ``arr``'s addressable shards into ``npz`` keyed by
    name|start,start,... (global offsets of the shard)."""
    import numpy as np
    for s in arr.addressable_shards:
        starts = ",".join(str(sl.start or 0) for sl in s.index)
        npz[f"{name}|{starts}"] = np.asarray(s.data)


def main():
    coordinator, nproc, pid, outdir = sys.argv[1:5]
    mode = sys.argv[5] if len(sys.argv) > 5 else "pipeline"
    ts = float(sys.argv[6]) if len(sys.argv) > 6 else None
    nproc, pid = int(nproc), int(pid)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # production multi-host entry (parallel/multihost.py): must succeed
    # BEFORE any backend-initializing jax call
    from radiosonde_auto_rx_jax.parallel import multihost
    multihost.initialize(coordinator_address=coordinator,
                         num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc
    assert len(jax.devices()) == 4 * nproc

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from radiosonde_auto_rx_jax.parallel.mesh import make_mesh

    if mode == "station":
        run_station(jax, np, jnp, NamedSharding, P, make_mesh,
                    nproc, pid, outdir, ts)
        return

    from radiosonde_auto_rx_jax.demod.fsk import FSKConfig
    from radiosonde_auto_rx_jax.ops.fir import design_lowpass
    from radiosonde_auto_rx_jax.parallel.pipeline import make_station_step

    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=50,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    n_dev = 4 * nproc
    mesh = make_mesh(n_ch=n_dev, n_t=1)          # global mesh, pure ch DP

    C, T = n_dev * 2, 24000
    rng = np.random.default_rng(0)               # same data on every proc
    bits = rng.integers(0, 2, (C, T // 10 + 2))
    sym = np.repeat(bits, 10, axis=1)[:, :T]
    f = np.where(sym == 0, -2500, 2500).astype(np.float64)
    ph = 2 * np.pi * np.cumsum(f, axis=1) / 48000
    iq = np.exp(1j * ph).astype(np.complex64)
    iq += (rng.standard_normal(iq.shape)
           + 1j * rng.standard_normal(iq.shape)).astype(np.complex64) * 0.05
    x_np = np.stack([iq.real, iq.imag], axis=1).astype(np.float32)

    sharding = NamedSharding(mesh, P("ch", None, "t"))
    x = jax.make_array_from_callback(
        x_np.shape, sharding, lambda idx: x_np[idx])

    step = make_station_step(cfg, mesh,
                             if_taps=design_lowpass(0.2, 25))
    soft, bits_out = step(x)
    jax.block_until_ready(bits_out)

    # save this process's addressable shards, keyed by global channel
    shards = {}
    for s in bits_out.addressable_shards:
        ch0 = s.index[0].start or 0
        shards[int(ch0)] = np.asarray(s.data)
    np.savez(os.path.join(outdir, f"out_{pid}.npz"),
             **{str(k): v for k, v in shards.items()})
    print(f"worker {pid}: wrote {len(shards)} shards", flush=True)


def run_station(jax, np, jnp, NamedSharding, P, make_mesh,
                nproc, pid, outdir, ts):
    import station_fixture as fx
    from radiosonde_auto_rx_jax.parallel.station_step import (
        EXPERT_TYPES, ShardedStationStep)

    mesh = make_mesh(n_ch=2 * nproc, n_t=2)      # (4, 2) global mesh
    step = ShardedStationStep(mesh, n_chan=fx.N_CHAN, capacity=2,
                              conf_capacity=2)

    wide_np = fx.make_wide_captures(ts)          # deterministic from ts
    wide = jax.make_array_from_callback(
        wide_np.shape, NamedSharding(mesh, P("ch", None, "t")),
        lambda idx: wide_np[idx])

    chf, psd, ratios = step.analyze(wide)

    # confirmation slots: the four sonde channels + one noise channel
    cands = [fx.RS41_CAP * fx.N_CHAN + fx.RS41_CH,
             fx.M20_CAP * fx.N_CHAN + fx.M20_CH,
             fx.DFM_CAP * fx.N_CHAN + fx.DFM_CH,
             fx.M10_CAP * fx.N_CHAN + fx.M10_CH,
             2 * fx.N_CHAN + 1]
    slots_np = np.full(step.n_conf_slots, -1, np.int32)
    slots_np[:len(cands)] = cands
    slots = jax.make_array_from_callback(
        slots_np.shape, NamedSharding(mesh, P()), lambda idx: slots_np[idx])
    conf = step.confirm(chf, slots)

    # expert routing: the known fixture types (the host policy that maps
    # confirm decisions to expert ids is exercised in-process by
    # tests/test_station_step.py; THIS test pins the cross-process
    # all-to-all + demod dataflow on a deterministic assignment)
    exp_np = np.full(fx.B * fx.N_CHAN, -1, np.int32)
    for cap, ch, name in ((fx.RS41_CAP, fx.RS41_CH, "RS41"),
                          (fx.M20_CAP, fx.M20_CH, "M20"),
                          (fx.DFM_CAP, fx.DFM_CH, "DFM"),
                          (fx.M10_CAP, fx.M10_CH, "M10")):
        exp_np[cap * fx.N_CHAN + ch] = EXPERT_TYPES.index(name)
    exp_ids = jax.make_array_from_callback(
        exp_np.shape, NamedSharding(mesh, P("ch")), lambda idx: exp_np[idx])
    res = step.route_demod(chf, exp_ids)
    jax.block_until_ready(res["bits"])

    out = {}
    _save_sharded(out, "ratios", ratios)
    _save_sharded(out, "psd", psd)
    _save_sharded(out, "streams", conf["streams"])
    for ci, pk in enumerate(conf["peaks"]):
        for j, part in enumerate(("val", "ipk", "dc", "xm")):
            _save_sharded(out, f"peak{ci}_{part}", pk[j])
    for k in ("soft", "bits", "ebno", "ids", "mask"):
        _save_sharded(out, k, res[k])
    np.savez(os.path.join(outdir, f"station_{pid}.npz"), **out)
    print(f"worker {pid}: wrote {len(out)} station shards", flush=True)


if __name__ == "__main__":
    main()
