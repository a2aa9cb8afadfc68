"""Sharding layer on the virtual 8-device CPU mesh: halo exchange,
overlap-save FIR equivalence, channel/time-sharded demod correctness."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
import pytest

from radiosonde_auto_rx_jax.demod.fsk import FSKConfig, fsk_demod_stream
from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn
from radiosonde_auto_rx_jax.ops.fir import design_lowpass, _conv_valid
from radiosonde_auto_rx_jax.parallel.mesh import (make_mesh,
                                                  stream_sharding)
from radiosonde_auto_rx_jax.parallel.pipeline import (make_station_step,
                                                      sharded_fir_filter,
                                                      sharded_fsk_demod)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs the 8-device virtual mesh")


def _cfg(nsym=50):
    return FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=nsym,
                     est_min=-5000, est_max=5000, tone_spacing=5000,
                     freq_est_type=1)


def _signal(rng, c, t, fs=48000, rs=4800):
    tx = rng.integers(0, 2, (c, t // (fs // rs) + 1))
    out = []
    for ci in range(c):
        iq = add_awgn(gfsk_mod(tx[ci][: t // (fs // rs)], fs, rs, 2, 0.0,
                               5000), 14.0, fs, rs)
        out.append(np.stack([iq.real, iq.imag]))
    x = np.stack(out).astype(np.float32)[:, :, :t]
    return tx, x


def test_sharded_fir_exact_vs_unsharded(rng):
    """Overlap-save across 4 time shards is bit-identical to the
    zero-state causal filter on the unsharded stream."""
    mesh = make_mesh(n_ch=2, n_t=4)
    h = design_lowpass(0.2, 33)
    C, T = 4, 4096
    x = rng.standard_normal((C, T)).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), stream_sharding(mesh))
    y_sharded = np.asarray(sharded_fir_filter(mesh, xs, h))
    xx = np.concatenate([np.zeros((C, len(h) - 1), np.float32), x], axis=1)
    y_ref = np.asarray(_conv_valid(jnp.asarray(xx), jnp.asarray(h)))
    np.testing.assert_allclose(y_sharded, y_ref, rtol=1e-5, atol=1e-6)


def test_channel_sharded_demod_exact(rng):
    """Pure channel DP (8 ch shards, 1 t shard) gives the identical bits
    to the unsharded demod — sharding must not change numerics.

    The shard body always prepends an nmem halo (zeros on the first
    shard), so the unsharded reference is the demod of the zero-padded
    stream."""
    cfg = _cfg()
    mesh = make_mesh(n_ch=8, n_t=1)
    tx, x = _signal(rng, 8, 48000)
    halo = cfg.nmem + 8 * cfg.ts     # buffered-scan halo incl. slack
    xpad = np.concatenate([np.zeros((8, 2, halo), np.float32), x],
                          axis=2)
    _, bits_ref, _, _ = fsk_demod_stream(cfg, jnp.asarray(xpad))
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P("ch", None, "t")))
    soft, bits = sharded_fsk_demod(cfg, mesh, xs)
    np.testing.assert_array_equal(np.asarray(bits), np.asarray(bits_ref))


def test_time_sharded_demod_decodes(rng):
    """Sequence parallelism (2 t shards, nmem halo): each shard re-locks
    inside its halo; the overall BER stays clean."""
    cfg = _cfg()
    mesh = make_mesh(n_ch=4, n_t=2)
    tx, x = _signal(rng, 4, 96000)
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P("ch", None, "t")))
    soft, bits = sharded_fsk_demod(cfg, mesh, xs)
    bits = np.asarray(bits)
    # Each t-shard emits its own contiguous run: shard s covers tx bits
    # around [s*T_local/ts - nmem/ts ...], re-emitting ~nmem/ts symbols
    # of overlap at the seam (frame-level dedup absorbs the repeats).
    # Verify each shard's segment independently: skip its warm-up
    # symbols, align to tx, and demand a clean BER.
    n_t, t_local = 2, 48000
    seg = bits.shape[1] // n_t
    warm = 2 * cfg.nsym                      # first blocks re-lock
    for ci in range(4):
        for s in range(n_t):
            run = bits[ci, s * seg + warm:(s + 1) * seg]
            lo = max(0, s * (t_local // cfg.ts) - 120)
            best = 1.0
            for off in range(lo, lo + 300):
                n = min(len(run), tx.shape[1] - off)
                if n > 500:
                    best = min(best, float(
                        np.mean(run[:n] != tx[ci, off:off + n])))
            assert best < 0.02, f"ch{ci} shard{s}: BER {best:.3f}"


def test_station_step_full_mesh(rng):
    """make_station_step on a (4, 2) mesh: compiles, runs, shapes/dtypes
    hold, outputs stay sharded."""
    cfg = _cfg()
    mesh = make_mesh(n_ch=4, n_t=2)
    tx, x = _signal(rng, 8, 8192 * 2)
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P("ch", None, "t")))
    step = make_station_step(cfg, mesh, if_taps=design_lowpass(0.2, 25))
    soft, bits = step(xs)
    soft.block_until_ready()
    assert soft.shape[0] == 8 and soft.shape == bits.shape
    assert soft.dtype == jnp.float32 and bits.dtype == jnp.uint8


def test_halo_exchange_contents():
    """halo_exchange_left moves exactly the neighbor's tail."""
    from radiosonde_auto_rx_jax.parallel.pipeline import shard_map
    from radiosonde_auto_rx_jax.parallel.halo import halo_exchange_left
    mesh = make_mesh(n_ch=1, n_t=8)
    t_local, halo = 16, 4
    x = jnp.arange(8 * t_local, dtype=jnp.float32)[None, :]
    xs = jax.device_put(x, stream_sharding(mesh))

    def body(xl):
        return halo_exchange_left(xl, halo, "t")

    y = shard_map(body, mesh=mesh, in_specs=(P("ch", "t"),),
                  out_specs=P("ch", "t"))(xs)
    y = np.asarray(y).reshape(8, t_local + halo)
    for s in range(8):
        if s == 0:
            np.testing.assert_array_equal(y[s, :halo], np.zeros(halo))
        else:
            want = np.arange(s * t_local - halo, s * t_local)
            np.testing.assert_array_equal(y[s, :halo], want)
        np.testing.assert_array_equal(
            y[s, halo:], np.arange(s * t_local, (s + 1) * t_local))


def test_multihost_helpers_single_process():
    """multihost helpers degrade cleanly in single-process mode."""
    from radiosonde_auto_rx_jax.parallel import multihost
    multihost.initialize()            # no coordinator: no-op
    mesh = multihost.global_mesh(n_t=2)
    assert mesh.shape["t"] == 2 and mesh.shape["ch"] * 2 == len(jax.devices())
    lo, hi = multihost.local_channel_slice(100)
    assert (lo, hi) == (0, 100)
