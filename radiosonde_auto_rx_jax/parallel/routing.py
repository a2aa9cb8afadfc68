"""Expert-parallel decoder routing: channels -> per-type decoder shards.

The reference runs one decoder process per (SDR, type) pair
(reference auto_rx/auto_rx.py:101-128 allocate_sdr/start_decoder); the
mesh-native analogue treats each sonde type's demod/decode chain as an
"expert" owned by a group of ``ch``-axis shards and moves detected
channels to their expert with one capacity-padded ``lax.all_to_all`` —
the MoE dispatch pattern applied to radio channels.

Shapes are static: every (source shard -> expert) pair carries a fixed
``capacity`` of channel slots; unused slots are masked.  Overflow
channels are dropped and counted (the reference's analogue: more
detections than available SDRs are simply not decoded,
auto_rx.py handle_scan_results).

Also provides the single-device compaction primitive ``compact_by_type``
(argsort-based, jit-friendly): the station's per-type batch grouping in
``Station.process_capture`` runs through it
(station/station.py group_tasks_by_type), and the sharded station step's
expert dispatch ships the same slot layout over the mesh
(parallel/station_step.py via ``dispatch_to_experts``).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from radiosonde_auto_rx_jax.parallel.mesh import CH_AXIS

from jax import shard_map

from jax.sharding import PartitionSpec as P


@partial(jax.jit, static_argnames=("n_types", "capacity"))
def compact_by_type(type_ids: jnp.ndarray, n_types: int, capacity: int):
    """Group channel indices by type id (-1 = no detection).

    type_ids: [C] int32.  Returns (slots [n_types, capacity] int32 channel
    indices (-1 pad), counts [n_types], dropped [n_types]).
    """
    c = type_ids.shape[0]
    order = jnp.argsort(type_ids, stable=True)          # -1s first
    sorted_ids = type_ids[order]
    # rank of each channel within its type group
    same = sorted_ids[:, None] == jnp.arange(n_types)[None, :]  # [C, K]
    rank = jnp.cumsum(same, axis=0) - 1                  # [C, K]
    rank = jnp.where(same, rank, 0).sum(axis=1)          # [C]
    counts = same.sum(axis=0)                            # [K]
    # scatter into an extra dump row so invalid entries never collide
    # with a real slot (duplicate-index .set order is unspecified)
    slots = jnp.full((n_types + 1, capacity), -1, jnp.int32)
    valid = (sorted_ids >= 0) & (rank < capacity)
    slots = slots.at[
        jnp.where(valid, sorted_ids, n_types),
        jnp.where(valid, rank % capacity, 0)].set(
        jnp.where(valid, order.astype(jnp.int32), -1))[:n_types]
    dropped = jnp.maximum(counts - capacity, 0)
    return slots, jnp.minimum(counts, capacity), dropped


def gather_type_batch(x: jnp.ndarray, slots_k: jnp.ndarray):
    """Gather one expert's channels: x [C, ...], slots_k [capacity] ->
    (batch [capacity, ...], mask [capacity])."""
    mask = slots_k >= 0
    idx = jnp.clip(slots_k, 0, x.shape[0] - 1)
    batch = x[idx]
    zero = jnp.zeros_like(batch)
    return jnp.where(mask.reshape((-1,) + (1,) * (batch.ndim - 1)),
                     batch, zero), mask


def dispatch_to_experts(xl, tl, n_experts: int, capacity: int,
                        n_sh: int, channel_ids=None):
    """Expert dispatch body — call INSIDE a shard_map over ``ch``.

    xl: local [C_l, ...] payload; tl: local [C_l] type ids (-1 = none).
    Packs up to ``capacity`` channels per (source shard, expert), ships
    them with one ``all_to_all`` over the ``ch`` axis, and returns
      (recv [e_local, n_src*capacity, ...], mask [e_local, n_src*cap],
       ids [e_local, n_src*cap] or None, dropped [1])
    where expert ``e`` lands on shard ``e // e_local`` at local slot
    ``e % e_local``.  ``channel_ids`` (local [C_l]) rides along so the
    host can map routed slots back to global channels.  Used by the full
    sharded station step (parallel/station_step.py route_demod).
    """
    assert n_experts % n_sh == 0, \
        f"n_experts {n_experts} must be a multiple of ch shards {n_sh}"
    e_local = n_experts // n_sh
    C_l = xl.shape[0]
    feat_shape = xl.shape[1:]
    slots, counts, dropped = compact_by_type(tl, n_experts, capacity)
    batches, masks, ids = [], [], []
    for e in range(n_experts):
        b, m = gather_type_batch(xl, slots[e])
        batches.append(b)
        masks.append(m)
        if channel_ids is not None:
            ids.append(jnp.where(
                m, channel_ids[jnp.clip(slots[e], 0, C_l - 1)], -1))
    send = jnp.stack(batches).reshape((n_sh, e_local, capacity)
                                      + feat_shape)
    send_m = jnp.stack(masks).reshape(n_sh, e_local, capacity)
    # all-to-all: swap the leading dst axis with the shard axis
    S_tot = n_sh * capacity
    recv = lax.all_to_all(send, CH_AXIS, 0, 0, tiled=False)
    recv_m = lax.all_to_all(send_m, CH_AXIS, 0, 0, tiled=False)
    # recv: [n_src, e_local, capacity, ...] -> expert-major, slots flat
    recv = jnp.moveaxis(recv, 0, 1).reshape((e_local, S_tot) + feat_shape)
    recv_m = jnp.moveaxis(recv_m, 0, 1).reshape(e_local, S_tot)
    recv_i = None
    if channel_ids is not None:
        send_i = jnp.stack(ids).reshape(n_sh, e_local, capacity)
        recv_i = jnp.moveaxis(
            lax.all_to_all(send_i, CH_AXIS, 0, 0, tiled=False),
            0, 1).reshape(e_local, S_tot)
    return recv, recv_m, recv_i, dropped.sum()[None]


def route_to_experts(mesh, x: jnp.ndarray, type_ids: jnp.ndarray,
                     n_experts: int, capacity: int):
    """All-to-all channel dispatch over the ``ch`` mesh axis.

    x: [C, F, T_local...] sharded P(ch, ...); type_ids: [C] sharded
    P(ch).  Expert e = type id e, owned by ch-shard ``e // e_local``.
    Each source shard packs up to ``capacity`` local channels per expert;
    concretely the result is, per shard,
      recv [n_experts_local, n_src * capacity, F, T]  +  mask
    where n_experts_local = n_experts / n_shards (must divide).

    Returns (recv, recv_mask, dropped) as global arrays sharded P(ch).
    """
    n_sh = mesh.shape[CH_AXIS]

    def body(xl, tl):
        recv, recv_m, _, dropped = dispatch_to_experts(
            xl, tl, n_experts, capacity, n_sh)
        return recv, recv_m, dropped

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(CH_AXIS), P(CH_AXIS)),
        out_specs=(P(CH_AXIS), P(CH_AXIS), P(CH_AXIS)),
    )(x, type_ids)
