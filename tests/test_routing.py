"""Expert-parallel channel routing: compaction + all-to-all dispatch."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.parallel.mesh import make_mesh
from radiosonde_auto_rx_jax.parallel.routing import (compact_by_type,
                                                     gather_type_batch,
                                                     route_to_experts)


def test_compact_by_type_basic():
    ids = jnp.asarray([2, -1, 0, 2, 1, 0, -1, 2], jnp.int32)
    slots, counts, dropped = compact_by_type(ids, 3, 4)
    slots = np.asarray(slots)
    assert sorted(slots[0][slots[0] >= 0].tolist()) == [2, 5]
    assert sorted(slots[1][slots[1] >= 0].tolist()) == [4]
    assert sorted(slots[2][slots[2] >= 0].tolist()) == [0, 3, 7]
    np.testing.assert_array_equal(np.asarray(counts), [2, 1, 3])
    np.testing.assert_array_equal(np.asarray(dropped), [0, 0, 0])


def test_compact_capacity_overflow():
    ids = jnp.asarray([1, 1, 1, 1, 1], jnp.int32)
    slots, counts, dropped = compact_by_type(ids, 2, 3)
    slots = np.asarray(slots)
    assert (slots[1] >= 0).sum() == 3
    assert int(counts[1]) == 3 and int(dropped[1]) == 2
    # no phantom entries in other experts
    assert (slots[0] >= 0).sum() == 0


def test_compact_all_empty():
    ids = jnp.full((6,), -1, jnp.int32)
    slots, counts, dropped = compact_by_type(ids, 4, 2)
    assert (np.asarray(slots) >= 0).sum() == 0
    assert np.asarray(counts).sum() == 0


def test_gather_type_batch():
    x = jnp.arange(12.0).reshape(6, 2)
    batch, mask = gather_type_batch(x, jnp.asarray([4, 1, -1], jnp.int32))
    np.testing.assert_array_equal(np.asarray(mask), [True, True, False])
    np.testing.assert_array_equal(np.asarray(batch[0]), [8.0, 9.0])
    np.testing.assert_array_equal(np.asarray(batch[2]), [0.0, 0.0])


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs virtual mesh")
def test_route_to_experts_all_to_all(rng):
    """Every expert shard receives exactly the channels of its type."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = make_mesh(n_ch=4, n_t=1)
    C, F, T = 32, 2, 64
    n_exp, cap = 4, 4
    x = rng.standard_normal((C, F, T)).astype(np.float32)
    ids = rng.integers(-1, n_exp, C).astype(np.int32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("ch")))
    ts = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("ch")))
    recv, mask, dropped = route_to_experts(mesh, xs, ts, n_exp, cap)
    recv = np.asarray(recv)      # [n_exp, n_src * cap, F, T]
    mask = np.asarray(mask)
    assert recv.shape == (n_exp, 4 * cap, F, T)
    c_local = C // 4
    for e in range(n_exp):
        got = recv[e][mask[e]]                     # [n_recv, F, T]
        want_idx = [c for c in range(C) if ids[c] == e]
        # capacity is per (src shard, expert): count per-shard clipping
        want = []
        for s in range(4):
            in_shard = [c for c in want_idx
                        if s * c_local <= c < (s + 1) * c_local]
            want.extend(in_shard[:cap])
        assert got.shape[0] == len(want), (e, got.shape, want)
        # contents match irrespective of order
        got_set = {tuple(np.round(g[0, :4], 5)) for g in got}
        want_set = {tuple(np.round(x[c][0, :4], 5)) for c in want}
        assert got_set == want_set


def test_station_grouping_matches_host_dict(rng):
    """Station.process_capture's per-type grouping (EP compaction
    primitive) must equal the plain host dict grouping."""
    from radiosonde_auto_rx_jax.station.station import Station
    tasks = [(3, "RS41", "d3"), (7, "M20", "d7"), (1, "RS41", "d1"),
             (9, "DFM", "d9"), (5, "M20", "d5")]
    got = Station.group_tasks_by_type(tasks, n_chan=16)
    want = {}
    for ci, name, det in tasks:
        want.setdefault(name, []).append((ci, det))
    assert set(got) == set(want)
    for name in want:
        assert sorted(got[name]) == sorted(want[name])
    assert Station.group_tasks_by_type([], 16) == {}
