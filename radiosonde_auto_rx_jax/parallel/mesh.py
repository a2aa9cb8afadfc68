"""Device mesh + sharding helpers.

Axis names:
  ``ch`` — channel data parallelism (leading axis of [C, T] IQ tensors)
  ``t``  — time/sequence parallelism (trailing axis, overlap-save halos)

A plain 2-D grid: the cards of a host are joined all to all, so no
axis order is tied to a physical topology.
"""

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CH_AXIS = "ch"
T_AXIS = "t"


def make_mesh(n_ch: int | None = None, n_t: int = 1,
              devices=None) -> Mesh:
    """Build a ``(ch, t)`` mesh over ``devices`` (default: all).

    If ``n_ch`` is None it absorbs all devices not used by ``n_t``.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if n_ch is None:
        assert n % n_t == 0, f"{n} devices not divisible by n_t={n_t}"
        n_ch = n // n_t
    assert n_ch * n_t <= n, f"mesh {n_ch}x{n_t} needs more than {n} devices"
    dev = np.asarray(devices[: n_ch * n_t]).reshape(n_ch, n_t)
    return Mesh(dev, (CH_AXIS, T_AXIS))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """[C, ...] tensors: shard channels, replicate the rest."""
    return NamedSharding(mesh, P(CH_AXIS))


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """[C, T] IQ streams: channels over ``ch``, time over ``t``."""
    return NamedSharding(mesh, P(CH_AXIS, T_AXIS))
