"""Halo exchange for overlap-save sequence parallelism.

Used inside ``shard_map`` bodies: each time shard holds a contiguous
``[..., T_local]`` slice of the stream; convolution/window continuity needs
``halo`` trailing samples of the *previous* shard prepended.  One
``lax.ppermute`` moves every halo one hop along the ring — a single
neighbor transfer, no all-gather.
"""

import jax
import jax.numpy as jnp
from jax import lax


def halo_exchange_left(x: jnp.ndarray, halo: int, axis_name: str):
    """Prepend each shard with the last ``halo`` samples of its left
    neighbor (zeros for shard 0, matching zero-initial filter state).

    x: [..., T_local]  ->  [..., halo + T_local]
    """
    if halo == 0:
        return x            # x[..., -0:] would be the WHOLE shard
    n = lax.psum(1, axis_name)
    idx = lax.axis_index(axis_name)
    tail = x[..., -halo:]
    if n > 1:
        perm = [(i, (i + 1) % n) for i in range(n)]
        recv = lax.ppermute(tail, axis_name, perm)
    else:
        recv = tail
    recv = jnp.where(idx == 0, jnp.zeros_like(recv), recv)
    return jnp.concatenate([recv, x], axis=-1)


def halo_exchange_right(x: jnp.ndarray, halo: int, axis_name: str):
    """Append the first ``halo`` samples of the right neighbor
    (zeros for the last shard).

    x: [..., T_local]  ->  [..., T_local + halo]
    """
    if halo == 0:
        return x
    n = lax.psum(1, axis_name)
    idx = lax.axis_index(axis_name)
    head = x[..., :halo]
    if n > 1:
        perm = [(i, (i - 1) % n) for i in range(n)]
        recv = lax.ppermute(head, axis_name, perm)
    else:
        recv = head
    recv = jnp.where(idx == n - 1, jnp.zeros_like(recv), recv)
    return jnp.concatenate([x, recv], axis=-1)
