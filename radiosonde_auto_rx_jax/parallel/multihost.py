"""Multi-host initialization helpers.

The reference is strictly single-host (SURVEY §5: no distributed comm
backend; KA9Q's RTP multicast is the closest analogue).  Here scale-out
is the standard JAX recipe: one process per host, ``jax.distributed``
between them, one global mesh whose ``ch`` axis spans hosts.  The
``(ch, t)`` mesh is plain data parallelism: channel batches are
independent, so the only traffic is the collectives the sharded program
asks for (NCCL over NVLink within a host, over the cluster network
between hosts; the ``ch`` axis never communicates in steady state).

Typical use on each host::

    from radiosonde_auto_rx_jax.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=i)
    mesh = multihost.global_mesh(n_t=1)     # (ch, t) over ALL devices
    step = make_station_step(cfg, mesh, ...)

Telemetry fan-in stays host-local: each host runs its own exporters for
the channels it feeds (the reference's exporter model, auto_rx.py:948+),
or forwards dicts to one aggregator over the network (ozimux/UDP or
sondehub both already handle multi-station input).
"""

import logging

import jax

from radiosonde_auto_rx_jax.parallel.mesh import make_mesh

log = logging.getLogger("multihost")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None):
    """jax.distributed.initialize, safe to call repeatedly.

    Pass coordinator/num_processes/process_id explicitly; with no
    arguments JAX tries its cluster autodetection and this falls back to
    single-process when none applies.  No-op when already initialized.

    NOTE: must run before ANY other jax call — even
    ``jax.process_count()`` initializes the local backend, after which
    ``jax.distributed.initialize`` unconditionally raises (round-4
    review: an earlier already-initialized guard built on process_count
    made this function a guaranteed silent no-op)."""
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes,
                      process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
        log.info("distributed: process %d/%d, %d local + %d global devices",
                 jax.process_index(), jax.process_count(),
                 jax.local_device_count(), jax.device_count())
    except (ValueError, RuntimeError) as e:
        if coordinator_address is not None:
            raise
        log.warning("multihost: running single-process (%s)", e)


def global_mesh(n_t: int = 1):
    """(ch, t) mesh over every device of every process.

    The ``ch`` axis spans hosts (pure DP — no steady-state cross-host
    traffic); keep ``n_t`` within one host's devices so halo ppermutes
    stay on the host's NVLink."""
    return make_mesh(n_t=n_t, devices=jax.devices())


def local_channel_slice(n_channels: int):
    """Which global channels this process feeds: the contiguous block
    matching its position on the mesh's ch axis."""
    per = n_channels // jax.process_count()
    lo = jax.process_index() * per
    hi = lo + per if jax.process_index() < jax.process_count() - 1 \
        else n_channels
    return lo, hi
