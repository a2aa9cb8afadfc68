"""Mesh construction, shardings and halo-exchange collectives.

The reference scales by assigning one SDR to one OS task (reference
auto_rx/auto_rx.py:101-128) and pipes samples between processes.  Here the
scaling axes are a ``jax.sharding.Mesh``:

* axis ``ch`` — channel data parallelism: the leading ``[C]`` axis of every
  IQ/soft-bit tensor is sharded over devices.  Channels are independent, so
  this axis needs no collectives at all.
* axis ``t`` — sequence (time) parallelism: long IQ streams are split into
  contiguous time shards.  Convolution/window continuity across the cut is
  restored by exchanging a left *halo* with the neighbor shard via
  ``lax.ppermute`` — the DSP analogue of ring attention.  Halo sizes come
  from the reference's own overlap bookkeeping (``Nmem = N + 2·Ts``
  utils/fsk.c:149, ``M = N_DFT + delay`` scan/dft_detect.c:1201).

Every device reaches every other at the same rate (NVLink within a host),
so the mesh shape follows the algorithm alone; collectives lower to NCCL.
Nothing here assumes a device count: the same code runs on 1 card, a
virtual CPU mesh (tests), or several hosts.
"""

from radiosonde_auto_rx_jax.parallel.mesh import (
    make_mesh,
    channel_sharding,
    stream_sharding,
)
from radiosonde_auto_rx_jax.parallel.halo import (
    halo_exchange_left,
    halo_exchange_right,
)
from radiosonde_auto_rx_jax.parallel.pipeline import (
    sharded_fir_filter,
    sharded_fsk_demod,
    make_station_step,
)
