"""Sharded end-to-end signal pipeline: the station "step".

The reference's per-sonde shell pipeline (rtl_fm | iq_dec | fsk_demod |
<decoder>, reference auto_rx/autorx/decode.py:1500-1529) becomes one jitted
program over ``IQ[C, T]``:

    IF lowpass (overlap-save FIR)  →  FSK demod (block scan)  →  soft bits

sharded over a ``(ch, t)`` mesh: channels are pure data parallelism; the
time axis is sequence-parallel with a left halo exchanged by ``ppermute``
(parallel/halo.py).  Each time shard re-locks demod state within its halo —
the same recovery the reference performs after any stream restart (decoders
are stateless across restarts by design, reference decode.py teardown path).
"""

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from jax import shard_map

from radiosonde_auto_rx_jax.demod.fsk import (
    FSKConfig, fsk_init_state, fsk_num_blocks_buffered, iq_planes,
    _fsk_demod_scan_buffered)
from radiosonde_auto_rx_jax.ops.fir import _conv_valid
from radiosonde_auto_rx_jax.parallel.halo import halo_exchange_left
from radiosonde_auto_rx_jax.parallel.mesh import CH_AXIS, T_AXIS


def sharded_fir_filter(mesh, x, h):
    """Causal FIR over [C, T] sharded (ch, t); overlap-save across t shards.

    Bit-identical to filtering the unsharded stream with zero initial state.
    """
    K = int(h.shape[0])

    def body(xl, hl):
        xx = halo_exchange_left(xl, K - 1, T_AXIS)
        if jnp.iscomplexobj(xx):
            y = jax.lax.complex(_conv_valid(xx.real, hl),
                                _conv_valid(xx.imag, hl))
        else:
            y = _conv_valid(xx, hl)
        return y

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(CH_AXIS, T_AXIS), P()),
        out_specs=P(CH_AXIS, T_AXIS),
    )(x, jnp.asarray(h))


def sharded_fsk_demod(cfg: FSKConfig, mesh, x):
    """FSK-demodulate float32 IQ planes [C, 2, T] sharded (ch, -, t).

    Each time shard prepends an ``nmem``-sample halo and runs the block
    scan locally with fresh state (freq-est EMA warms up inside the halo
    region).  Returns (soft, bits) sharded (ch, t).

    Seam semantics: because the halo region is demodulated too, each
    shard re-emits ~``nmem/ts`` symbols of its left neighbor's tail;
    the frame layer's duplicate-frame handling absorbs the repeats
    (the reference tolerates repeated frames the same way after decoder
    restarts).  Shard 0's halo is zeros — identical to a fresh stream
    start.

    Uses the gather-free buffered scan (the library default) — the halo
    includes the buffered scan's slack window so pure
    channel sharding stays bit-identical to the unsharded demod.
    """
    slack = 8 * cfg.ts
    halo = cfg.nmem + slack

    def body(xl):
        C_local, _, T_local = xl.shape
        xx = halo_exchange_left(xl, halo, T_AXIS)
        nb = fsk_num_blocks_buffered(cfg, T_local + halo)
        state = fsk_init_state(cfg, C_local)
        # scan carries must be marked device-varying inside shard_map
        state = jax.tree.map(
            lambda a: jax.lax.pcast(a, (CH_AXIS, T_AXIS), to="varying"),
            state)
        _, outs = _fsk_demod_scan_buffered(cfg, xx, state, nb)
        soft = jnp.transpose(outs["soft"], (1, 0, 2)).reshape(C_local, -1)
        bits = jnp.transpose(outs["bits"], (1, 0, 2)).reshape(C_local, -1)
        return soft, bits

    return shard_map(
        body, mesh=mesh,
        in_specs=(P(CH_AXIS, None, T_AXIS),),
        out_specs=(P(CH_AXIS, T_AXIS), P(CH_AXIS, T_AXIS)),
    )(x)


def make_station_step(cfg: FSKConfig, mesh, if_taps=None):
    """Build the jitted sharded station step: IQ planes [C, 2, T] (or
    complex64 [C, T]) → (soft, bits).

    ``if_taps``: optional IF lowpass taps run overlap-save before the demod
    (the reference's iq_dec/lowpass stage, demod/mod/demod_mod.c:765-768).
    """
    taps = None if if_taps is None else jnp.asarray(if_taps)

    @jax.jit
    def step(x):
        x = iq_planes(x)
        if taps is not None:
            C, _, T = x.shape
            y = sharded_fir_filter(mesh, x.reshape(C * 2, T), taps)
            x = y.reshape(C, 2, T)
        return sharded_fsk_demod(cfg, mesh, x)

    return step
