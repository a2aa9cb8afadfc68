"""Pipeline parallelism: stage-split station dataflow over a mesh axis.

The reference's pipe graph runs each stage (rtl_fm | iq_dec | fsk_demod |
decoder) as a separate OS process connected by pipes, all steady-state
concurrent on different byte ranges (reference auto_rx/autorx/
decode.py:1500-1529).  The batch-pipeline analogue is a systolic microbatch
pipeline over a ``stage`` mesh axis: device ``s`` holds stage ``s``'s
program and stage-local carry; every tick each device processes one
microbatch-sized block and hands its output to device ``s+1`` via
``ppermute`` (the "double-buffered transfer" — XLA overlaps the collective
with the next tick's compute).  After the ``S-1``-tick fill, all stages run
concurrently on consecutive time blocks, exactly like the reference's
processes at steady state.

Uniform activation shapes: every stage maps ``[C, 2, B] -> [C, 2, B]``
(pad/pack inside the block — the standard GPipe-style contract); each
stage's carry rides in the scan state on its own device, which is what
gives bit-exact *streaming* semantics across microbatches (demod state
continuity — the reference's ``Nmem`` sliding memory, fsk.c:149,637-640).
"""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from radiosonde_auto_rx_jax.demod.fsk import (
    FSKConfig, fsk_init_state, fsk_num_blocks, _fsk_demod_scan)
from radiosonde_auto_rx_jax.ops.fir import _conv_valid

STAGE_AXIS = "stage"


def make_stage_mesh(n_stage: int, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    assert len(devices) >= n_stage
    return Mesh(np.asarray(devices[:n_stage]), (STAGE_AXIS,))


def pipeline_parallel(mesh: Mesh, stage_fns, carry_init, xs):
    """Run ``S`` stages over ``M`` microbatches on the ``stage`` axis.

    stage_fns: list of ``fn(x, carry) -> (y, carry)`` with uniform
        ``x``/``y`` shape ``xs.shape[1:]`` and a carry pytree per stage
        (structures may differ between stages).
    carry_init: list of initial carries (one per stage).
    xs: ``[M, ...]`` microbatch sequence.

    Returns ``[M, ...]`` outputs of the last stage, microbatch order
    preserved.  Total ticks = ``M + S - 1`` (fill + steady state), vs
    ``M * S`` for serial execution — the classic pipeline speedup.
    """
    S = mesh.shape[STAGE_AXIS]
    assert len(stage_fns) == S == len(carry_init)
    M = int(xs.shape[0])
    pad = jnp.zeros((S - 1,) + tuple(xs.shape[1:]), xs.dtype)
    xs_pad = jnp.concatenate([jnp.asarray(xs), pad], axis=0)

    # lax.switch branches must return one uniform structure: every branch
    # carries the full tuple of carries, updating only its own slot
    carries0 = tuple(carry_init)

    def _branch(s):
        def run(x, carries):
            y, c = stage_fns[s](x, carries[s])
            new = tuple(c if i == s else carries[i] for i in range(S))
            return y, new
        return run

    branches = [_branch(s) for s in range(S)]
    perm = [(i, (i + 1) % S) for i in range(S)]

    def body(xs_all):
        sid = jax.lax.axis_index(STAGE_AXIS)
        buf0 = jnp.zeros_like(xs_all[0])
        carries = carries0
        # scan carries (and switch outputs) must be device-varying
        # inside shard_map
        buf0, carries = jax.tree.map(
            lambda a: jax.lax.pcast(a, (STAGE_AXIS,), to="varying"),
            (buf0, carries))

        def tick(state, xt):
            x_t, t_idx = xt
            buf, carries = state
            inp = jnp.where(sid == 0, x_t, buf)
            y, new_carries = jax.lax.switch(sid, branches, inp, carries)
            # fill/drain gating: stage s holds microbatch t_idx - s; only
            # ticks with a real microbatch may emit or advance the carry
            valid = (t_idx >= sid) & (t_idx < sid + M)
            y = jnp.where(valid, y, jnp.zeros_like(y))
            carries = jax.tree.map(
                lambda new, old: jnp.where(valid, new, old),
                new_carries, carries)
            nxt = jax.lax.ppermute(y, STAGE_AXIS, perm)
            return (nxt, carries), y

        ticks = jnp.arange(M + S - 1)
        (_, _), ys = jax.lax.scan(tick, (buf0, carries), (xs_all, ticks))
        return ys[None]                     # [1, M+S-1, ...] per device

    ys = shard_map(
        body, mesh=mesh,
        in_specs=(P(),),
        out_specs=P(STAGE_AXIS),
    )(xs_pad)                               # [S, M+S-1, ...]
    # the pipeline's product is what leaves the LAST stage, which emits
    # microbatch m at tick m + S - 1
    return ys[S - 1, S - 1:S - 1 + M]


def make_pp_demod_pipeline(cfg: FSKConfig, mesh: Mesh, if_taps,
                           channels: int, t_mb: int):
    """3-stage station pipeline: DC block → IF lowpass FIR → FSK demod.

    Returns ``run(xs) -> (soft, bits)`` where ``xs`` is ``[M, C, 2, B]``
    float32 IQ plane microbatches; soft/bits are ``[M, C, nsym_mb]``.
    Stage carries: FIR overlap-save tail (stage 1) and the demod's full
    scan state (stage 2) persist on their stage devices across
    microbatches — streaming semantics identical to the unsharded demod.
    """
    taps = jnp.asarray(if_taps, jnp.float32)
    K = int(taps.shape[0])
    # block-aligned streaming: carry exactly the 2·ts samples beyond the
    # last block advance (nmem = n + 2·ts, fsk.c:149) so restarts land on
    # the next nominal block start — every symbol emitted exactly once,
    # no halo re-emission at microbatch seams
    assert t_mb % cfg.n == 0, "t_mb must be a multiple of cfg.n"
    tail_len = cfg.nmem - cfg.n             # = 2*ts
    nb = t_mb // cfg.n
    nsym_mb = nb * cfg.nsym
    assert nsym_mb <= t_mb, "microbatch too small to carry its symbols"

    def stage_dc(x, carry):
        # running DC estimate (EMA across microbatches)
        dc = 0.98 * carry + 0.02 * jnp.mean(x, axis=-1, keepdims=True)
        return (x - dc).astype(x.dtype), dc

    def stage_fir(x, tail):
        C, _, B = x.shape
        xx = jnp.concatenate([tail, x.reshape(C * 2, B)], axis=-1)
        y = _conv_valid(xx, taps)[..., :B].reshape(C, 2, B)
        return y.astype(x.dtype), xx[:, -(K - 1):]

    def stage_demod(x, tail):
        # restart-per-microbatch with a block-aligned tail: the estimator
        # state re-locks each microbatch (clock slips beyond ±ts/2 at a
        # seam are re-acquired, like any stream restart in the reference)
        xx = jnp.concatenate([tail, x], axis=-1)
        state = fsk_init_state(cfg, x.shape[0])
        state = jax.tree.map(
            lambda a: jax.lax.pcast(a, (STAGE_AXIS,), to="varying"),
            state)
        _, outs = _fsk_demod_scan(cfg, xx, state, nb)
        soft = jnp.transpose(outs["soft"], (1, 0, 2)).reshape(
            x.shape[0], -1)
        bits = jnp.transpose(outs["bits"], (1, 0, 2)).reshape(
            x.shape[0], -1).astype(jnp.float32)
        # pack [C, nsym_mb] soft + bits into the uniform [C, 2, B] block
        out = jnp.zeros_like(x)
        out = out.at[:, 0, :soft.shape[1]].set(soft)
        out = out.at[:, 1, :bits.shape[1]].set(bits)
        return out, xx[:, :, -tail_len:]

    carry_init = [
        jnp.zeros((channels, 2, 1), jnp.float32),
        jnp.zeros((channels * 2, K - 1), jnp.float32),
        jnp.zeros((channels, 2, tail_len), jnp.float32),
    ]

    def run(xs):
        ys = pipeline_parallel(mesh, [stage_dc, stage_fir, stage_demod],
                               carry_init, xs)
        soft = ys[:, :, 0, :nsym_mb]
        bits = ys[:, :, 1, :nsym_mb].astype(jnp.uint8)
        return soft, bits

    return run
