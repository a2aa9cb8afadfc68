"""Pipeline-parallel stage split (SURVEY §2.3 mandate): the systolic
microbatch schedule must equal serial stage composition exactly, and the
3-stage demod pipeline must decode a real frame stream."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from radiosonde_auto_rx_jax.parallel.pp import (
    make_stage_mesh, pipeline_parallel, make_pp_demod_pipeline)


def _needs(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")


def test_pipeline_equals_serial_composition():
    """Every microbatch flows through all S stages in order, carries
    persist per stage — output bit-identical to the serial loop."""
    _needs(4)
    mesh = make_stage_mesh(4)
    rng = np.random.default_rng(0)
    M, C, B = 6, 3, 32
    xs = jnp.asarray(rng.standard_normal((M, C, 2, B)), jnp.float32)

    # distinct affine stages with a running-sum carry each
    def mk(gain, bias):
        def fn(x, carry):
            y = gain * x + bias + 0.001 * carry
            return y, carry + jnp.sum(x)
        return fn

    params = [(1.5, 0.1), (0.8, -0.2), (1.1, 0.05), (0.9, 0.3)]
    fns = [mk(g, b) for g, b in params]
    carry0 = [jnp.float32(0)] * 4

    got = pipeline_parallel(mesh, fns, carry0, xs)

    # serial reference
    want = []
    carries = [jnp.float32(0)] * 4
    for m in range(M):
        y = xs[m]
        for s in range(4):
            y, carries[s] = fns[s](y, carries[s])
        want.append(y)
    want = jnp.stack(want)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_pp_demod_pipeline_decodes_rs41():
    """DC → IF FIR → demod across 3 stage devices decodes an RS41 frame
    stream end-to-end (stage state streams across microbatches)."""
    _needs(3)
    from radiosonde_auto_rx_jax.demod.fsk import FSKConfig
    from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn
    from radiosonde_auto_rx_jax.models.rs41 import RS41Decoder
    from radiosonde_auto_rx_jax.ops.fir import design_lowpass
    from tests.test_rs41 import _mkframe
    from radiosonde_auto_rx_jax.models.rs41 import frame_to_bits

    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=50,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    rng = np.random.default_rng(5)
    tx = np.concatenate(
        [rng.integers(0, 2, 400)] +
        [frame_to_bits(_mkframe(i)) for i in range(2)] +
        [rng.integers(0, 2, 700)]).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 4800, bt=0.5),
                  15.0, 48000, 4800)
    C = 2
    planes = np.stack([iq.real, iq.imag]).astype(np.float32)
    planes = np.repeat(planes[None], C, axis=0)        # [C, 2, T]

    t_mb = 12000
    M = planes.shape[-1] // t_mb
    xs = jnp.asarray(
        planes[:, :, :M * t_mb].reshape(C, 2, M, t_mb
                                        ).transpose(2, 0, 1, 3))

    mesh = make_stage_mesh(3)
    taps = design_lowpass(0.2, 25)
    run = make_pp_demod_pipeline(cfg, mesh, taps, channels=C, t_mb=t_mb)
    soft, bits = run(xs)
    assert soft.shape[0] == M and soft.shape[1] == C

    # stitch microbatches for channel 0 and decode frames
    stream_bits = np.asarray(bits[:, 0]).reshape(-1)
    stream_soft = np.asarray(soft[:, 0]).reshape(-1)
    telems = RS41Decoder().decode_bits(stream_bits, -stream_soft)
    assert telems, "PP pipeline produced no decodable frames"
    assert telems[0]["id"] == "S0930112"
