"""Shared multi-sonde wideband fixture for station-step tests.

Deterministic (seeded) so separate OS processes can rebuild IDENTICAL
captures without IPC: used by tests/test_station_step.py (virtual
8-device mesh in one process) and tests/multiproc_worker.py (real
2-process jax.distributed mesh).  Four sondes across four captures:
RS41 (48 kHz direct expert), M20 (lookalike whose idle cross-fires the
WXR template — exercises the full-rate confirmation), DFM (50 kHz
resampled expert) and M10 (48.08 kHz resampled expert).
"""

import numpy as np

from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod
from radiosonde_auto_rx_jax.ops.channelizer import channel_freqs
from radiosonde_auto_rx_jax.tools.synth import (  # noqa: F401
    dfm_bits, m10_bits, m20_bits, rs41_bits, taper)

N_CHAN = 16
FS_WIDE = 768_000
B = 4                     # captures (one per ch shard on the 4x2 mesh)
T_WIDE = 2_304_000        # 3 s -> 144000 channel samples (t-shards must
                          # hold the demod halo incl. frame margin; DFM
                          # needs >= 2 full 1.12 s cycles to decode)
RS41_CAP, RS41_CH = 0, 5
M20_CAP, M20_CH = 3, 9
DFM_CAP, DFM_CH = 1, 4    # resampled expert (48 kHz -> 50 kHz)
M10_CAP, M10_CH = 2, 11   # resampled expert (48 kHz -> 48.08 kHz)


def make_wide_captures(ts=None):
    """[B, 2, T_WIDE] f32 planes with the four sondes keyed up.

    The RS41 frames carry GPS week/ToW derived from ``ts`` (unix
    seconds; default: build time).  Runs that must build IDENTICAL
    captures in separate OS processes (the jax.distributed multiproc
    test) pass one shared ``ts`` so the payload bits do not depend on
    when each process gets around to building the fixture.
    """
    rng = np.random.default_rng(7)
    freqs = channel_freqs(N_CHAN, FS_WIDE)
    wide = (rng.standard_normal((B, T_WIDE)) +
            1j * rng.standard_normal((B, T_WIDE))
            ).astype(np.complex64) * 0.002
    rs41 = taper(gfsk_mod(rs41_bits(rng, ts), FS_WIDE, 4800, 2,
                          freqs[RS41_CH], 4800, bt=0.5)[:T_WIDE])
    wide[RS41_CAP, :len(rs41)] += rs41
    m20 = taper(gfsk_mod(m20_bits(rng), FS_WIDE, 9600, 2,
                         freqs[M20_CH], 9600, bt=1.0)[:T_WIDE])
    wide[M20_CAP, :len(m20)] += m20
    dfm = taper(gfsk_mod(dfm_bits(rng), FS_WIDE, 2500, 2,
                         freqs[DFM_CH], 5000, bt=0.5)[:T_WIDE])
    wide[DFM_CAP, :len(dfm)] += dfm
    m10 = taper(gfsk_mod(m10_bits(rng), FS_WIDE, 9616, 2,
                         freqs[M10_CH], 10000, bt=1.0)[:T_WIDE])
    wide[M10_CAP, :len(m10)] += m10
    return np.stack([wide.real, wide.imag], axis=1).astype(np.float32)
