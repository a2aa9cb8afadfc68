"""Per-stage timing of the station step at bench geometry.

Usage: ``python -m radiosonde_auto_rx_jax.tools.profile_station``

Times each device stage of the production dataflow (channelize → Welch
PSD → detector conditioning → template correlation → buffered FSK
demod) in isolation: reps are enqueued back-to-back and the trial ends
in ``block_until_ready`` (best of ``TRIALS``).  Whole-output ``.sum()``
wrappers can perturb XLA's fusion choices, so some stages' outputs are
consumed via a tiny slice instead.  Needs a GPU.
"""

import time

import jax
import jax.numpy as jnp

from radiosonde_auto_rx_jax.demod.fsk import (
    FSKConfig, fsk_init_state, fsk_num_blocks_buffered,
    _fsk_demod_scan_buffered)
from radiosonde_auto_rx_jax.detect.correlator import _correlate_peaks
from radiosonde_auto_rx_jax.detect.psd import _welch
from radiosonde_auto_rx_jax.detect.scanner import SondeDetector
from radiosonde_auto_rx_jax.ops.channelizer import _channelize, pfb_prototype

N_CHAN = 50
B = 10                      # captures per step
T_WIDE = 2_400_000          # 1 s per capture
DUTY = 0.2                  # detector duty cycle
CAP = 16                    # full-pass survivors (two-phase detect)
REPS = 20
TRIALS = 3


def _timeit(name, fn, *args, samples):
    j = jax.jit(fn)
    out = j(*args)
    jax.block_until_ready(out)
    best = 1e30
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        outs = [j(*args) for _ in range(REPS)]
        jax.block_until_ready(outs)
        best = min(best, (time.perf_counter() - t0) / REPS)
    print(f"{name:28s} {best*1e3:9.2f} ms   "
          f"{samples/best/1e6:9.1f} Msps-wide", flush=True)
    return best


def main():
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"profile_station needs a GPU; JAX found "
                         f"{d.platform!r}")
    print(f"device: {d.device_kind} x{len(jax.devices())}", flush=True)
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000,
                    tone_spacing=5000, freq_est_type=1)
    taps = jnp.asarray(pfb_prototype(N_CHAN))
    det = SondeDetector(48000)
    n_det = max(1, int(B * N_CHAN * DUTY))
    t_ch = T_WIDE // N_CHAN
    nb = fsk_num_blocks_buffered(cfg, t_ch)
    classes = [(bank, tuple(int(v) for v in lens))
               for _, _, _, bank, lens in det.classes]
    samples = B * T_WIDE

    wide = jax.random.normal(jax.random.key(1), (B, 2, T_WIDE), jnp.float32)
    C = B * N_CHAN
    chf = jax.jit(lambda w: jax.vmap(
        lambda x: _channelize(x, taps, N_CHAN))(w).reshape(C, 2, -1))(wide)

    _timeit("channelize", lambda w: jax.vmap(
        lambda x: _channelize(x, taps, N_CHAN))(w)[:, :, :, :8],
        wide, samples=samples)
    _timeit("welch_psd hop=4*nfft", lambda w: _welch(w, 2048, 8192),
            wide, samples=samples)
    _timeit("det_prescreen (duty chans)",
            lambda x: det.prescreen.scores(x),
            chf[:n_det], samples=samples)

    def full_pass(x):
        streams = det._condition(x)
        acc = jnp.float32(0)
        for fm, (bank, lens_t) in zip(streams, classes):
            val, ipk, dcpk, xm = _correlate_peaks(
                fm, bank.astype(fm.dtype), lens_t)
            acc = acc + val.max() + xm.sum()
        return acc

    _timeit(f"det_full_pass ({CAP} ch)", full_pass, chf[:CAP],
            samples=samples)

    def demod(chf):
        state = fsk_init_state(cfg, C)
        _, outs = _fsk_demod_scan_buffered(cfg, chf, state, nb)
        return outs["soft"].sum() + outs["bits"].astype(jnp.int32).sum()

    _timeit("fsk_demod(all channels)", demod, chf, samples=samples)


if __name__ == "__main__":
    main()
