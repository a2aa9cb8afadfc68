"""Complex NCO mixing (frequency translation) without lookup tables.

The reference uses a LUT oscillator sized to the sample rate's divisors
(scan/dft_detect.c:1072-1101, demod/mod/demod_mod.c opt_iq=5).  Here the
rotation vector is computed directly on device; phase is reduced modulo 1
cycle *before* the 2*pi multiply so float32 stays accurate for block-local
time indices (see nco_phase).
"""

import jax
import jax.numpy as jnp


def nco_phase(freq_norm, n: int, t0=0.0) -> jnp.ndarray:
    """Phase (in cycles, wrapped to [0,1)) of an NCO at normalized frequency.

    freq_norm may be a traced scalar or [...]-shaped array of f/Fs values;
    returns phase cycles of shape [..., n].  Accuracy note: frac(k*t) in
    float32 is good to ~1e-4 cycles for |k*t| up to ~2^13, fine for
    block-local t (demod blocks are a few thousand samples).
    """
    t = jnp.arange(n, dtype=jnp.float32) + jnp.float32(t0)
    k = jnp.asarray(freq_norm, dtype=jnp.float32)
    ph = k[..., None] * t
    return ph - jnp.floor(ph)


def freq_shift(x: jnp.ndarray, freq_norm, t0=0.0) -> jnp.ndarray:
    """Multiply [..., T] IQ by exp(+j*2*pi*freq_norm*t):  S(t) -> S(t)*e^{j2πft}.

    To shift a signal *down* by f (move +f to DC) pass -f/Fs.
    """
    ph = nco_phase(freq_norm, x.shape[-1], t0)
    rot = jnp.exp(1j * (2.0 * jnp.pi) * ph).astype(jnp.complex64)
    return x * rot
