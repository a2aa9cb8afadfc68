"""FM quadrature discriminator and IQ conditioning.

Reference formula (demod/mod/demod_mod.c:728,773 and scan/dft_detect.c):
    s_fm[t] = gain * arg( z[t] * conj(z[t-1]) ) / pi,   gain = 0.8
i.e. instantaneous frequency normalised to +/-1 at Nyquist, times 0.8.
Batched, one fused elementwise pass.
"""

import jax
import jax.numpy as jnp

FM_GAIN = 0.8  # reference demod/mod/demod_mod.c:22


def fm_discriminate(z: jnp.ndarray, gain: float = FM_GAIN) -> jnp.ndarray:
    """[..., T] complex IQ -> [..., T] float FM audio (first sample ~0)."""
    zprev = jnp.concatenate([z[..., :1], z[..., :-1]], axis=-1)
    w = z * jnp.conj(zprev)
    return (gain / jnp.pi) * jnp.arctan2(w.imag, w.real).astype(jnp.float32)


def fm_discriminate_planes(x: jnp.ndarray,
                           gain: float = FM_GAIN) -> jnp.ndarray:
    """[..., 2, T] re/im planes -> [..., T] float FM audio.

    Same discriminator as :func:`fm_discriminate` without materializing a
    complex array (the planes layout the device code consumes)."""
    re, im = x[..., 0, :], x[..., 1, :]
    rp = jnp.concatenate([re[..., :1], re[..., :-1]], axis=-1)
    ip = jnp.concatenate([im[..., :1], im[..., :-1]], axis=-1)
    wr = re * rp + im * ip
    wi = im * rp - re * ip
    return (gain / jnp.pi) * jnp.arctan2(wi, wr).astype(jnp.float32)


def fm_discriminate_planes_mixed(re, im, out_dtype):
    """FM discriminator on separate re/im rows with f32 arctan2 inputs
    and a caller-chosen output dtype — the exact numerics of the
    detector conditioning paths (f32 streams, or bf16 when forced).
    Shared by detect/scanner._condition and detect/prescreen (they
    previously carried identical closures)."""
    import numpy as np
    rp = jnp.concatenate([re[..., :1], re[..., :-1]], axis=-1)
    ip = jnp.concatenate([im[..., :1], im[..., :-1]], axis=-1)
    wr = re * rp + im * ip
    wi = im * rp - re * ip
    return ((FM_GAIN / np.pi) * jnp.arctan2(
        wi.astype(jnp.float32), wr.astype(jnp.float32))).astype(out_dtype)


def iq_dc_removal(z: jnp.ndarray, alpha: float | None = None) -> jnp.ndarray:
    """Remove the complex DC term over the block (the reference's iq_dec
    --dc / dft_detect --dc stage, scan/dft_detect.c:546-591 uses a 0.98
    leaky estimate; block-mean is the static-shape equivalent)."""
    dc = jnp.mean(z, axis=-1, keepdims=True)
    return z - 0.98 * dc


def dc_offset(z: jnp.ndarray) -> jnp.ndarray:
    """Block-mean DC term — doubles as a residual-carrier frequency estimate
    after FM discrimination (df = sr * dc / (2*FM_GAIN),
    reference demod/mod/demod_mod.c:298)."""
    return jnp.mean(z, axis=-1)
