"""DSP primitive ops, batched over a leading channel axis.

All ops take/return ``jnp`` arrays shaped ``[..., time]`` (complex64 for IQ,
float32 for audio/discriminator streams) and are jit/vmap/shard_map friendly:
static shapes, no data-dependent Python control flow.
"""

from radiosonde_auto_rx_jax.ops.windows import hann_periodic, hann_symmetric
from radiosonde_auto_rx_jax.ops.fir import (
    design_lowpass,
    fir_filter,
    fir_filter_streaming,
    decimate,
)
from radiosonde_auto_rx_jax.ops.mixer import freq_shift, nco_phase
from radiosonde_auto_rx_jax.ops.fm import fm_discriminate, iq_dc_removal
