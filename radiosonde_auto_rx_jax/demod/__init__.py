"""Demodulators: block-parallel FSK/AFSK cores and bit/frame framing."""

from radiosonde_auto_rx_jax.demod.fsk import FSKConfig, FSKState, fsk_demod_stream
