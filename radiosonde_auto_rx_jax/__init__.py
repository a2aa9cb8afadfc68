"""radiosonde_auto_rx_jax — a JAX software-radio framework on a GPU.

A from-scratch re-design of the capabilities of projecthorus/radiosonde_auto_rx
(the reference) as batched accelerator dataflow:

* The reference runs one OS process per pipe stage (rtl_fm | iq_dec | fsk_demod
  | rs41mod, see reference auto_rx/autorx/decode.py:1500-1529).  Here the whole
  signal path is a single jitted JAX dataflow over channel-batched tensors
  ``IQ[channels, time]``, sharded over a ``jax.sharding.Mesh`` with axes
  ``(channels, time)`` — channel data-parallelism plus overlap-save sequence
  parallelism with halo exchange.
* The reference's C DSP (codec2 fsk.c, demod_mod.c, dft_detect.c) is
  re-derived as block-parallel JAX algorithms, not translated.
* Frame-level decoding (ECC, parsers) is vectorized NumPy/JAX; telemetry JSON
  matches the reference schema (reference auto_rx/autorx/decode.py:59-109).

Layout:
    ops/        DSP primitives (FIR, PFB channelizer, FM discriminator, mixers,
                resampling).
    demod/      FSK/AFSK demodulators and bit/frame framing.
    ecc/        Galois-field ECC: Reed-Solomon, BCH, Hamming, CRC, Viterbi.
    models/     Per-sonde-family decoders (RS41, DFM, M10/M20, iMet, ...).
    detect/     Sonde-type detection (template correlation bank) + PSD scanning.
    parallel/   Mesh construction, shardings, halo exchange collectives.
    station/    Host-side control plane: config, task manager, scanner glue,
                checkpoint/resume, CLI main loop.
    sources/    SDR capture commands, IQ wire-format ingestion, KA9Q client.
    native/     C++ host runtime (ctypes): IQ conversion, SPSC fd-pump ring
                buffer, popcount header search.
    exporters/  Telemetry sinks (log files, SondeHub, APRS, OziMux, ...).
    web/        Status/telemetry web API + log analytics.
    tools/      PER-vs-Eb/N0 regression harness.
    utils/      Geometry, peak detection, probing, stats, sonde helpers.
"""

__version__ = "0.1.0"

# Telemetry fields required before a frame is passed to exporters
# (reference auto_rx/autorx/decode.py:88-96).
DECODER_REQUIRED_FIELDS = ["frame", "id", "datetime", "lat", "lon", "alt"]

# Defaults merged into telemetry when a decoder does not supply them
# (reference auto_rx/autorx/decode.py:99-107).
DECODER_OPTIONAL_FIELDS = {
    "temp": -273.0,
    "humidity": -1.0,
    "pressure": -1,
    "batt": -1,
    "vel_h": -9999.0,
    "vel_v": -9999.0,
    "heading": -9999.0,
}

# Sonde types the framework understands (reference auto_rx/autorx/decode.py:29-47).
VALID_SONDE_TYPES = [
    "RS92",
    "RS41",
    "DFM",
    "M10",
    "M20",
    "IMET",
    "IMET5",
    "MK2LMS",
    "LMS6",
    "MEISEI",
    "MRZ",
    "MTS01",
    "UDP",
    "WXR301",
    "WXRPN9",
    "RS92-NGP",
    "DROPSONDE",
]
