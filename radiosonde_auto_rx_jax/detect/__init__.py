"""Sonde-type detection: matched-filter template bank + PSD scanning.

Replaces the reference's dft_detect (reference scan/dft_detect.c): instead
of per-K-block radix-2 DFT + per-type spectral multiply + IDFT
(dft_detect.c getCorrDFT :357-443), the whole template bank correlates
against the whole FM stream in ONE batched convolution
``[C,1,T] ⊛ [Ntypes,1,Lmax]``, and every
channel of a channelized wideband capture is scanned in the same pass.
"""

from radiosonde_auto_rx_jax.detect.templates import (
    TEMPLATES, TemplateSpec, build_template_bank)
from radiosonde_auto_rx_jax.detect.correlator import (
    correlate_bank, detect_types, Detection)
from radiosonde_auto_rx_jax.detect.psd import (
    power_spectrum, detect_peaks, scan_peaks)
