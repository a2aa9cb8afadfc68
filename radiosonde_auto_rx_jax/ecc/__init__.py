"""Galois-field ECC: Reed-Solomon, BCH, Hamming, CRC, Viterbi.

Codes used by the sonde families (reference demod/mod/bch_ecc_mod.c:11-36):
  RS(255,231) t=12, GF(2^8) f=0x11D, b=0, p=1      — RS41, RS92
  RS(255,223) t=16, GF(2^8) f=0x187, b=112, p=11   — LMS6 (CCSDS)
  bin-BCH(63,51) t=2, GF(2^6) f=0x43               — Meisei
  Hamming(8,4)                                      — DFM, iMet-54, MRZ
  CRC16-CCITT                                       — framing checks
  K=7 r=1/2 convolutional + Viterbi                 — LMS6

All decoders are batch-vectorized NumPy (host frame plane); the
Berlekamp-Massey formulation has a fixed iteration count so the same code
vmaps onto device if frame rates ever warrant it.
"""

from radiosonde_auto_rx_jax.ecc.gf import GF
from radiosonde_auto_rx_jax.ecc.rs import RSCode, RS255_231, RS255_223_CCSDS
from radiosonde_auto_rx_jax.ecc.crc import crc16_ccitt
