"""Library-surface drive (verify skill recipe): demod a synthesized GFSK
signal through the public API and bound BER; edge cases stay finite."""
import numpy as np
from radiosonde_auto_rx_jax.demod import FSKConfig, fsk_demod_stream
from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn


def _ber(tx, bits, skip=600):
    """Best BER over small alignment offsets and both polarities."""
    tx = np.asarray(tx, np.int8)
    bits = np.asarray(bits, np.int8).ravel()
    best = 0.5
    for off in range(0, 64):
        m = min(len(tx) - off, len(bits)) - skip
        if m < 1000:
            continue
        agree = np.mean(tx[off + skip:off + skip + m]
                        == bits[skip:skip + m])
        best = min(best, 1 - max(agree, 1 - agree))
    return best


def test_drive():
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=300,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    rng = np.random.default_rng(7)
    tx = rng.integers(0, 2, 12000)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 1700, 4800, bt=0.5),
                  10.0, 48000, 4800)
    soft, bits, stats, _ = fsk_demod_stream(cfg, iq)
    assert _ber(tx, np.asarray(bits)) < 0.01

    # batched run must equal per-channel
    _, bits2, _, _ = fsk_demod_stream(cfg, np.stack([iq, iq]))
    assert np.array_equal(np.asarray(bits2)[0], np.asarray(bits2)[1])
    assert np.array_equal(np.asarray(bits2)[0], np.asarray(bits).ravel())

    # frequency-offset robustness: 2 kHz off-tune
    iqo = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 2000, 4800, bt=0.5),
                   10.0, 48000, 4800)
    _, bo, _, _ = fsk_demod_stream(cfg, iqo)
    assert _ber(tx, np.asarray(bo), skip=2400) < 0.02

    # silence: outputs finite, EbN0 floor
    s, b, st, _ = fsk_demod_stream(cfg, np.zeros(48000, np.complex64))
    assert np.isfinite(np.asarray(s)).all()
    assert float(np.asarray(st["ebno_db"]).max()) <= -5.9

    # short input (< one block): empty outputs, no crash
    s, b, st, _ = fsk_demod_stream(cfg, np.zeros(1000, np.complex64))
    assert np.asarray(b).size == 0 or np.asarray(b).shape[-1] == 0
