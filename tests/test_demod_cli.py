"""fsk_demod CLI equivalent: stream chunking, soft output, stats JSON."""

import io
import json

import numpy as np
import jax.numpy as jnp

from radiosonde_auto_rx_jax.demod import cli
from radiosonde_auto_rx_jax.demod.fsk import FSKConfig
from radiosonde_auto_rx_jax.demod import fsk_demod_stream
from radiosonde_auto_rx_jax.demod.modulate import gfsk_mod, add_awgn


def _iq_cs16(rng, nbits=4000, fs=48000, rs=4800, spacing=5000, ebno=14.0):
    tx = rng.integers(0, 2, nbits).astype(np.uint8)
    iq = add_awgn(gfsk_mod(tx, fs, rs, 2, 0.0, spacing), ebno, fs, rs)
    w = np.empty(2 * len(iq), np.int16)
    w[0::2] = np.clip(iq.real * 16000, -32768, 32767).astype(np.int16)
    w[1::2] = np.clip(iq.imag * 16000, -32768, 32767).astype(np.int16)
    return tx, iq, w.tobytes()


def _ber(rx, tx, search=96):
    """Best BER over tx/rx alignments: the demod starts emitting ~one
    window (nmem ~= 52 symbols) into the stream, so search tx offsets."""
    best = 1.0
    for off in range(search):
        n = min(len(rx), len(tx) - off)
        if n <= 100:
            continue
        best = min(best, float(np.mean(rx[:n] != tx[off:off + n])))
    return best


def test_cli_soft_output_decodes(rng):
    tx, iq, wire = _iq_cs16(rng)
    out = io.BytesIO()
    err = io.StringIO()
    args = cli.parse_args(["-p", "5", "--nsym", "50", "-b", "-5000",
                           "-u", "5000", "--mask", "5000", "--stats=5",
                           "2", "48000", "4800", "-", "-"])
    rc = cli.run(args, stdin=io.BytesIO(wire), stdout=out, stderr=err)
    assert rc == 0
    soft = np.frombuffer(out.getvalue(), np.float32)
    assert len(soft) > 0.9 * len(tx)
    bits = (soft < 0).astype(np.uint8)          # soft + => bit 0
    assert _ber(bits, tx) < 0.01
    lines = [json.loads(ln) for ln in err.getvalue().splitlines()]
    assert lines, "no stats emitted"
    assert {"EbNodB", "ppm", "f1_est", "f2_est"} <= set(lines[-1])
    assert lines[-1]["EbNodB"] > 5


def test_cli_hardout_and_invert(rng):
    tx, iq, wire = _iq_cs16(rng, nbits=2500)
    out = io.BytesIO()
    args = cli.parse_args(["-p", "5", "--nsym", "50", "-b", "-5000",
                           "-u", "5000", "--mask", "5000", "--hardout",
                           "-i", "2", "48000", "4800", "-", "-"])
    cli.run(args, stdin=io.BytesIO(wire), stdout=out, stderr=io.StringIO())
    bits = np.frombuffer(out.getvalue(), np.uint8)
    # -i inverts: hard bits now match tx polarity flipped back
    assert _ber(1 - bits, tx) < 0.01


def test_cli_streaming_matches_batch(rng):
    """Chunked CLI demod == one-shot fsk_demod_stream on the same IQ."""
    tx, iq, wire = _iq_cs16(rng, nbits=6000)
    cfg = FSKConfig(fs=48000, rs=4800, m=2, p=5, nsym=50,
                    est_min=-5000, est_max=5000, tone_spacing=5000,
                    freq_est_type=1)
    # the CLI streams the plain scan (its chunked ptr/tail bookkeeping
    # carries exact clock state across chunks; the buffered scan is the
    # default for the batch/station/sharded perf paths)
    _, bits_batch, _, _ = fsk_demod_stream(cfg, jnp.asarray(iq),
                                           buffered=False)
    bits_batch = np.asarray(bits_batch)
    out = io.BytesIO()
    args = cli.parse_args(["-p", "5", "--nsym", "50", "-b", "-5000",
                           "-u", "5000", "--mask", "5000", "--hardout",
                           "2", "48000", "4800", "-", "-"])
    cli.run(args, stdin=io.BytesIO(wire), stdout=out, stderr=io.StringIO())
    bits_cli = np.frombuffer(out.getvalue(), np.uint8)
    n = min(len(bits_cli), len(bits_batch))
    assert n > 0.8 * len(bits_batch)
    # identical demod path; cs16 quantization may flip the odd soft-zero bit
    assert np.mean(bits_cli[:n] != bits_batch[:n]) < 0.005


def test_cli_testframes_ber(rng):
    """--testframes: known PRBS frames through the demod report ~0 BER
    (reference fsk_demod.c:318-357 self-test mode)."""
    tx = np.tile(cli.test_frame_bits(), 40)
    iq = add_awgn(gfsk_mod(tx, 48000, 4800, 2, 0.0, 5000), 14.0,
                  48000, 4800, rng=rng)
    cs16 = np.empty(2 * len(iq), np.int16)
    cs16[0::2] = np.clip(iq.real * 16384, -32767, 32767)
    cs16[1::2] = np.clip(iq.imag * 16384, -32767, 32767)
    out, err = io.BytesIO(), io.StringIO()
    args = cli.parse_args(["-b", "-5000", "-u", "5000", "--mask", "5000",
                           "-p", "5", "--testframes", "2", "48000",
                           "4800", "-", "-"])
    cli.run(args, stdin=io.BytesIO(cs16.tobytes()), stdout=out,
            stderr=err)
    lines = [l for l in err.getvalue().splitlines() if "FSK BER" in l]
    assert len(lines) >= 20, f"frames synced: {len(lines)}"
    # final cumulative BER must be tiny
    last = lines[-1]
    ber = float(last.split("FSK BER")[1].split(",")[0])
    assert ber < 0.01, last


def test_test_frame_matches_reference_generator():
    """The PRBS frame is bit-identical to the reference's
    fsk_get_test_bits (srand(158324) glibc sequence)."""
    import subprocess, tempfile, os
    from tests import oracle
    if not oracle.available():
        import pytest
        pytest.skip("no compiler/reference")
    d = tempfile.mkdtemp()
    open(os.path.join(d, "t.c"), "w").write(
        '#include <stdio.h>\n#include <stdlib.h>\n'
        'int main(){srand(158324);for(int i=0;i<100;i++)'
        'printf("%d",rand()&1);return 0;}')
    subprocess.run(f"gcc {d}/t.c -o {d}/t", shell=True, check=True)
    ref = subprocess.run(f"{d}/t", shell=True,
                         capture_output=True).stdout.decode()
    mine = "".join(str(int(b)) for b in cli.test_frame_bits())
    assert ref == mine
