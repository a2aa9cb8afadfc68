"""PER-vs-Eb/N0 harness: cliff position sanity + CSV CLI."""

import io

import pytest

from radiosonde_auto_rx_jax.tools import per_harness


def _point(sonde_type, ebno, n_frames):
    rows = per_harness.run_point(sonde_type, ebno, n_frames=n_frames)
    assert len(rows) == 1 and rows[0]["chain"] == "jax"
    return rows[0]


def test_rs41_per_cliff():
    """RS41 chain: clean at 12 dB, dead at 2 dB (the reference's chains
    fall over in the 10-16 dB generation range, test/README.md:35 —
    ours must hold the high side and fail the deep-noise side)."""
    hi = _point("RS41", 12.0, 5)
    lo = _point("RS41", 2.0, 5)
    assert hi["frames_rx"] >= 4, hi
    assert lo["frames_rx"] == 0, lo


def test_m10_per_cliff():
    hi = _point("M10", 16.0, 5)
    lo = _point("M10", 2.0, 5)
    assert hi["frames_rx"] >= 3, hi
    assert lo["frames_rx"] == 0, lo


def test_sweep_csv_cli(tmp_path):
    out = tmp_path / "per.csv"
    rc = per_harness.main(["--type", "RS41", "--ebno", "2:12:10",
                           "--frames", "3", "-o", str(out)])
    assert rc == 0
    lines = out.read_text().strip().splitlines()
    assert lines[0].startswith("type,chain,ebno_db")
    assert len(lines) == 3          # header + 2 points
    assert lines[1].startswith("RS41,jax,2.0,3,")


def test_lms6_per_cliff():
    """Viterbi+RS chain: decodes at 16 dB, dead in deep noise."""
    hi = _point("LMS6", 16.0, 4)
    lo = _point("LMS6", 0.0, 4)
    assert hi["frames_rx"] >= 3, hi
    assert lo["frames_rx"] == 0, lo


@pytest.mark.skipif(not per_harness._oracle(),
                    reason="reference unavailable")
def test_ref_overlay_exact_at_high_snr():
    """The reference chain decodes the identical noisy stream exactly at
    high Eb/N0 — the TX/RX accounting and the C-chain plumbing are both
    airtight before any PER comparison is made."""
    rows = per_harness.run_point("RS41", 18.0, n_frames=4,
                                 chains=("jax", "ref"))
    assert len(rows) == 2
    for r in rows:
        assert r["frames_rx"] == 4, rows


def test_mrz_per_cliff():
    hi = _point("MRZ", 14.0, 5)
    lo = _point("MRZ", 2.0, 5)
    assert hi["frames_rx"] >= 3, hi
    assert lo["frames_rx"] == 0, lo


def test_imet54_per_cliff():
    hi = _point("IMET54", 14.0, 5)
    lo = _point("IMET54", 2.0, 5)
    assert hi["frames_rx"] >= 3, hi
    assert lo["frames_rx"] == 0, lo


@pytest.mark.parametrize("sonde_type,hi_db", [
    ("M20", 14.0), ("MTS01", 16.0), ("WXR301", 17.0), ("WXRPN9", 17.0),
    ("RD94RD41", 14.0), ("MK2LMS", 16.0), ("IMET4", 24.0)])
def test_new_type_per_cliffs(sonde_type, hi_db):
    """Round-2 case additions: decode cleanly above the cliff, dead in
    deep noise (exact TX/RX accounting holds for every type)."""
    hi = _point(sonde_type, hi_db, 4)
    lo = _point(sonde_type, 2.0, 4)
    assert hi["frames_rx"] >= 3, hi
    assert lo["frames_rx"] == 0, lo


def test_rs92ngp_per_cliff():
    hi = _point("RS92NGP", 16.0, 4)
    lo = _point("RS92NGP", 2.0, 4)
    assert hi["frames_rx"] >= 3, hi
    assert lo["frames_rx"] == 0, lo
