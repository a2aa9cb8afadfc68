"""Card-only checks.  They run ``chip_smoke.py`` in a child process with
no CPU override (one process on the card; this test process stays on
the CPU) and skip on machines without an NVIDIA GPU.  Run them on the
card with ``python -m pytest -m chip tests/``."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def gpu_env():
    """Environment for a child that may open the card; skips without
    one (decided here, at run time, never at import)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("no NVIDIA GPU on this machine")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.chip
def test_chip_smoke_on_card(gpu_env, tmp_path):
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"),
                        "--out", str(tmp_path)], cwd=REPO, env=gpu_env,
                       capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["ok"] is True and last["device"]["platform"] == "gpu"
