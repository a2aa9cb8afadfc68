"""Process and start-up rules for running on a GPU: the compile cache
location, helper processes that must never open the card, and the
card-only entry points refusing to run without one."""

import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from radiosonde_auto_rx_jax.utils import compile_cache
from radiosonde_auto_rx_jax.utils.process import jax_cpu_children

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cache_dir_restored():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_checkout(monkeypatch, cache_dir_restored):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_compile_cache()
    assert got == str(REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got


def test_compile_cache_env_wins(monkeypatch, tmp_path, cache_dir_restored):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # the variable is JAX's own: no other path is set in code
    assert jax.config.jax_compilation_cache_dir is None


def _report_platform(q):
    import jax as child_jax
    q.put((os.environ.get("JAX_PLATFORMS"),
           child_jax.devices()[0].platform))


def test_cpu_children_run_jax_on_cpu(monkeypatch):
    """A child started under jax_cpu_children gets JAX_PLATFORMS=cpu even
    when the parent's environment names an accelerator, and the
    parent's environment is restored."""
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_report_platform, args=(q,))
    with jax_cpu_children():
        p.start()
    assert os.environ["JAX_PLATFORMS"] == "cuda"
    env, platform = q.get(timeout=120)
    p.join(timeout=30)
    assert not p.is_alive()
    assert (env, platform) == ("cpu", "cpu")


def test_frame_plane_workers_start_on_cpu(monkeypatch, tmp_path):
    """The decoder pool's workers inherit JAX_PLATFORMS=cpu: a decoder
    that imports JAX there can never reserve the card's memory."""
    from radiosonde_auto_rx_jax.station.frame_plane import FramePlane
    main = sys.modules["__main__"]
    if not os.path.exists(getattr(main, "__file__", None) or ""):
        # a `python -c` host (test workers): give spawn a main to re-run
        stub = tmp_path / "main_stub.py"
        stub.write_text("")
        monkeypatch.setattr(main, "__file__", str(stub), raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    fp = FramePlane(1)
    try:
        fp._ensure_started()
        pid = fp._procs[0].pid
        env = Path(f"/proc/{pid}/environ").read_bytes().split(b"\0")
        assert b"JAX_PLATFORMS=cpu" in env
        assert os.environ["JAX_PLATFORMS"] == "cuda"
    finally:
        fp.close()
    assert not fp._procs


def _run_without_gpu(cmd, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def _ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_gpu():
    r = _run_without_gpu([sys.executable, "chip_smoke.py"], REPO)
    assert r.returncode != 0
    assert not _ok_line(r.stdout)
    assert "no GPU" in r.stdout + r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the package beside it the script cannot pass either."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_without_gpu([sys.executable, "chip_smoke.py"], tmp_path)
    assert r.returncode != 0
    assert not _ok_line(r.stdout)


def test_bench_refuses_cpu():
    r = _run_without_gpu([sys.executable, "bench.py"], REPO)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert not r.stdout.strip()
