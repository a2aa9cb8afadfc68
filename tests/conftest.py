"""Test configuration: an 8-device virtual CPU mesh.

The tests run on the CPU backend (``jax_platforms=cpu``) with 8 virtual
devices, so multi-card shardings are validated here; tests that need a
GPU carry the ``chip`` marker and skip without one.  The config is also
updated directly in case jax was imported before this file.  The
persistent compilation cache stays off so test runs write nothing into
the checkout.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _bound_jax_executable_memory():
    """Release compiled executables at module boundaries.

    The full suite compiles thousands of XLA:CPU executables; keeping
    them all loaded eventually aborts the process inside
    ``backend_compile_and_load`` (native SIGSEGV/SIGABRT after ~350
    tests, no Python-level error).  Cross-module jit-cache hits are
    rare — each test file exercises its own kernels — so clearing per
    module costs little and bounds the live-executable footprint.
    """
    yield
    jax.clear_caches()
