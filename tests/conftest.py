"""Test configuration: run the suite on a virtual 8-device CPU mesh so
sharding/collective paths execute without TPU hardware (SURVEY.md §4).

Note: the hosted TPU platform plugin ignores the ``JAX_PLATFORMS`` env var,
so we must force CPU through ``jax.config`` before any device is touched.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


import numpy as _np
import pytest as _pytest


@_pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between modules.  A full one-process suite
    run accumulates hundreds of XLA:CPU programs and eventually segfaults
    inside backend_compile_and_load on a later large compile (reproduced
    at tests/test_mesh_product.py:466 after ~230 tests, jax 0.9); dropping
    the executable caches at module boundaries keeps the compiler's
    resident state bounded."""
    yield
    jax.clear_caches()


@_pytest.fixture(autouse=True)
def _deterministic_layer_init():
    """Model construction draws from a module-global RNG
    (nn.layers._INIT_RNG), so weights depend on how many models earlier
    tests built.  Reseed per test: every test sees the same weights whether
    run solo or mid-suite (two weight-sensitive tests flaked on suite
    order before this)."""
    import mlx_audio_tpu.nn.layers as _layers

    _layers._INIT_RNG = _np.random.default_rng(0)
    yield


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: runs the port's CUDA kernels on an NVIDIA GPU; skips without one",
    )
