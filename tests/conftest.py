"""Test configuration: an 8-device virtual CPU mesh, and the ``gpu`` marker.

Multi-device sharding paths (shard_map over a Mesh) are exercised on CPU
with 8 virtual devices, per the framework's test strategy (SURVEY.md §4): no
accelerator is needed to validate collective layouts.  Unless
``JAX_PLATFORMS`` names another backend, the tests run on the CPU.

Tests that need a GPU carry ``@pytest.mark.gpu`` and take the ``gpu_device``
fixture, which skips them when JAX's default device is not a GPU.  Run them
on a machine with a card with ``JAX_PLATFORMS=cuda python -m pytest tests
-m gpu``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: full-size-model tests (minutes on CPU)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped elsewhere (gpu_device fixture)")


@pytest.fixture()
def rng():
    """Function-scoped so every test sees the same draws it gets when run
    in isolation — a session-scoped stream made numeric-tolerance tests
    order-dependent (adding a test upstream shifted every later draw and
    could push a borderline int8 fast-path bound over its limit)."""
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices (run under tests/ conftest env)")
    return devs[:8]


@pytest.fixture()
def gpu_device():
    """The default GPU device; skips the test where there is none.  Decided
    here, at run time, never while test modules are collected."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device is {dev.platform})")
    return dev
