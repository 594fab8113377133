"""Test harness configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding paths
(mesh + halo exchange + disparity sharding) are exercised without GPUs,
per SURVEY.md §4's strategy.  Must be set before jax imports.  A run that
sets JAX_PLATFORMS itself (e.g. JAX_PLATFORMS=cuda,cpu on a GPU host)
keeps it: the tests marked `gpu` then find the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none.  Decided here,
    at test time, never while a module is imported."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX has {devices[0].platform} devices")
    return devices[0]
