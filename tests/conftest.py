"""Test configuration.

An explicit JAX_PLATFORMS wins (``JAX_PLATFORMS=cuda`` runs the
``gpu``-marked tests on the card); unset, the tests run on the CPU with
8 virtual devices so that multi-device sharding paths compile and
execute without accelerator hardware."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.RandomState(42)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda")
    return devices[0]
