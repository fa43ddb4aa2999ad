"""Test configuration: CPU by default, on a virtual 8-device CPU mesh.

XLA_FLAGS and JAX_PLATFORMS must be set before jax initializes its
backends, hence this conftest sets them first.  Tests marked ``gpu``
take the ``gpu_device`` fixture and skip unless JAX finds a GPU; run
them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(4664397)


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU (JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/ on the card)")
    return dev
