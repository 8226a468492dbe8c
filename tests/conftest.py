"""Test configuration: run on CPU with 8 virtual devices and float64.

Correctness tests use the CPU backend (x64 for conformance with the
reference's double precision); multi-device sharding tests use the 8
virtual devices.  Tests that need a GPU carry the ``gpu`` marker and skip
here; ``chip_smoke.py`` runs the same paths on the card.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# config updates win over an environment that imported jax before this
# file ran
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from faspsolver_tpu.utils.runtime import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFDATA = "/root/reference/data"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on the CPU backend")


@pytest.fixture
def gpu():
    """Skip the calling test unless JAX's default backend is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs this path on the card")


@pytest.fixture(scope="session")
def refdata():
    if not os.path.isdir(REFDATA):
        pytest.skip("reference data not available")
    return REFDATA
