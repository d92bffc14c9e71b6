"""Test configuration: force CPU with a virtual 8-device mesh.

Must set env vars before jax is imported anywhere (the JAX analogue of a
fake multi-node backend; SURVEY.md section 4d).  Tests marked `gpu` need
an NVIDIA GPU and skip elsewhere; chip_smoke.py runs them on the card by
setting HELIOS_TEST_PLATFORM=gpu, which keeps the process on its GPU.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("HELIOS_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "gpu: runs compiled GPU kernels; needs an NVIDIA GPU "
        "(skipped elsewhere)")


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip `gpu`-marked tests unless JAX runs on a GPU (decided here, at
    run time, so every test worker collects the same tests)."""
    if (request.node.get_closest_marker("gpu") is not None
            and jax.default_backend() != "gpu"):
        pytest.skip(f"needs an NVIDIA GPU; JAX's backend is "
                    f"{jax.default_backend()!r}")
