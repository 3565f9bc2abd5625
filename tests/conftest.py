"""Test configuration: virtual 8-device CPU mesh + float64 for oracles.

Multi-device sharding is validated on a virtual CPU mesh; numerical oracles
(dense KKT solves, finite differences) want f64, so the tests run on the CPU
with x64 enabled and the library is exercised in both f32 and f64. The GPU
kernels run here in interpret mode.

Tests marked ``gpu`` need the card and skip here. Run them on a machine
with an NVIDIA GPU, leaving JAX on the GPU backend:

    DIFFMPC_GPU_TESTS=1 python -m pytest tests/ -m gpu
"""

import os

import pytest

# Must land before the CPU client is instantiated.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not os.environ.get("DIFFMPC_GPU_TESTS"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU: run with DIFFMPC_GPU_TESTS=1 on the card")
