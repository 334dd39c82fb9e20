"""Root conftest: run the test-suite on the CPU, as a virtual 8-device mesh.

Sharding is validated on the CPU's virtual devices (SURVEY.md §4). Tests
marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on the card the same
checks run through ``python chip_smoke.py``.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips on other platforms)"
    )


@pytest.fixture(autouse=True)
def _skip_gpu_tests_off_gpu(request):
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
