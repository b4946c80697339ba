"""Test configuration: run all tests on a virtual 8-device CPU mesh.

Must set env vars before jax is imported anywhere (SURVEY.md §4.4).
"""

import os

# Hard override: the surrounding environment may pin JAX_PLATFORMS to a
# remote TPU backend; unit tests must run on a local virtual CPU mesh.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(42)


SAMPLE_DATA = "/root/reference/sample-data/qm9/sample-splits"


def has_sample_data() -> bool:
    return os.path.exists(os.path.join(SAMPLE_DATA, "val.csv"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (runs on the card, skips elsewhere)"
    )
