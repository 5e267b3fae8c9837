"""Test harness config.

Tests run on a virtual 8-device CPU mesh (multi-device sharding is
validated without GPUs) with x64 enabled so the f64 parity bar
(displacement L2 < 1e-6 vs the reference solvers) can be checked exactly.

Tests that need the card carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them here. Run them on a GPU machine
with ``MYC_TEST_GPU=1 python -m pytest tests/ -m gpu``.
"""

import os

# Select the platform through the CONFIG: the session then gets a virtual
# 8-device CPU mesh whatever JAX_PLATFORMS says, unless MYC_TEST_GPU asks
# for the card.
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

if not os.environ.get("MYC_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

from mycelium_tpu.utils import enable_compilation_cache  # noqa: E402

# persistent compilation cache: the suite is compile-dominated otherwise
enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend")

REFERENCE_RESULTS = "/root/reference/results"


def reference_dir(name: str) -> str:
    return os.path.join(REFERENCE_RESULTS, name)


@pytest.fixture
def ref_results():
    if not os.path.isdir(REFERENCE_RESULTS):
        pytest.skip("reference results archive not available")
    return REFERENCE_RESULTS


def load_ref_csv(path: str) -> np.ndarray:
    """Load a reference CSV with a header row as float64 (True/False cells
    are mapped to 1/0)."""
    import pandas as pd
    df = pd.read_csv(path)
    return df.to_numpy(dtype=np.float64)
