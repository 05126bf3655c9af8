"""Test configuration: JAX on a virtual 8-device CPU mesh.

Unit and parity tests are hermetic and exercise the multi-device sharding
path on host, per SURVEY.md section 4 (multi-node analog).  Tests marked
`gpu` need an NVIDIA GPU: the `gpu` fixture decides at run time whether one
is attached and skips otherwise.  On a machine with the card they run with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

(an explicit JAX_PLATFORMS is kept; unset, the suite runs on the CPU).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

from pathlib import Path

import numpy as np
import pytest

from basisu_rs_jax.utils.compile_cache import configure

configure()

FIXTURES = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session")
def golden():
    return np.load(FIXTURES / "golden_blocks.npz")


@pytest.fixture
def gpu():
    """The attached NVIDIA GPU; skips the test when JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX default device: {dev.platform})")
    return dev
