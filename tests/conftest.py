"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding paths
are exercised without GPUs, and with x64 enabled so the exact-mode oracle
matches the reference's double-precision semantics.  Tests that need a
GPU carry the ``gpu`` marker and skip here; chip_smoke.py runs them on
the card.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402
from pathlib import Path  # noqa: E402

REF = Path("/root/reference")


@pytest.fixture
def gpu():
    """The GPU device for tests marked ``gpu``; skips without one (the
    check runs inside the test, never at collection time)."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return devs[0]


@pytest.fixture(scope="session")
def ref_example() -> Path:
    if not REF.exists():
        pytest.skip("reference checkout not available")
    return REF / "example"
