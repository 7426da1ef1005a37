"""Test configuration: an 8-device virtual CPU mesh, set before jax import.

Multi-chip sharding is validated on a host-platform device mesh
(xla_force_host_platform_device_count), per the multi-chip test strategy in
SURVEY.md §4/§5.
"""

import os

# The suite runs on the CPU backend with 8 virtual devices. The card-only
# tests (marker `gpu`) run on the GPU inside `chip_smoke.py`, which sets
# HS_GPU_TESTS=1 so that this file leaves its already-open GPU backend alone.
if os.environ.get("HS_GPU_TESTS") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
