"""Test configuration: force JAX onto an 8-virtual-device CPU backend.

This is the JAX-native analogue of a fake multi-node backend: every
sharding/mesh test runs on 8 host devices without accelerator hardware
(SURVEY.md §4). Must set env vars before jax is imported anywhere;
spawned children (GUI/process-edition tests) inherit them.

Tests marked ``gpu`` need the card: the ``gpu_device`` fixture decides
at run time, never at import, so every xdist worker collects the same
tests. They skip here and run on the GPU host with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu`` (chip_smoke.py runs
them too, in its own process).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none."""
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run on the GPU host)")
    return gpus[0]
