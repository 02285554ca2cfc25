"""Test configuration: an 8-device virtual CPU mesh, so the sharding tests run
without several accelerators.

The CPU is the default platform here (``jax.config.update`` rather than the
environment, which may be read before this file). Running with
``JAX_PLATFORMS`` set keeps that platform instead: the ``gpu``-marked tests
run on the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")
# tests compile many small programs; keep them out of the persistent cache
jax.config.update("jax_enable_compilation_cache", False)

import pathlib

import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session")
def fixtures():
    return FIXTURES


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided at run time)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (kernels as compiled for the card)")
    return jax.devices()[0]
