"""Test config: JAX runs on a virtual 8-device CPU mesh so sharding tests
run without a GPU, unless JAX_PLATFORMS names another platform. The tests
marked `gpu` take the `gpu` fixture and run on a card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import pathlib

import pytest

DATA_DIR = pathlib.Path(__file__).parent / "data"


@pytest.fixture(scope="session")
def data_dir() -> pathlib.Path:
    return DATA_DIR


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
