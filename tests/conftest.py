"""Test configuration: an 8-device virtual CPU platform.

Multi-device sharding is validated on a virtual CPU mesh; single-device
numerics use the plain XLA formulations the backend policy picks on the
CPU (``radiorust_tpu.backend``).

Tests that need the card carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips when JAX has no GPU.  They run on
the card with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``;
any ``JAX_PLATFORMS`` without a GPU platform (the default) keeps the
suite on the CPU.
"""

import os

import pytest

xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()
_platforms = os.environ.get("JAX_PLATFORMS", "")
if not any(p in _platforms for p in ("cuda", "gpu")):
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX finds none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run on the card: "
                    "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)")
