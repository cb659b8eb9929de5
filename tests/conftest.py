"""Test environment: JAX on the CPU with 8 virtual devices, unless the
caller picks a platform with JAX_PLATFORMS.

Multi-device logic is tested on a forced 8-device CPU mesh (SURVEY.md §4).
Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them when JAX finds none; run them on a GPU machine
with ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.

This must run before the first ``import jax`` anywhere in the test session.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()


@pytest.fixture(scope="session")
def gpu():
    """The jax module, when its default backend is a GPU; skips otherwise."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU (JAX backend is {jax.default_backend()!r})")
    return jax


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU")
    config.addinivalue_line("markers", "slow: long-running acceptance test")
