"""Test harness config: run the suite on a virtual 8-device CPU mesh.

Multi-device hardware is unavailable in CI; sharding tests use
``--xla_force_host_platform_device_count=8`` (SURVEY.md §4.6 — the
"fake backend" answer).  Must be set before jax is imported anywhere.

Tests that need the card carry the ``gpu`` marker and skip here (the
``gpu`` fixture decides).  They run on a GPU with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` — the only setting
of ``JAX_PLATFORMS`` that keeps this file off the CPU — and as a phase
of ``python chip_smoke.py``.
"""

import os

import pytest

_ON_GPU = any(p in os.environ.get("JAX_PLATFORMS", "").split(",")
              for p in ("cuda", "gpu"))

if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    # the CPU suite writes no persistent compilation cache (the CLI's
    # main() points one into the checkout)
    jax.config.update("jax_enable_compilation_cache", False)
jax.config.update("jax_enable_x64", False)  # production path is float32


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run: JAX_PLATFORMS=cuda pytest -m gpu)")


@pytest.fixture
def n_devices():
    """JAX's device count, read when a test runs (never at import, so
    every xdist worker collects the same tests)."""
    return len(jax.devices())
