"""Test configuration: the JAX CPU backend with 8 virtual devices.

Multi-device sharding paths (mesh/pjit/shard_map) are exercised on a
virtual 8-device CPU mesh.  The suite runs on the CPU unless JAX_PLATFORMS
names another platform: ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``
runs the tests that need the card.  Must run before jax is imported
anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persist compiled executables across suite runs (the distributed-EQ and
# two-process dryrun compiles dominate the wall; a warm cache cuts them to
# disk reads).  Same mechanism and directory as the product
# (utils.profiling.enable_compilation_cache): executables are keyed by
# backend, so CPU and GPU entries never collide.
from audio_raytracing_studio_tpu.utils.profiling import enable_compilation_cache

enable_compilation_cache()

import numpy as np
import pytest


@pytest.fixture
def gpu_devices():
    """The GPU devices, for tests marked ``gpu``; skips where there are none.

    Decided here, at run time, never at import or collection: every xdist
    worker must collect the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; this run's JAX platform is {devices[0].platform}")
    return devices


@pytest.fixture
def rng():
    return np.random.default_rng(0xA0D10)


@pytest.fixture
def tone48k(rng):
    """1.2 s, 48 kHz mono test tone with transient + noise content."""
    rate = 48000
    t = np.arange(int(1.2 * rate)) / rate
    x = (
        0.5 * np.sin(2 * np.pi * 440.0 * t)
        + 0.2 * np.sin(2 * np.pi * 3150.0 * t)
        + 0.05 * rng.standard_normal(t.shape)
    )
    x[: rate // 100] = 0.0
    x[rate // 2] = 0.9  # click transient
    return x.astype(np.float32), rate
