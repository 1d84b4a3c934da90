"""Test configuration.

Tests run on the CPU, on a virtual 8-device mesh, so multi-device sharding
paths are exercised without a GPU (``python chip_smoke.py`` runs them on
the card). These env vars must be set before JAX is imported anywhere.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")

import jax  # noqa: E402,F401

from msm_we_tpu.utils import enable_compilation_cache  # noqa: E402

# Persistent compilation cache: repeat test runs skip XLA compiles
enable_compilation_cache()

import numpy as np  # noqa: E402,F401
import pytest  # noqa: E402,F401

RANDOM_SEED = 71
