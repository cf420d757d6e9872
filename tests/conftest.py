"""Test harness config: run on a virtual 8-device CPU backend.

Tests run on CPU with 8 virtual devices (SURVEY.md section 4: multi-host
logic is exercised via --xla_force_host_platform_device_count), even where
a GPU is present; the on-device tier is tests_gpu/ (run through
``python chip_smoke.py`` or ``python -m pytest tests_gpu/``). The platform
is forced through jax.config as well as the env var, before any backend
initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
