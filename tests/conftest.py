"""Test configuration: force an 8-device virtual CPU mesh BEFORE any JAX
backend initializes.

This is the analog of multi-device testing without a cluster (SURVEY.md
§4 implication (e)): sharding/collective code paths run against
``--xla_force_host_platform_device_count=8`` on CPU. The platform is
pinned with ``jax.config.update`` as well as the environment, which
works as long as no backend has initialized yet. Tests that need a GPU
carry the ``gpu`` marker and skip here (tests/test_device.py).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
