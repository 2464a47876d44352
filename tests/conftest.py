"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device sharding logic is validated without several GPUs by forcing
the host platform to expose 8 virtual devices (SURVEY §4: the fake-backend
equivalent the reference never needed).  Must run before jax is imported.
Tests that need the GPU are marked ``gpu`` and skip here (tests/test_gpu.py).
"""
import os

# the environment variable covers a fresh interpreter; jax.config.update
# below also covers a jax imported earlier (e.g. by a plugin)
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
