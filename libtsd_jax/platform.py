"""The one place that decides what this platform runs.

* :func:`on_gpu` — True when JAX's default backend is a GPU.  Hand-written
  kernels (Pallas through Triton) run only there; every other backend
  takes the plain XLA version of the same operation.  Nothing derives
  Pallas interpret mode from the backend: interpret mode runs only when a
  caller (a test) asks for it explicitly.
* :func:`enable_compile_cache` — JAX's persistent compilation cache for
  scripts (``chip_smoke.py``, ``bench.py``, the examples).  Importing the
  library never sets it.
"""
from __future__ import annotations

import os
import subprocess

import jax

__all__ = ["on_gpu", "enable_compile_cache", "CACHE_DIR", "gpu_card"]

# fixed path inside the checkout (listed in .gitignore): the cache key
# includes the path, so it must not move between runs
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache")


def on_gpu() -> bool:
    """True when the default backend is a GPU (the kernels' platform)."""
    return jax.default_backend() == "gpu"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache goes to ``.jax_cache/`` at
    the root of the checkout."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR


def gpu_card() -> str:
    """The first card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"); every timing is printed beside
    it, since a card set below its maximum power runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
