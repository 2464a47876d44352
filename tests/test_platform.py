"""libtsd_jax.platform (engine choice, compile cache) and
libtsd_jax.struct (the blocks' pytree base)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from libtsd_jax import platform, struct

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_on_gpu_false_on_cpu():
    assert jax.default_backend() == "cpu"
    assert platform.on_gpu() is False


@pytest.mark.parametrize("env", [None, "custom"])
def test_compile_cache_dir(env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    .jax_cache/ at the checkout root.  Run in a child so the setting
    does not leak into this process."""
    e = {k: v for k, v in os.environ.items()
         if k != "JAX_COMPILATION_CACHE_DIR"}
    e["JAX_PLATFORMS"] = "cpu"
    e["PYTHONPATH"] = REPO
    if env:
        e["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env)
    code = ("import jax; from libtsd_jax.platform import "
            "enable_compile_cache as f; print(f()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=e, text=True,
                         capture_output=True, check=True,
                         timeout=120).stdout.split()
    want = (str(tmp_path / env) if env
            else os.path.join(REPO, ".jax_cache"))
    assert out[0] == want
    assert out[1] == want


def test_library_import_sets_no_cache():
    e = {k: v for k, v in os.environ.items()
         if k != "JAX_COMPILATION_CACHE_DIR"}
    e["JAX_PLATFORMS"] = "cpu"
    e["PYTHONPATH"] = REPO
    code = ("import jax, libtsd_jax, libtsd_jax.ops, libtsd_jax.models, "
            "libtsd_jax.parallel; print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=e, text=True,
                         capture_output=True, check=True, timeout=120)
    assert out.stdout.strip() == "None"


class _Node(struct.PyTreeNode):
    a: jax.Array
    k: int = struct.field(pytree_node=False, default=3)


def test_pytree_node_leaves_and_static_fields():
    n = _Node(a=jnp.ones(2))
    leaves, tdef = jax.tree_util.tree_flatten(n)
    assert len(leaves) == 1 and n.k == 3
    m = jax.tree_util.tree_unflatten(tdef, [jnp.zeros(2)])
    assert isinstance(m, _Node) and m.k == 3
    # static fields are part of the jit cache key, never traced
    f = jax.jit(lambda v: v.a * v.k)
    assert float(f(n)[0]) == 3.0
    assert float(f(n.replace(k=5))[0]) == 5.0


def test_pytree_node_is_frozen_with_replace():
    n = _Node(a=jnp.ones(2))
    with pytest.raises(dataclasses.FrozenInstanceError):
        n.k = 4
    m = n.replace(a=jnp.zeros(2))
    assert m.k == 3 and float(m.a[0]) == 0.0 and float(n.a[0]) == 1.0
