"""Global configuration and dtype policy for libtsd-jax.

Dtype policy: float32 / complex64 are the primary compute dtypes
(the reference uses float/cfloat throughout, e.g. Vecf/Veccf aliases in
core/include/tsd/tableau.hpp:1414-1445).  Design-time numerics (filter design,
analog prototypes, elliptic functions) run in float64 on host — they execute
once, outside jit (parity: core/src/filtrage/rii.cc runs in double).

Matrix units have no complex arithmetic; complex matmuls run on
(real, imag) planes (ops/filter_rt._cmatmul).
"""
from __future__ import annotations

import jax.numpy as jnp

real_dtype = jnp.float32
complex_dtype = jnp.complex64
int_dtype = jnp.int32
bool_dtype = jnp.bool_

# Design-time (host, one-shot) dtypes
design_real = "float64"
design_complex = "complex128"


def to_ri(x) -> "jnp.ndarray":
    """Pack a complex array into a real (2, ...) float32 array.

    Pytree LEAVES that are logically complex are stored in this
    (re, im)-planes form and unpacked with :func:`from_ri` inside the
    computation, so every stored and transferred leaf is real float32
    (one dtype for checkpoints and host transfers).  Whether the planes
    cost anything on the GPU is unmeasured (ROADMAP G2).
    """
    import jax.numpy as jnp
    import numpy as np
    if isinstance(x, np.ndarray) or np.isscalar(x):
        x = np.asarray(x)
        return jnp.asarray(np.stack([x.real.astype(np.float32),
                                     x.imag.astype(np.float32)]))
    return jnp.stack([jnp.real(x), jnp.imag(x)]).astype(real_dtype)


def from_ri(a) -> "jnp.ndarray":
    """Unpack (2, ...) float32 planes into complex64 (trace-safe)."""
    return (a[0] + 1j * a[1]).astype(complex_dtype)
