"""FIR + framed 4096-point periodogram: the BASELINE metric chain.

``fir_periodogram4096(x, h)`` filters every channel of ``x`` with the
taps ``h`` (zero initial state, or the given history) and returns the
sum over consecutive 4096-sample frames of ``|DFT4096(frame)|^2`` — the
spectrometer front end of BASELINE configs 1/2 (256 taps, 4096 bins).

Two versions compute the same thing:

* :func:`fir_periodogram4096_plain` — XLA: the Toeplitz FIR of
  ``ops/filter_rt`` at full float32 precision, a real FFT, ``|X|^2``.
  It is the reference for the kernel and runs off the GPU.
* ``ops/pallas/chain.fir_periodogram4096_kernel`` — one fused Pallas
  (Triton) kernel on the GPU; neither the filtered signal nor its
  spectrum goes through device memory.

The choice is made from the platform (``libtsd_jax.platform.on_gpu``).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..platform import on_gpu
from .filter_rt import _fir_frames

__all__ = ["fir_periodogram4096", "fir_periodogram4096_plain"]

NFFT = 4096
_L = 128   # Toeplitz block of the plain FIR


def toeplitz_blocks(h: jax.Array, L: int) -> jax.Array:
    """(D, L, L) blocks G_d[m, i] = h[d*L + i - m], zero outside [0, K)
    (``filter_rt.fir_toeplitz_mats``, jit-safe in ``h``)."""
    K = h.shape[0]
    D = (K - 2) // L + 2
    m = np.arange(L)[:, None]
    i = np.arange(L)[None, :]
    idx = np.arange(D)[:, None, None] * L + i - m
    valid = (idx >= 0) & (idx < K)
    return jnp.where(valid, h[np.clip(idx, 0, K - 1)], 0.0)


def _history(x: jax.Array, K: int, hist: Optional[jax.Array]) -> jax.Array:
    if hist is None:
        return jnp.zeros(x.shape[:-1] + (K - 1,), jnp.float32)
    assert hist.shape == x.shape[:-1] + (K - 1,), hist.shape
    return hist.astype(jnp.float32)


@jax.jit
def fir_periodogram4096_plain(x: jax.Array, h: jax.Array,
                              hist: Optional[jax.Array] = None) -> jax.Array:
    """The chain in plain XLA.  x: (C, N), N a multiple of 4096, any real
    dtype; h: (K,) taps; hist: optional (C, K-1) input samples that
    precede x (None = zero state).  Returns (C, 4096) float32."""
    C, N = x.shape
    assert N % NFFT == 0, f"N must be a multiple of {NFFT}"
    h = jnp.asarray(h, jnp.float32)
    K = h.shape[0]
    G = toeplitz_blocks(h, _L)
    D = G.shape[0]
    pad = (D - 1) * _L - (K - 1)
    xe = jnp.concatenate([jnp.zeros((C, pad), jnp.float32),
                          _history(x, K, hist), x.astype(jnp.float32)],
                         axis=-1)
    y = _fir_frames(xe.reshape(C, -1, _L), G, "highest")
    X = jnp.fft.rfft(y.reshape(C, N // NFFT, NFFT), axis=-1)
    P = jnp.sum(X.real * X.real + X.imag * X.imag, axis=1)
    # real input: bins NFFT/2+1.. mirror bins NFFT/2-1..1
    return jnp.concatenate([P, P[:, -2:0:-1]], axis=-1)


def fir_periodogram4096(x: jax.Array, h: jax.Array,
                        hist: Optional[jax.Array] = None) -> jax.Array:
    """The chain (arguments as in :func:`fir_periodogram4096_plain`): the
    fused kernel on the GPU, the plain version elsewhere."""
    if not on_gpu():
        return fir_periodogram4096_plain(x, h, hist)
    from .pallas.chain import fir_periodogram4096_kernel
    h = jnp.asarray(h, jnp.float32)
    # the kernel leaves out frame 0, which needs the history: add it back
    first = fir_periodogram4096_plain(x[:, :NFFT], h, hist)
    return fir_periodogram4096_kernel(x, h) + first
