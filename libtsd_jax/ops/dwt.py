"""Discrete wavelet transform: Haar / Daubechies-4 / biorthogonal wavelets,
multi-level analysis/synthesis, 2-D image transform.

Parity: core/include/tsd/fourier/tod.hpp:28-131, core/src/fourier/tod.cc.

CONVENTIONS (two DWT modules, deliberately different):
* This module is the FILTER-BANK form (conv + dyadic down/up sampling,
  vectorizes on any device); `ops/lifting.py` is the LIFTING form that is
  golden-diffed against the reference binary.  Both are perfect
  reconstruction WITHIN themselves, but their subband coefficients are
  NOT interchangeable: the causal conv pairs (x[2m-1], x[2m]) where the
  lifting scheme pairs (x[2m], x[2m+1]) (measured: no shift/sign maps
  one to the other).  Never threshold with one and invert with the
  other.
* Coefficient ORDER also differs: dwt() returns [a_L, d_L, ..., d_1];
  lifting.lift_dwt() returns [d_1, ..., d_L, a_L] (the reference's
  in-place layout).
"""
from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["wavelet_filters", "dwt_level", "idwt_level", "dwt", "idwt",
           "dwt2", "idwt2"]


def wavelet_filters(name: str):
    """Return (dec_lo, dec_hi, rec_lo, rec_hi, shift) for
    'haar' | 'db4' | 'bior'.

    Conventions (verified for perfect reconstruction): analysis is
    convolution + even-phase downsampling; synthesis is CORRELATION of the
    zero-stuffed bands with (rec_lo, rec_hi), then a circular ``shift``.
    For orthogonal wavelets rec == dec and shift == 0.

    'db4' = 4-tap Daubechies (D4), matching the reference's "db4" lifting
    implementation (tod.cc:211+); 'bior' = CDF 5/3 (LeGall) biorthogonal
    pair standing in for the reference's bior-3.5 family.
    """
    if name == "haar":
        s = 1 / np.sqrt(2)
        lo = np.array([s, s])
        hi = np.array([s, -s])
        return lo, hi, lo, hi, 0
    if name in ("db4", "d4"):
        c = np.array([1 + np.sqrt(3), 3 + np.sqrt(3),
                      3 - np.sqrt(3), 1 - np.sqrt(3)]) / (4 * np.sqrt(2))
        lo = c
        hi = np.array([c[3], -c[2], c[1], -c[0]])
        return lo, hi, lo, hi, 0
    if name in ("bior", "legall", "cdf53"):
        dec_lo = np.array([-1, 2, 6, 2, -1]) / 8.0
        dec_hi = np.array([-1, 2, -1]) / 2.0
        rec_lo = np.array([0, 0, 1, 2, 1]) / 2.0
        rec_hi = np.array([-1, -2, 6, -2, -1]) / 8.0
        return dec_lo, dec_hi, rec_lo, rec_hi, 1
    raise ValueError(f"unknown wavelet {name!r}")


def _conv_periodic(x: jax.Array, h: np.ndarray) -> jax.Array:
    """Periodic convolution along the last axis (periodization boundary)."""
    K = len(h)
    out = jnp.zeros_like(x)
    for k in range(K):
        out = out + h[k] * jnp.roll(x, k, axis=-1)
    return out


def dwt_level(x: jax.Array, name: str = "haar"
              ) -> Tuple[jax.Array, jax.Array]:
    """One analysis level: returns (approx, detail), each half length
    (periodized)."""
    if x.shape[-1] % 2:
        raise ValueError(
            f"dwt needs an even length at every level (periodized "
            f"boundary); got n={x.shape[-1]}")
    lo, hi, _, _, _ = wavelet_filters(name)
    a = _conv_periodic(x, lo)[..., ::2]
    d = _conv_periodic(x, hi)[..., ::2]
    return a, d


def idwt_level(a: jax.Array, d: jax.Array, name: str = "haar") -> jax.Array:
    """One synthesis level (inverse of dwt_level)."""
    _, _, rec_lo, rec_hi, shift = wavelet_filters(name)
    n = a.shape[-1] * 2
    ua = jnp.zeros(a.shape[:-1] + (n,), a.dtype).at[..., ::2].set(a)
    ud = jnp.zeros(d.shape[:-1] + (n,), d.dtype).at[..., ::2].set(d)
    # synthesis: periodic correlation with reconstruction filters
    ya = jnp.zeros_like(ua)
    yd = jnp.zeros_like(ud)
    for k in range(len(rec_lo)):
        ya = ya + rec_lo[k] * jnp.roll(ua, -k, axis=-1)
    for k in range(len(rec_hi)):
        yd = yd + rec_hi[k] * jnp.roll(ud, -k, axis=-1)
    y = ya + yd
    return jnp.roll(y, shift, axis=-1) if shift else y


def dwt(x: jax.Array, name: str = "haar", levels: int = 1) -> List[jax.Array]:
    """Multi-level DWT: returns [a_L, d_L, d_{L-1}, ..., d_1] (parity:
    tod.cc dwt in-place layout, returned here as a coefficient list)."""
    if x.shape[-1] % (1 << levels):
        raise ValueError(
            f"dwt: n={x.shape[-1]} must be a multiple of 2^levels="
            f"{1 << levels} (each periodized level halves the length)")
    coeffs = []
    a = x
    for _ in range(levels):
        a, d = dwt_level(a, name)
        coeffs.append(d)
    return [a] + coeffs[::-1]


def idwt(coeffs: List[jax.Array], name: str = "haar") -> jax.Array:
    """Inverse multi-level DWT."""
    a = coeffs[0]
    for d in coeffs[1:]:
        a = idwt_level(a, d, name)
    return a


def dwt2(img: jax.Array, name: str = "haar"
         ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One-level 2-D DWT: returns (LL, LH, HL, HH) (parity: 2-D image
    wavelets, tod.cc:500-560)."""
    a, d = dwt_level(img, name)                     # along columns (last axis)
    aT, dT = a.swapaxes(-1, -2), d.swapaxes(-1, -2)
    ll, lh = dwt_level(aT, name)
    hl, hh = dwt_level(dT, name)
    return (ll.swapaxes(-1, -2), lh.swapaxes(-1, -2),
            hl.swapaxes(-1, -2), hh.swapaxes(-1, -2))


def idwt2(ll, lh, hl, hh, name: str = "haar") -> jax.Array:
    a = idwt_level(ll.swapaxes(-1, -2), lh.swapaxes(-1, -2), name
                   ).swapaxes(-1, -2)
    d = idwt_level(hl.swapaxes(-1, -2), hh.swapaxes(-1, -2), name
                   ).swapaxes(-1, -2)
    return idwt_level(a, d, name)
