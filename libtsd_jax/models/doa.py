"""Direction of arrival: steering vectors, sensor covariance, 1-D MUSIC.

Parity: core/src/apps/doa.cc:17-84, core/include/tsd/apps/doa.hpp:25-48.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import complex_dtype, real_dtype
from .stats import subspace_spectrum

__all__ = ["steervec_1d", "sensorcov_1d", "musicdoa_1d",
           "spatial_smoothing", "capon_spectrum", "capondoa_1d"]


def steervec_1d(pos: jax.Array, angle: jax.Array) -> jax.Array:
    """Steering matrix A[i, j] = exp(i * pos_i * cos(angle_j)) for a linear
    array; pos in radians-per-wavelength units (parity: steervec_1d,
    stats.cc:258-268)."""
    pos = jnp.asarray(pos, real_dtype)
    angle = jnp.asarray(angle, real_dtype)
    return jnp.exp(1j * pos[:, None] * jnp.cos(angle)[None, :]).astype(
        complex_dtype)


def sensorcov_1d(pos: jax.Array, angle: jax.Array,
                 snr_db: float = 20.0) -> jax.Array:
    """Ideal sensor covariance R = A A^H + sigma^2 I for unit-power sources
    (parity: sensorcov_1d, stats.cc:270-281 — note the reference adds
    db2pow(SNR) * I; we add the NOISE power 10^(-snr/10) * I, which is the
    physically meaningful convention)."""
    A = steervec_1d(pos, angle)
    Nr = A.shape[0]
    noise = 10.0 ** (-snr_db / 10.0)
    return A @ jnp.conj(A).T + noise * jnp.eye(Nr, dtype=complex_dtype)


def _ula_scan(m: int, d: float, Nf: int):
    """Steering matrix over the scan grid phi in [0, pi] for an
    equispaced m-sensor array with spacing d wavelengths:
    A[f, k] = exp(2i pi d cos(phi_f) k).  Returns (phis, A)."""
    phis = jnp.linspace(0.0, jnp.pi, Nf)
    k = jnp.arange(m)
    A = jnp.exp(2j * jnp.pi * (d * jnp.cos(phis))[:, None] * k[None, :]
                ).astype(complex_dtype)
    return phis, A


def _top_peaks(S: jax.Array, phis: jax.Array, Ns: int) -> jax.Array:
    """Top-Ns local maxima of a spatial spectrum, strongest first."""
    left = jnp.concatenate([S[:1] * 0, S[:-1]])
    right = jnp.concatenate([S[1:], S[-1:] * 0])
    is_peak = (S > left) & (S >= right)
    Sm = jnp.where(is_peak, S, 0.0)
    _, idx = jax.lax.top_k(Sm, Ns)      # O(Nf*Ns), not a full argsort
    return phis[idx]


def spatial_smoothing(R: jax.Array, L: int,
                      backward: bool = True) -> jax.Array:
    """Forward(-backward) spatial smoothing of an m-sensor ULA covariance:
    average the covariances of every length-``L`` subarray (and, with
    ``backward=True``, their flipped conjugates), restoring the signal-
    subspace rank for COHERENT sources — subspace methods on the raw
    covariance fail there (the coherent sources collapse into one
    eigenvector).  Returns the (L, L) smoothed covariance; resolves up to
    m - L coherent sources forward-only, ~2(m - L) with forward-backward.

    Beyond the reference: its MUSIC (stats.cc:283-330) assumes incoherent
    sources and has no smoothing path; multipath scenarios need one.
    """
    R = jnp.asarray(R, complex_dtype)
    m = R.shape[0]
    if not 1 <= L <= m:
        raise ValueError(f"subarray length L={L} must be in [1, {m}]")
    subs = jnp.stack([R[k:k + L, k:k + L] for k in range(m - L + 1)])
    Rs = jnp.mean(subs, axis=0)
    if backward:
        Rb = jnp.flip(jnp.conj(Rs), axis=(0, 1))
        Rs = 0.5 * (Rs + Rb)
    return Rs


def capon_spectrum(R: jax.Array, d: float, Nf: int = 512,
                   diag_load: float = 1e-3
                   ) -> Tuple[jax.Array, jax.Array]:
    """Capon / MVDR spatial spectrum S(phi) = 1 / (a^H R^-1 a) over
    phi in [0, pi] for an equispaced array with spacing ``d`` wavelengths
    (the minimum-variance beamformer's output power per look direction —
    sharper than the Bartlett spectrum, no model-order input like MUSIC).
    ``diag_load`` regularizes R by that fraction of its mean eigenvalue
    (standard diagonal loading, keeps the inverse well-posed on
    sample covariances).  Returns (phis, S).  Beyond the reference
    (subspace spectra only, stats.cc).

    The quadratic form is computed through the Hermitian eigenbasis —
    a^H R^-1 a = sum_i |v_i^H a|^2 / w_i, one (Nf, m) matmul — rather
    than a complex LU solve: a float32 solve on these near-singular
    steering systems can lose enough accuracy to push a sidelobe near the
    MIRROR angle above the true second peak; the eigh path matches the
    float64 result.
    """
    R = jnp.asarray(R, complex_dtype)
    m = R.shape[0]
    w, V = jnp.linalg.eigh(R)
    load = diag_load * jnp.mean(w)
    phis, A = _ula_scan(m, d, Nf)
    proj = jnp.abs(jnp.conj(A) @ V) ** 2          # (Nf, m) |v_i^H a|^2
    denom = proj @ (1.0 / jnp.maximum(w + load, 1e-30))
    return phis, 1.0 / jnp.maximum(denom, 1e-30)


def capondoa_1d(R: jax.Array, d: float, Ns: int, Nf: int = 512,
                diag_load: float = 1e-3) -> jax.Array:
    """Capon/MVDR DOA: the Ns strongest arrival angles (radians) from
    :func:`capon_spectrum` (``diag_load`` forwarded)."""
    phis, S = capon_spectrum(R, d, Nf, diag_load)
    return _top_peaks(S, phis, Ns)


def musicdoa_1d(R: jax.Array, d: float, Ns: int,
                Nf: int = 512) -> jax.Array:
    """1-D MUSIC DOA for an equispaced linear array with spacing d (in
    wavelengths); returns the Ns strongest arrival angles in radians
    (parity: musicdoa_1d, stats.cc:283-330).

    The scan angle phi in [0, pi] maps to spatial frequency d*cos(phi).
    """
    R = jnp.asarray(R, complex_dtype)
    m = R.shape[0]
    w, V = jnp.linalg.eigh(R)
    noise = V[:, : m - Ns]
    phis, A = _ula_scan(m, d, Nf)
    proj = jnp.abs(jnp.conj(A) @ noise) ** 2
    S = 1.0 / (jnp.sum(proj, axis=-1) + 1e-30)
    return _top_peaks(S, phis, Ns)
