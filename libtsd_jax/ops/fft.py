"""Fourier transforms and frequency-domain utilities (JAX, jit-able).

Parity: core/include/tsd/fourier.hpp, core/src/fourier/fourier.cc.

Normalization convention: the reference uses **orthonormal** scaling, 1/sqrt(N)
in both directions (core/src/fourier/fourier.cc:119).  All transforms here use
``norm="ortho"`` to match.

The reference builds its own radix-2 / Bluestein plans (fourier.cc:372-489);
the XLA FFT primitive (cuFFT on the GPU) takes their place — plans map to
jit-compiled shapes, so the ``FFTPlan`` concept disappears by design (SURVEY §3.1).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import complex_dtype, real_dtype

__all__ = [
    "fft", "ifft", "rfft", "irfft", "fftshift", "ifftshift", "fft_freqs",
    "force_csym", "czt", "goertzel", "goertzel_stream", "hadamard", "wht",
    "delay_signal", "resample_freq", "next_pow2", "ola_complexity",
    "ola_complexity_optimize",
]


# NOTE: norm="ortho" is applied via static Python scale factors rather than
# jnp's norm= argument, so the factor folds into the computation as a
# constant.


def _fft_core(x: jax.Array, n: Optional[int], axis: int,
              inverse: bool) -> jax.Array:
    f = jnp.fft.ifft if inverse else jnp.fft.fft
    return f(x.astype(complex_dtype), n=n, axis=axis)


def fft(x: jax.Array, n: Optional[int] = None, axis: int = -1) -> jax.Array:
    """Orthonormal forward DFT (parity: tsd::fourier::fft, fourier.hpp:145).
    ``n`` pads or truncates first, as in jnp.fft."""
    N = n if n is not None else x.shape[axis]
    return _fft_core(x, n, axis, inverse=False) * (1.0 / np.sqrt(N))


def ifft(x: jax.Array, n: Optional[int] = None, axis: int = -1) -> jax.Array:
    """Orthonormal inverse DFT (parity: tsd::fourier::ifft); ``n`` as in
    ``fft``."""
    N = n if n is not None else x.shape[axis]
    return _fft_core(x, n, axis, inverse=True) * np.sqrt(N)


def rfft(x: jax.Array, n: Optional[int] = None, axis: int = -1) -> jax.Array:
    """Real-input forward DFT, orthonormal, n//2+1 bins (parity: rtfr_calcule,
    fourier.cc:130-235 — the reference packs N real into N/2 complex; XLA has
    a native real FFT so the packing trick is unnecessary)."""
    N = n if n is not None else x.shape[axis]
    return jnp.fft.rfft(x.astype(real_dtype), n=n, axis=axis) * (1.0 / np.sqrt(N))


def irfft(x: jax.Array, n: Optional[int] = None, axis: int = -1) -> jax.Array:
    N = n if n is not None else 2 * (x.shape[axis] - 1)
    return jnp.fft.irfft(x, n=n, axis=axis) * np.sqrt(N)


def fftshift(x: jax.Array, axes=None) -> jax.Array:
    return jnp.fft.fftshift(x, axes=axes)


def ifftshift(x: jax.Array, axes=None) -> jax.Array:
    return jnp.fft.ifftshift(x, axes=axes)


def fft_freqs(n: int, fs: float = 1.0, shifted: bool = True) -> jax.Array:
    """Bin frequencies (parity: tfd_freqs, fourier.hpp:207-286). ``shifted``
    returns monotonically increasing frequencies in [-fs/2, fs/2)."""
    f = jnp.fft.fftfreq(n, d=1.0 / fs).astype(real_dtype)
    return jnp.fft.fftshift(f) if shifted else f


def force_csym(X: jax.Array) -> jax.Array:
    """Force conjugate symmetry so that ifft(X) is real (parity: force_csym,
    fourier.hpp): X'[k] = (X[k] + conj(X[-k]))/2."""
    n = X.shape[-1]
    Xr = jnp.conj(jnp.roll(jnp.flip(X, axis=-1), 1, axis=-1))
    return 0.5 * (X + Xr)


def next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


# ------------------------------------------------------------------- CZT

def czt(x: jax.Array, m: Optional[int] = None,
        W: Optional[complex] = None, z0: complex = 1.0 + 0.0j) -> jax.Array:
    """Chirp-Z transform along an arbitrary spiral contour z0 * W^-k,
    k = 0..m-1, via the Bluestein 3-FFT algorithm.

    Parity: tsd::fourier::czt, core/src/fourier/fourier.cc:1347-1395
    (same contour convention: X[k] = sum_n x[n] * (z0 * W^-k)^-n ... evaluated
    as chirp pre/post multiply + linear convolution).  Defaults give the DFT
    (unnormalized).
    """
    n = x.shape[-1]
    if m is None:
        m = n
    if W is None:
        W = np.exp(-2j * np.pi / m)

    nm = max(n, m)
    k = np.arange(nm, dtype=np.float64)
    # chirp h[i] = W^(-i^2/2), extended symmetrically
    logW = np.log(complex(W))
    h = np.exp(-0.5 * k * k * logW)  # W^(-i²/2)
    kz = np.arange(n, dtype=np.float64)
    z0pow = np.exp(-kz * np.log(complex(z0)))  # z0^-i

    g = x * jnp.asarray((z0pow / h[:n]), complex_dtype)

    # linear convolution of g (length n) with chirp taps h over lags giving
    # outputs 0..m-1: y[kk] = sum_i g[i] * h[|kk - i|]  (since h symmetric)
    L = next_pow2(n + m - 1)
    hc = np.zeros(L, dtype=np.complex128)
    hc[:m] = h[:m]
    hc[L - (n - 1):] = h[1:n][::-1]
    Hc = jnp.asarray(np.fft.fft(hc), complex_dtype)
    G = jnp.fft.fft(g, n=L)
    y = jnp.fft.ifft(G * Hc)[..., :m]
    return y * jnp.asarray(1.0 / h[:m], complex_dtype)


# --------------------------------------------------------------- Goertzel

def goertzel(x: jax.Array, f: float) -> jax.Array:
    """Normalized power of the single DFT bin at normalized frequency f.

    Parity: tsd::fourier::goertzel, core/src/fourier/goertzel.cc:7-29 — same
    recursion and same normalization: 2*|X(f)|^2 / (energy * n), so a pure
    sinusoid at f returns ~1.

    The 2nd-order recursion w0 = 2c*w0 - w1 + x is linear; it is evaluated
    here as a direct projection (mathematically identical, drift-free and
    data-parallel) instead of a sequential scan.
    """
    n = x.shape[-1]
    k = jnp.arange(n, dtype=real_dtype)
    w = jnp.exp(-2j * jnp.pi * f * k)
    X = jnp.sum(x * w, axis=-1)  # unnormalized DFT bin
    en = jnp.sum(jnp.abs(x) ** 2, axis=-1)
    return 2.0 * jnp.abs(X) ** 2 / (en * n + 1e-30)


def goertzel_stream(x: jax.Array, f: float, R: int) -> jax.Array:
    """Streaming single-bin power: one normalized Goertzel value per
    R-sample block (parity: filtre_goertzel, goertzel.cc:32-79: restart
    every R samples, normalize by the block energy).

    Input length must be a multiple of R; vectorized as a batched
    projection (one DFT bin per block) — no per-sample recursion needed.
    """
    n = x.shape[-1]
    assert n % R == 0
    blocks = x.reshape(*x.shape[:-1], n // R, R)
    k = jnp.arange(R, dtype=real_dtype)
    w = jnp.exp(-2j * jnp.pi * f * k)
    X = jnp.sum(blocks * w, axis=-1)
    en = jnp.sum(jnp.abs(blocks) ** 2, axis=-1)
    return 2.0 * jnp.abs(X) ** 2 / (en * R + 1e-30)


# --------------------------------------------------------------- Hadamard

def hadamard(n: int) -> jax.Array:
    """Hadamard matrix of order n (power of 2)."""
    assert n & (n - 1) == 0, "n must be a power of 2"
    H = np.array([[1.0]])
    while H.shape[0] < n:
        H = np.block([[H, H], [H, -H]])
    return jnp.asarray(H, real_dtype)


def wht(x: jax.Array) -> jax.Array:
    """Fast Walsh-Hadamard transform (parity: core/src/fourier/hadamard.cc).
    Implemented as log2(n) butterfly passes — XLA unrolls to fused adds."""
    n = x.shape[-1]
    assert n & (n - 1) == 0, "length must be a power of 2"
    y = x
    h = 1
    while h < n:
        y = y.reshape(*y.shape[:-1], n // (2 * h), 2, h)
        a = y[..., 0, :]
        b = y[..., 1, :]
        y = jnp.concatenate([a + b, a - b], axis=-1).reshape(*x.shape[:-1], n)
        h *= 2
    return y


# ----------------------------------------------------------------- delays

def delay_signal(x: jax.Array, delay: float) -> jax.Array:
    """Delay a signal by a possibly fractional number of samples.

    Integer delay shifts with zero fill; fractional delay uses the
    frequency-domain phase ramp on a 2x zero-padded block (parity:
    tsd::fourier::délais, core/src/fourier/fourier.cc:608-707).

    ``delay`` may also be a traced jax scalar (e.g. a randomized channel
    delay under jit) — the phase-ramp path is then taken unconditionally.
    """
    n = x.shape[-1]
    if isinstance(delay, jax.Array) and not isinstance(delay, np.ndarray):
        pass  # traced: fall through to the phase-ramp path
    elif float(delay) == int(delay):
        d = int(delay)
        if d == 0:
            return x
        if d > 0:
            return jnp.concatenate([jnp.zeros_like(x[..., :d]), x[..., :-d]], axis=-1)
        return jnp.concatenate([x[..., -d:], jnp.zeros_like(x[..., :(-d)])], axis=-1)

    N = 2 * n
    pad_lo = n // 2
    from ..block import safe_pad
    x2 = safe_pad(x, pad_lo, N - n - pad_lo, axis=-1)
    is_real = not jnp.iscomplexobj(x)
    X = jnp.fft.fft(x2)
    kf = jnp.fft.fftfreq(N).astype(real_dtype)  # signed normalized freqs
    rot = jnp.exp(-2j * jnp.pi * kf * delay)
    if is_real:
        # keep Nyquist bin real so the output stays real
        rot = rot.at[N // 2].set(jnp.cos(2 * jnp.pi * kf[N // 2] * delay))
    y = jnp.fft.ifft(X * rot)[..., pad_lo:pad_lo + n]
    return jnp.real(y) if is_real else y


def resample_freq(x: jax.Array, ratio: float) -> jax.Array:
    """Frequency-domain resampling by zero-pad / truncation of the spectrum
    (parity: rééchan_freq, fourier.cc:1397-1434, incl. the sqrt(ratio) energy
    scaling)."""
    n = x.shape[-1]
    n2 = int(round(n * ratio))
    if n2 == n:
        # includes ratios that ROUND to the same length (a sqrt(ratio)
        # gain on an unchanged-length signal would be inconsistent with
        # the ratio == 1 early-return)
        return x
    if n2 < 2 or n < 2:
        raise ValueError(
            f"resample_freq: lengths below 2 are degenerate (n={n}, "
            f"target n2={n2}) — the half-spectrum split has no bins")
    X = jnp.fft.fft(x) * (1.0 / np.sqrt(n))
    if ratio > 1:
        X2 = jnp.zeros(x.shape[:-1] + (n2,), complex_dtype)
        # (n+1)//2 positive bins: the reference copies only n/2
        # (fourier.cc:1406), which for ODD n drops positive bin (n-1)/2
        # while keeping its negative-frequency conjugate — breaking
        # conjugate symmetry and halving that component's amplitude
        # (documented reference defect; verified numerically)
        X2 = X2.at[..., : (n + 1) // 2].set(X[..., : (n + 1) // 2])
        X2 = X2.at[..., -(n // 2):].set(X[..., -(n // 2):])
    else:
        X2 = jnp.zeros(x.shape[:-1] + (n2,), complex_dtype)
        X2 = X2.at[..., : n2 // 2].set(X[..., : n2 // 2])
        X2 = X2.at[..., -(n2 // 2):].set(X[..., -(n2 // 2):])
    y = jnp.fft.ifft(X2) * (np.sqrt(n2) * np.sqrt(ratio))
    return jnp.real(y) if not jnp.iscomplexobj(x) else y


# ---------------------------------------------------------- OLA cost model

def ola_complexity(M: int, Ne: int) -> Tuple[float, int, int]:
    """FLOPs/sample of overlap-add FFT filtering with pattern length M and
    input block Ne. Returns (C, Nf, Nz). Parity: ola_complexité,
    core/src/fourier/fourier.cc:708-714."""
    Nf = next_pow2(Ne + M - 1)
    Nz = Nf - Ne
    C = (1.0 / Ne) * 2 * 5 * Nf * np.log2(Nf)
    return C, Nf, Nz


def ola_complexity_optimize(M: int) -> Tuple[float, int, int, int]:
    """Pick the FFT size minimizing FLOPs/sample. Returns (C, Nf, Nz, Ne).
    Parity: ola_complexité_optimise, fourier.cc:715-739."""
    kmin = int(np.ceil(np.log2(max(M, 2))))
    best = None
    for k in range(kmin, min(kmin + 20, 31)):
        Ne = (1 << k) - (M - 1)
        if Ne <= 0:
            continue
        C, Nf, Nz = ola_complexity(M, Ne)
        if best is None or C < best[0]:
            best = (C, Nf, Nz, Ne)
    return best
