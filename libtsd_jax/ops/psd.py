"""Power-spectral-density suite: correlogram, Welch, periodogram/STFT,
spectrogram, single-tone frequency estimation.

Parity: core/src/fourier/freqestim.cc, core/include/tsd/fourier.hpp:708-978.

All PSDs use the reference's conventions: orthonormal FFT, fftshifted bins,
dB output where the reference outputs dB.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import complex_dtype, real_dtype
from .fft import fft as _fft, fftshift
from .window import window as _window

__all__ = [
    "psd_freqs", "psd", "psd_welch", "periodogram_dft", "spectrogram",
    "freq_estim", "periodogram_cqt",
]


def psd_freqs(n: int, complex_input: bool = True) -> jax.Array:
    """Frequency grid for a PSD display (parity: psd_freqs,
    core/src/fourier/freqestim.cc:45-92)."""
    if complex_input:
        if n % 2 == 0:
            return jnp.linspace(-0.5, 0.5 - 1.0 / n, n, dtype=real_dtype)
        return jnp.linspace(-0.5 + 1.0 / n, 0.5, n, dtype=real_dtype)
    t1 = 0.5 - (1.0 / n if n % 2 else 0.0)
    return jnp.linspace(0.0, t1, n // 2, dtype=real_dtype)


def psd(x: jax.Array, fen: str = "hn") -> Tuple[jax.Array, jax.Array]:
    """Simple windowed correlogram PSD of the whole signal, in dB,
    fftshifted (parity: tsd::fourier::psd)."""
    n = x.shape[-1]
    w = jnp.asarray(_window(fen, n, sym=False), real_dtype)
    X = _fft(x * w)
    S = fftshift(jnp.abs(X) ** 2, axes=-1)
    return psd_freqs(n), 10.0 * jnp.log10(S + 1e-30)


def psd_welch(x: jax.Array, N: int, fen: str = "hn") -> Tuple[jax.Array, jax.Array]:
    """Welch PSD: 50%-overlapping windowed segments of length N, averaged,
    in dB (parity: psd_welch, freqestim.cc:8-20 — the reference *sums* the
    segment periodograms; summing vs averaging differs by a constant dB
    offset, we sum for exact parity)."""
    n = x.shape[-1]
    if n < N:
        # degrade gracefully like the reference: zero-pad the short
        # signal up to one full segment
        from ..block import safe_pad
        x = safe_pad(x, 0, N - n, axis=-1)
        n = N
    w = jnp.asarray(_window(fen, N, sym=False), real_dtype)
    starts = np.arange(0, n - N, N // 2)
    if len(starts) == 0:
        starts = np.array([0])
    segs = jnp.stack([jax.lax.dynamic_slice_in_dim(x, int(i), N, axis=-1)
                      for i in starts])
    X = _fft(segs * w)
    S = jnp.sum(fftshift(jnp.abs(X) ** 2, axes=-1), axis=0)
    return psd_freqs(N), 10.0 * jnp.log10(S + 1e-30)


def periodogram_dft(x: jax.Array, N: int) -> jax.Array:
    """STFT magnitude matrix: consecutive length-N frames, |FFT|^2, one row
    per frame, fftshifted (parity: periodogramme_tfd, fourier.cc:1451+)."""
    n = x.shape[-1]
    nfrm = n // N
    frames = x[..., : nfrm * N].reshape(*x.shape[:-1], nfrm, N)
    X = _fft(frames)
    return fftshift(jnp.abs(X) ** 2, axes=-1)


def spectrogram(x: jax.Array, N: int, overlap: float = 0.5,
                fen: str = "hn") -> jax.Array:
    """Windowed, overlapping STFT power matrix (rows = time frames)."""
    n = x.shape[-1]
    if n < N:
        from ..block import safe_pad
        x = safe_pad(x, 0, N - n, axis=-1)
        n = N
    hop = max(1, int(N * (1 - overlap)))
    starts = np.arange(0, n - N + 1, hop)
    w = jnp.asarray(_window(fen, N, sym=False), real_dtype)
    segs = jnp.stack([jax.lax.dynamic_slice_in_dim(x, int(i), N, axis=-1)
                      for i in starts])
    X = _fft(segs * w)
    return fftshift(jnp.abs(X) ** 2, axes=-1)


def freq_estim(x: jax.Array, method: str = "candan2") -> jax.Array:
    """Single-tone frequency estimator, returns normalized frequency in
    [-1/2, 1/2).

    Methods (parity: freqestim, core/src/fourier/freqestim.cc:95-150):
    * ``fft``       — argmax bin only
    * ``quadratic`` — parabolic interpolation on |X|
    * ``candan2``   — Candan's 2013 refined estimator (default)
    """
    n = x.shape[-1]
    X = jnp.fft.fft(x.astype(complex_dtype))
    a = jnp.abs(X)
    k = jnp.argmax(a)
    if method == "fft":
        f = k.astype(real_dtype) / n
    elif method == "quadratic":
        X1, X2, X3 = a[(k - 1) % n], a[k], a[(k + 1) % n]
        p = 0.5 * (X3 - X1) / (2 * X2 - X3 - X1)
        f = (k + p) / n
    elif method == "candan2":
        X1, X2, X3 = X[(k - 1) % n], X[k], X[(k + 1) % n]
        p = jnp.real((X1 - X3) / (2.0 * X2 - X3 - X1))
        c = jnp.tan(jnp.pi / n) / (jnp.pi / n)
        p = jnp.arctan(p * c * jnp.pi / n) / (jnp.pi / n)
        f = (k + p) / n
    else:
        raise ValueError(f"unknown method {method!r}")
    # wrap to [-1/2, 1/2)
    return jnp.mod(f + 0.5, 1.0) - 0.5


def periodogram_cqt(x: jax.Array, fs: float, fmin: float, fmax: float,
                    gamma: float = 2 ** (1 / 12), ofs: float = 0.0):
    """Constant-Q time/frequency matrix (parity: periodogramme_cqt,
    core/src/fourier/cqt.cc:461-476, fourier.hpp:958-977): run the
    streaming decimated CQT and resample its irregular per-bin outputs
    onto a regular grid at output rate ``ofs`` (default fs/256).

    Returns (t_seconds, freqs_hz, A[nframes, nbins])."""
    from ..block import safe_pad
    from .cqt import cqt_interpolate, cqt_stream, cqt_stream_kernel
    if ofs <= 0:
        ofs = fs / 256.0
    if jnp.iscomplexobj(x):
        # the CQT bank is real-analysis (audio-style, parity
        # fourier.hpp:708-978); silently taking the real plane of IQ
        # data would return wrong magnitudes with no warning
        raise ValueError(
            "periodogram_cqt expects a real signal; for complex IQ use "
            "ops.psd.psd/spectrogram or run the planes separately")
    K = cqt_stream_kernel(fmin / fs, fmax / fs, gamma)
    hop = K.N // 2
    n = x.shape[-1]
    npad = (-n) % hop
    if npad:
        x = safe_pad(x, 0, npad, axis=-1)
    # jit the scan (one compiled call instead of eager op-by-op dispatch)
    times, mags, valid = jax.jit(lambda xx: cqt_stream(xx, K))(
        jnp.real(x))
    hop_out = max(1, int(round(fs / ofs)))
    grid, freqs, A = cqt_interpolate(times, mags, valid, K, hop_out)
    return grid / fs, freqs * fs, A
