"""Constant-Q transform (CQT).

Parity: core/include/tsd/fourier/cqt.hpp:13-71, core/src/fourier/cqt.cc
(per-bin kernels with constant Q = fk/bandwidth, streaming decimation).

Design: the per-bin kernels (windowed complex exponentials of varying
length) are precomputed into one dense (nbins, Nmax) bank; analysis is a
single matmul of gathered signal frames against the bank — one dense GEMM,
no per-bin loops at runtime.
"""
from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np

from ..config import complex_dtype, real_dtype

__all__ = ["CqtKernel", "cqt_kernel", "cqt", "cqt_freqs",
           "CqtStreamKernel", "cqt_stream_kernel", "cqt_stream",
           "cqt_interpolate"]


@dataclasses.dataclass(frozen=True)
class CqtKernel:
    bank_re: np.ndarray    # (nbins, Nmax)
    bank_im: np.ndarray
    freqs: np.ndarray      # (nbins,)
    lengths: np.ndarray    # (nbins,)

    @property
    def Nmax(self) -> int:
        return self.bank_re.shape[1]


def cqt_freqs(fmin: float, fmax: float, bins_per_octave: int = 12
              ) -> np.ndarray:
    """Geometric frequency grid (parity: CQT bin layout, cqt.cc)."""
    noct = np.log2(fmax / fmin)
    nbins = int(np.floor(noct * bins_per_octave)) + 1
    return fmin * 2.0 ** (np.arange(nbins) / bins_per_octave)


def cqt_kernel(fmin: float, fmax: float, bins_per_octave: int = 12,
               window: str = "hn") -> CqtKernel:
    """Precompute the CQT kernel bank.  Frequencies are normalized
    (cycles/sample).  Each bin k has Q = 1/(2^(1/b)-1) periods, window
    length Nk = Q/fk, Hann windowed, centered in the common Nmax frame."""
    from .window import window as make_window
    freqs = cqt_freqs(fmin, fmax, bins_per_octave)
    Q = 1.0 / (2.0 ** (1.0 / bins_per_octave) - 1.0)
    lengths = np.minimum(np.ceil(Q / freqs).astype(int) | 1, 1 << 20)
    Nmax = int(lengths.max())
    nbins = len(freqs)
    bank = np.zeros((nbins, Nmax), np.complex128)
    for k in range(nbins):
        Nk = int(lengths[k])
        w = make_window(window, Nk, sym=True)
        t = np.arange(Nk) - Nk // 2
        ker = w * np.exp(-2j * np.pi * freqs[k] * t)
        ker /= np.sum(w)
        off = (Nmax - Nk) // 2
        bank[k, off:off + Nk] = ker
    return CqtKernel(bank_re=bank.real, bank_im=bank.imag,
                     freqs=freqs, lengths=lengths)


def cqt(x: jax.Array, kernel: CqtKernel, hop: int = 256) -> jax.Array:
    """CQT magnitude matrix: (nframes, nbins).  Frames centered every
    ``hop`` samples; one matmul against the kernel bank."""
    n = x.shape[-1]
    Nmax = kernel.Nmax
    from ..block import safe_pad
    xp = safe_pad(x.astype(real_dtype) if not jnp.iscomplexobj(x)
                  else x, Nmax // 2, Nmax, axis=-1)
    nframes = len(np.arange(0, n, hop))
    from .signal import sliding_frames
    F = sliding_frames(xp, Nmax, hop, nframes)  # (nframes, Nmax)
    Br = jnp.asarray(kernel.bank_re, real_dtype)
    Bi = jnp.asarray(kernel.bank_im, real_dtype)
    hp = jax.lax.Precision.HIGHEST
    if jnp.iscomplexobj(F):
        Fr, Fi = jnp.real(F), jnp.imag(F)
        mm = lambda a, b: jnp.matmul(a, b, precision=hp)
        re = mm(Fr, Br.T) - mm(Fi, Bi.T)
        im = mm(Fr, Bi.T) + mm(Fi, Br.T)
    else:
        re = jnp.matmul(F, Br.T, precision=hp)
        im = jnp.matmul(F, Bi.T, precision=hp)
    return jnp.sqrt(re * re + im * im)


# ---------------------------------------------------------------------------
# Streaming / decimated CQT (parity: CQT::Impl, cqt.cc:255-443)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CqtStreamKernel:
    """Frequency-domain truncated kernels (parity: CQTNoyaux,
    cqt.cc:10-204): per bin, the FFT of the windowed tone is kept only on
    its significant support [kimin, kimin+ksize) (kernel 'precision'),
    and the bin is evaluated every ktime/2 samples — constant-Q
    decimation: high bins produce outputs more often than low bins."""
    kern_re: np.ndarray     # (nbins, ksmax) truncated spectral kernels
    kern_im: np.ndarray
    kimin: np.ndarray       # (nbins,) first retained FFT bin
    ksize: np.ndarray       # (nbins,) retained support length
    ktime: np.ndarray       # (nbins,) time support (samples)
    freqs: np.ndarray       # (nbins,) normalized frequencies
    N: int                  # FFT / buffer size
    Mmax: int               # max evaluations per half-block advance


def cqt_stream_kernel(fmin: float, fmax: float, gamma: float = 2 ** (1 / 12),
                      Q: float = 34.0, kprec: float = 0.99,
                      window: str = "hm") -> CqtStreamKernel:
    """Build the truncated spectral kernel bank (frequencies normalized,
    cycles/sample; parity: CQTNoyaux::configure/init_noyau,
    cqt.cc:63-204)."""
    from .window import window as make_window
    nbins = int(np.ceil(np.log(fmax / fmin) / np.log(gamma)))
    freqs = fmin * gamma ** np.arange(nbins)
    ideal_N = int(np.ceil(Q / fmin))
    # N >= 2 * ktime_max: with the fixed N/2 streaming hop, a bin's
    # window must fit the buffer at EVERY block alignment (valid start
    # positions [0, N-ktime] must span at least one hop), otherwise the
    # per-bin phase drifts negative and the frequency-domain shift wraps
    # circularly, silently corrupting low bins.  The reference instead
    # consumes variable-size chunks (cqt.cc step1 minimal_position) —
    # dynamic shapes; doubling N is the static-shape equivalent.
    N = 1
    while N < 2 * ideal_N:
        N *= 2
    ktime = np.minimum(np.ceil(Q / freqs).astype(int), N // 2 - 1)
    ktime = ktime + (1 - ktime % 2)          # odd
    kimin = np.zeros(nbins, int)
    ksize = np.zeros(nbins, int)
    kerns = []
    for i in range(nbins):
        kt = int(ktime[i])
        ol = np.cos(2 * np.pi * freqs[i] * np.arange(1, N + 1))
        fen = np.asarray(make_window(window, kt, sym=False), np.float64)
        tmp = np.zeros(N)
        k2 = kt // 2
        tmp[N // 2 - k2: N // 2 - k2 + kt] = ol[N // 2 - k2: N // 2 - k2 + kt] * fen
        X = np.fft.fft(tmp)
        Xa = np.abs(X) ** 2
        total = Xa.sum()
        jmax = int(np.argmax(Xa[: N // 2]))
        Sp = np.cumsum(Xa)
        pv = Sp[jmax - 1] if jmax >= 1 else 0.0
        seg = Sp[jmax: N // 2]
        hit = np.nonzero(seg > Xa[jmax: N // 2].sum() * kprec + pv)[0]
        j2 = (jmax - 1) + hit[0] if len(hit) else N // 2
        hit1 = np.nonzero(Sp[:jmax] > Xa[:jmax].sum() * (1 - kprec))[0]
        j1 = hit1[0] if len(hit1) else 1
        if j2 - j1 < 4:
            j2 = j1 + 4
        kimin[i] = j1
        ksize[i] = j2 - j1 + 1
        kerns.append(X[j1: j2 + 1] / np.sqrt(total))
    ksmax = int(ksize.max())
    bank = np.zeros((nbins, ksmax), np.complex128)
    for i in range(nbins):
        bank[i, : ksize[i]] = kerns[i]
    dt = np.maximum(ktime // 2, 1)
    Mmax = int(np.ceil((N // 2) / dt.min())) + 1
    return CqtStreamKernel(kern_re=bank.real, kern_im=bank.imag,
                           kimin=kimin, ksize=ksize, ktime=ktime,
                           freqs=freqs, N=N, Mmax=Mmax)


def cqt_stream(x: jax.Array, K: CqtStreamKernel):
    """Streaming decimated CQT (parity: CQT::Impl::step/step1,
    cqt.cc:280-365, incl. the frequency-domain time-shift mixer).

    x: (n,) real, n a multiple of N/2.  Returns (times, mags, valid), each
    (nblocks, nbins, Mmax): bin k is evaluated every ktime[k]/2 samples
    (constant-Q decimation), so high bins carry more valid entries.
    times are absolute sample indices of each kernel window start.
    """
    N = K.N
    hop = N // 2
    n = x.shape[-1]
    assert n % hop == 0, f"input must be a multiple of N/2 = {hop}"
    nblk = n // hop
    nbins, ksmax = K.kern_re.shape
    dt = jnp.asarray(np.maximum(K.ktime // 2, 1), jnp.int32)
    ktime = jnp.asarray(K.ktime, jnp.int32)
    kimin = jnp.asarray(K.kimin, jnp.int32)
    jidx = kimin[:, None] + jnp.arange(ksmax)[None, :]     # (nbins, ksmax)
    jmask = jnp.arange(ksmax)[None, :] < jnp.asarray(K.ksize)[:, None]
    kern = (jnp.asarray(K.kern_re, real_dtype)
            + 1j * jnp.asarray(K.kern_im, real_dtype)) * jmask
    m = jnp.arange(K.Mmax)[None, :]                        # (1, Mmax)

    xb = x.astype(real_dtype).reshape(nblk, hop)

    def body(carry, xh):
        buf, kphase, t0 = carry
        buf = jnp.concatenate([buf[hop:], xh])
        X = jnp.fft.fft(buf.astype(complex_dtype))
        Xs = X[jidx]                                       # (nbins, ksmax)
        base = kern * jnp.conj(Xs)
        # evaluation positions: kphase + m*dt while pos + ktime <= N
        pos = kphase[:, None] + m * dt[:, None]            # (nbins, Mmax)
        valid = pos + ktime[:, None] <= N
        tau = (-pos + 0.5 * ktime[:, None]) / N - 0.5
        # phase ramp e^{2i pi (kimin+j) tau} (the reference's s0/ol0 mixer)
        ph = jnp.exp(2j * jnp.pi * (kimin[:, None, None]
                                    + jnp.arange(ksmax)[None, None, :])
                     * tau[:, :, None].astype(real_dtype))
        correl = jnp.sum(base[:, None, :] * ph, axis=-1)   # (nbins, Mmax)
        mags = jnp.abs(correl) * valid
        times = (t0 + pos) * valid
        # next phase: first unevaluated position, re-based after the hop
        nev = jnp.sum(valid, axis=1)
        kphase_new = kphase + nev * dt - hop
        return (buf, kphase_new, t0 + hop), (times, mags, valid)

    buf0 = jnp.zeros((N,), real_dtype)
    kp0 = jnp.full((nbins,), hop, jnp.int32)   # zero-pad start, cqt.cc:264
    (_, _, _), (times, mags, valid) = jax.lax.scan(
        body, (buf0, kp0, jnp.asarray(-hop, jnp.int32)), xb)
    return times, mags, valid


def cqt_interpolate(times, mags, valid, K: CqtStreamKernel, hop_out: int):
    """Resample the irregular per-bin outputs onto a regular grid of one
    column every ``hop_out`` input samples (parity: CQT::interpolation,
    cqt.cc:368-421) — host-side, returns (t, freqs, A[nframes, nbins])."""
    t = np.asarray(times).transpose(1, 0, 2).reshape(times.shape[1], -1)
    v = np.asarray(mags).transpose(1, 0, 2).reshape(mags.shape[1], -1)
    ok = np.asarray(valid).transpose(1, 0, 2).reshape(valid.shape[1], -1)
    tmax = int(t[ok].max()) if ok.any() else 0
    nout = max(1, tmax // hop_out + 1)   # include the final partial span
    grid = np.arange(nout) * hop_out
    A = np.zeros((nout, t.shape[0]), np.float32)
    for k in range(t.shape[0]):
        tk, vk = t[k][ok[k]], v[k][ok[k]]
        if len(tk):
            A[:, k] = np.interp(grid, tk, vk)
    return grid, K.freqs, A
