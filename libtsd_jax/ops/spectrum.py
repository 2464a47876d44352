"""Real-time spectrum analyzer: streaming block spectrum with averaging,
windowing, and frequency-sweep composition.

Parity: rt_spectrum / SpectrumConfig, core/src/fourier/fourier.cc:1150-1337,
core/include/tsd/fourier.hpp:908-957.  The reference's one multithreaded
spot (OpenMP over sub-FFTs, fourier.cc:1242-1248) becomes a batched FFT —
trivially parallel on the device.

Sweep mode (fourier.cc:1188-1196, 1259-1266): an input block of
``nsubs * N`` samples holds ``nsubs`` consecutive captures, each taken at
a different LO frequency stepped by ``sweep_step`` bins.  Each capture's
fftshifted power spectrum is edge/DC-masked (``mask_hf`` bins at the band
edges, ``mask_bf`` bins around DC — LO leakage and anti-aliasing guards)
and accumulated into its span of the composite ``Ns``-bin spectrum; the
per-bin hit count normalizes overlapping spans.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from .. import struct

from ..block import Block
from ..config import complex_dtype, real_dtype
from .window import window as make_window

__all__ = ["SpectrumConfig", "RtSpectrum"]


@dataclasses.dataclass(frozen=True)
class SpectrumConfig:
    """Parity: SpectrumConfig, fourier.hpp:908-949 (BS = nsubs * N)."""
    N: int = 1024             # FFT size per capture (reference Nf = BS/nsubs)
    navg: int = 4             # exponential averaging factor (blocks)
    window: str = "hn"
    nsubs: int = 1            # captures per input block (sweep positions)
    sweep_step: int = 0       # LO step between captures, in bins (0 = off)
    mask_hf: int = 0          # masked bins at each band edge
    mask_bf: int = 0          # masked bins around DC (2*mask_bf total)

    @property
    def sweep_active(self) -> bool:
        return self.nsubs > 1 and self.sweep_step > 0

    @property
    def Ns(self) -> int:
        """Composite spectrum size (parity: SpectrumConfig::Ns)."""
        if self.sweep_active:
            return self.N + (self.nsubs - 1) * self.sweep_step
        return self.N


class RtSpectrum(Block):
    """step(state, x) -> (state, spectrum_db).

    Without sweep: x length a multiple of N; output = exponentially
    averaged fftshifted power spectrum (N bins, dB).  With sweep: x length
    a multiple of nsubs*N (one full sweep per block); output = composite
    Ns-bin spectrum (dB)."""

    win: jax.Array
    mask: jax.Array
    cnt: jax.Array          # per-bin hit count over the composite span
    cfg: SpectrumConfig = struct.field(pytree_node=False)

    @classmethod
    def create(cls, cfg: SpectrumConfig) -> "RtSpectrum":
        N = cfg.N
        w = np.asarray(make_window(cfg.window, N, sym=False), np.float64)
        # normalize window energy so total power is preserved
        # (fourier.cc:1203-1205)
        w = w * np.sqrt(N / np.sum(w * w))
        mask = np.ones(N, np.float32)
        if cfg.mask_hf > 0:
            mask[: cfg.mask_hf] = 0.0
            mask[-cfg.mask_hf:] = 0.0
        if cfg.mask_bf > 0:
            mask[N // 2 - cfg.mask_bf: N // 2 + cfg.mask_bf] = 0.0
        cnt = np.zeros(cfg.Ns, np.float32)
        if cfg.sweep_active:
            for i in range(cfg.nsubs):
                cnt[i * cfg.sweep_step: i * cfg.sweep_step + N] += mask
            cnt = np.maximum(cnt, 1.0)     # fourier.cc:1195
        else:
            cnt[:] = 1.0
        return cls(win=jnp.asarray(w, real_dtype),
                   mask=jnp.asarray(mask, real_dtype),
                   cnt=jnp.asarray(cnt, real_dtype), cfg=cfg)

    def init(self):
        return jnp.zeros((self.cfg.Ns,), real_dtype)  # averaged power

    def step(self, state, x: jax.Array):
        cfg = self.cfg
        N = cfg.N
        n = x.shape[-1]
        if not cfg.sweep_active:
            assert n % N == 0, "input must be a multiple of N"
            frames = x.reshape(*x.shape[:-1], n // N, N)
            X = jnp.fft.fft(frames.astype(complex_dtype) * self.win,
                            axis=-1)
            P = jnp.fft.fftshift(jnp.mean(jnp.abs(X) ** 2, axis=-2),
                                 axes=-1) * self.mask / N
        else:
            BS = cfg.nsubs * N
            assert n % BS == 0, "input must be a multiple of nsubs*N"
            # (sweeps, nsubs, N): each row i of a sweep was captured at LO
            # position i (batched FFT = the reference's OpenMP loop)
            frames = x.reshape(*x.shape[:-1], n // BS, cfg.nsubs, N)
            X = jnp.fft.fft(frames.astype(complex_dtype) * self.win,
                            axis=-1)
            Psub = (jnp.fft.fftshift(jnp.mean(jnp.abs(X) ** 2, axis=-3),
                                     axes=-1) * self.mask)  # (nsubs, N)
            P = jnp.zeros(x.shape[:-1] + (cfg.Ns,), real_dtype)
            for i in range(cfg.nsubs):     # static unroll, XLA fuses
                P = jax.lax.dynamic_update_slice_in_dim(
                    P, jax.lax.dynamic_slice_in_dim(
                        P, i * cfg.sweep_step, N, axis=-1)
                    + Psub[..., i, :], i * cfg.sweep_step, axis=-1)
            P = P / (self.cnt * N)
        g = 1.0 / cfg.navg
        avg = (1 - g) * state + g * P
        return avg, 10.0 * jnp.log10(avg + 1e-30)
