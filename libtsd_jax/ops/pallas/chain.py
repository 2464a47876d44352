"""Pallas kernel (Triton route) for Hopper: fused FIR + framed periodogram.

The BASELINE metric chain — a K-tap FIR, then the power spectra of
consecutive 4096-sample frames, summed — in one kernel, so neither the
FIR output nor the complex spectrum is written to device memory.  The
plain version (:func:`libtsd_jax.ops.chain.fir_periodogram4096_plain`)
writes both and reads both back.

Each program takes one channel and ``F`` consecutive frames.  A frame is
a (64, 64) tile of 64-sample rows, and for every frame:

1. FIR as banded-Toeplitz products ``Y = sum_d X[r-d] @ G_d`` with
   (64, 64) tap blocks (``D = (K-2)//64 + 2`` of them).  The left context
   (the previous ``D-1`` rows) is read from device memory with each
   frame, so programs carry nothing between them and run in any order.
2. DFT-4096 as the 64 x 64 Cooley-Tukey split: ``A = W64 @ Y`` (rows),
   twiddle ``A * W4096^(k1 n2)``, ``Z = B @ W64`` (columns); bin
   ``k1 + 64 k2`` is ``Z[k1, k2]``.
3. ``|Z|^2`` summed in registers over the program's frames; one (64, 64)
   partial per program goes out, and a second pass (XLA) sums the
   partials — no atomics, so the result is deterministic.

Precision: every product runs on the tensor cores with bfloat16 operands
and float32 accumulation.  The FIR splits both the input and the taps
into bfloat16 high and low halves and sums three products (hi*hi, lo*hi,
hi*lo): int8 and int16 samples are exact in the two halves, float32
samples keep 16 bits, and the taps keep about 16 bits.  The DFT stages
use single bfloat16 operands (8-bit significands), which bounds the
spectrum error at a few 1e-3 of the peak, inside the reference's 1e-2
large-n FFT tolerance (/root/reference/core/tests/test-fourier.cc:256).

Frame 0 of every channel needs the caller's history before the signal;
the kernel gives that frame zero weight and the wrapper adds it from the
plain version, so the kernel never reads outside the channel.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..chain import toeplitz_blocks

__all__ = ["fir_periodogram4096_kernel", "frames_per_program"]

_NFFT = 4096
_L = 64            # samples per row = Toeplitz block = DFT radix
_R = _NFFT // _L   # rows per frame


def _dft_factors():
    """W64 (bf16 planes, symmetric) and the W4096^(k1 n2) twiddles (f32)."""
    a = np.arange(_L)
    W = np.exp(-2j * np.pi * np.outer(a, a) / _L)
    TW = np.exp(-2j * np.pi * np.outer(a, a) / _NFFT)
    bf = lambda v: jnp.asarray(v, jnp.float32).astype(jnp.bfloat16)
    f32 = lambda v: jnp.asarray(v, jnp.float32)
    return bf(W.real), bf(W.imag), f32(TW.real), f32(TW.imag)


def frames_per_program(nframes: int) -> int:
    """Frames each program sums: the largest power of two <= 32 that
    divides the channel's frame count (fewer, longer programs shrink the
    partial-spectrum pass; C * nframes / 32 programs still fill the card
    at deployment sizes)."""
    F = 32
    while nframes % F:
        F //= 2
    return F


def _kernel(x_ref, gh_ref, gl_ref, wr_ref, wi_ref, twr_ref, twi_ref,
            o_ref, *, F: int, D: int):
    g = pl.program_id(1)
    bf16, f32 = jnp.bfloat16, jnp.float32
    dot = functools.partial(jnp.dot, preferred_element_type=f32)

    def frame(i, P):
        f = g * F + i
        r0 = f * _R
        y = jnp.zeros((_R, _L), f32)
        for d in range(D):
            # frame 0's context would precede the channel: clamp the
            # start (that frame gets weight 0 below)
            xt = x_ref[pl.ds(jnp.maximum(r0 - d, 0), _R), :].astype(f32)
            xh = xt.astype(bf16)
            xl = (xt - xh.astype(f32)).astype(bf16)
            gh = gh_ref[d]
            y += dot(xh, gh) + dot(xl, gh) + dot(xh, gl_ref[d])
        yb = y.astype(bf16)
        wr, wi = wr_ref[...], wi_ref[...]
        ar, ai = dot(wr, yb), dot(wi, yb)
        twr, twi = twr_ref[...], twi_ref[...]
        br = (ar * twr - ai * twi).astype(bf16)
        bi = (ar * twi + ai * twr).astype(bf16)
        zr = dot(br, wr) - dot(bi, wi)
        zi = dot(br, wi) + dot(bi, wr)
        pw = zr * zr + zi * zi
        return P + jnp.where(f > 0, pw, jnp.zeros_like(pw))

    o_ref[...] = jax.lax.fori_loop(0, F, frame, jnp.zeros((_R, _L), f32))


@functools.partial(jax.jit, static_argnames=("interpret",))
def fir_periodogram4096_kernel(x: jax.Array, h: jax.Array,
                               interpret: bool = False) -> jax.Array:
    """Sum over frames 1.. of |DFT4096(FIR(x))|^2, zero history before x.

    x: (C, N) int8 / int16 / bfloat16 / float32, N a multiple of 4096.
    h: (K,) taps, 2 <= K <= 4096.  Returns (C, 4096) float32; frame 0 is
    left out (see the module docstring).  ``interpret`` runs the kernel
    in the Pallas interpreter (tests on the CPU)."""
    C, N = x.shape
    K = h.shape[0]
    assert N % _NFFT == 0, f"N must be a multiple of {_NFFT}"
    assert 2 <= K <= _NFFT, K
    nframes = N // _NFFT
    F = frames_per_program(nframes)
    G = toeplitz_blocks(h.astype(jnp.float32), _L)
    D = G.shape[0]
    gh = G.astype(jnp.bfloat16)
    gl = (G - gh.astype(jnp.float32)).astype(jnp.bfloat16)
    wr, wi, twr, twi = _dft_factors()
    full = lambda a: pl.BlockSpec(a.shape, lambda c, g: (0,) * a.ndim)
    part = pl.pallas_call(
        functools.partial(_kernel, F=F, D=D),
        grid=(C, nframes // F),
        in_specs=[pl.BlockSpec((None, N // _L, _L), lambda c, g: (c, 0, 0)),
                  full(gh), full(gl), full(wr), full(wi), full(twr),
                  full(twi)],
        out_specs=pl.BlockSpec((None, None, _R, _L),
                               lambda c, g: (c, g, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((C, nframes // F, _R, _L),
                                       jnp.float32),
        # 4 warps: one warpgroup per (64, 64) tile (8 ran 2x slower on an H100)
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="fir_periodogram4096",
    )(x.reshape(C, N // _L, _L), gh, gl, wr, wi, twr, twi)
    # P[k1, k2] holds bin k1 + 64 k2
    return jnp.sum(part, axis=1).swapaxes(-1, -2).reshape(C, _NFFT)
