"""Adaptive and zero-forcing equalizers.

Parity: core/src/telecom/egalisation.cc (EgaliseurRIF LMS FFE/DFE with
DEC/CMA error functions :29-178; ZFE design + convolution matrix :187-247),
header core/include/tsd/telecom.hpp:1502-1579.

The LMS update is an irreducible per-symbol feedback loop -> lax.scan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..block import Block
from ..config import complex_dtype, real_dtype
from .waveform import Waveform

__all__ = ["LmsEqualizer", "zfe_design", "convolution_matrix"]


class LmsEqualizer(Block):
    """FFE (optionally DFE) adaptive equalizer, error = DEC (decision
    directed) or CMA (constant modulus).  Operates at symbol rate (K=1) or
    fractionally (K>1 input samples per output).

    Parity: EgaliseurRIF, egalisation.cc:29-178 — same update rules
    (Wirtinger gradient for out = sum h*wnd, no conjugation on h):
      DEC: h += alpha * e * conj(wnd),          e = decision - out
      CMA: h += alpha * (1-|out|^2) * out * conj(wnd)
    """

    # MAINTENANCE NOTE: init() and step() intentionally keep the
    # ref_mode (reference-trajectory-parity) and default branches as
    # separate literal blocks — the golden tests pin ref_mode
    # trajectory-exactly, so merged plumbing would risk silently
    # changing it.  ANY fix to the active-gating / wnd_d roll / state
    # bookkeeping must be applied to BOTH branches.

    wf: Waveform
    structure: str = struct.field(pytree_node=False, default="ffe")
    errf: str = struct.field(pytree_node=False, default="dec")
    K: int = struct.field(pytree_node=False, default=1)
    alpha: float = struct.field(pytree_node=False, default=0.01)
    N1: int = struct.field(pytree_node=False, default=11)
    N2: int = struct.field(pytree_node=False, default=11)
    # ref_mode=True reproduces the reference's EgaliseurRIF EXACTLY
    # (golden-diffed against the binary in tests/test_golden_ref4.py):
    # REAL-valued taps updated with alpha*real(wnd*conj(e)) and the
    # identity init at the NEWEST tap (egalisation.cc:89-91, 147-158).
    # Real taps cannot rotate a carrier phase and the end-spike has no
    # precursor reach — the default complex/centered design remains the
    # recommended one (see init()'s rationale).
    ref_mode: bool = struct.field(pytree_node=False, default=False)

    def init(self):
        if self.ref_mode:
            h_fwd = jnp.zeros((self.N1,), real_dtype).at[-1].set(1.0)
            st = dict(h_fwd=h_fwd,
                      wnd=jnp.zeros((self.N1,), complex_dtype),
                      cnt=jnp.zeros((), jnp.int32))
            if self.structure == "dfe":
                st["h_bwd"] = jnp.zeros((self.N2,), real_dtype)
                st["wnd_d"] = jnp.zeros((self.N2,), complex_dtype)
            return st
        # unit spike at the CENTER: the equalizer then spans both
        # precursor and postcursor ISI (a spike at the newest position
        # has zero decision delay and no precursor reach — DD-LMS could
        # never converge on a non-minimum-phase channel); zfe_design
        # centers its delay for the same reason
        h_fwd = jnp.zeros((self.N1,), complex_dtype).at[
            self.N1 // 2].set(1.0)
        st = dict(h_fwd=h_fwd,
                  wnd=jnp.zeros((self.N1,), complex_dtype),
                  cnt=jnp.zeros((), jnp.int32))
        if self.structure == "dfe":
            st["h_bwd"] = jnp.zeros((self.N2,), complex_dtype)
            st["wnd_d"] = jnp.zeros((self.N2,), complex_dtype)
        return st

    def step(self, state, x: jax.Array):
        symbols = self.wf.symbols
        alpha = self.alpha
        dfe = self.structure == "dfe"
        cma = self.errf == "cma"
        K = self.K

        def body(st, xi):
            wnd = jnp.roll(st["wnd"], -1).at[-1].set(xi)
            st = {**st, "wnd": wnd}
            cnt = (st["cnt"] + 1) % K
            active = cnt == 0 if K > 1 else jnp.asarray(True)
            out = jnp.sum(st["h_fwd"] * wnd)
            if dfe:
                fb = jnp.sum(st["h_bwd"] * st["wnd_d"])
                out = out + fb
            d_idx = jnp.argmin(jnp.abs(out - symbols) ** 2)
            dec = symbols[d_idx]
            if self.ref_mode:
                # reference update rules (egalisation.cc:147-158): REAL
                # taps, gradient = alpha * real(wnd * conj(e))
                if cma:
                    e = 1.0 - jnp.abs(out) ** 2
                    err = jnp.abs(e)
                    h_fwd = st["h_fwd"] + alpha * e * jnp.real(
                        wnd * jnp.conj(out))
                    if dfe:
                        h_bwd = st["h_bwd"] + alpha * e * jnp.real(
                            st["wnd_d"] * jnp.conj(fb))
                else:
                    ec = dec - out
                    err = jnp.abs(ec)
                    h_fwd = st["h_fwd"] + alpha * jnp.real(
                        wnd * jnp.conj(ec))
                    if dfe:
                        h_bwd = st["h_bwd"] + alpha * jnp.real(
                            st["wnd_d"] * jnp.conj(ec))
                new = {**st, "cnt": cnt,
                       "h_fwd": jnp.where(active, h_fwd, st["h_fwd"])}
                if dfe:
                    new["h_bwd"] = jnp.where(active, h_bwd, st["h_bwd"])
                    new["wnd_d"] = jnp.where(
                        active, jnp.roll(st["wnd_d"], -1).at[-1].set(dec),
                        st["wnd_d"])
                return new, (out, err, active)
            if cma:
                # CMA gradient: h += alpha*(1-|y|^2)*y*conj(w)
                e = 1.0 - jnp.abs(out) ** 2
                h_fwd = st["h_fwd"] + alpha * e * out * jnp.conj(wnd)
                err = jnp.abs(e)
                if dfe:
                    # same Wirtinger gradient w.r.t. h_bwd: proportional
                    # to the TOTAL output, not the partial feedback sum
                    # (h_bwd starts at zero, so an fb-proportional update
                    # could never bootstrap)
                    h_bwd = st["h_bwd"] + alpha * e * out * jnp.conj(
                        st["wnd_d"])
            else:
                # LMS: h += alpha * e * conj(w), e = decision - out
                ec = dec - out
                err = jnp.abs(ec)
                h_fwd = st["h_fwd"] + alpha * ec * jnp.conj(wnd)
                if dfe:
                    h_bwd = st["h_bwd"] + alpha * ec * jnp.conj(st["wnd_d"])
            new = {**st, "cnt": cnt,
                   "h_fwd": jnp.where(active, h_fwd, st["h_fwd"])}
            if dfe:
                new["h_bwd"] = jnp.where(active, h_bwd, st["h_bwd"])
                new["wnd_d"] = jnp.where(
                    active, jnp.roll(st["wnd_d"], -1).at[-1].set(dec),
                    st["wnd_d"])
            return new, (out, err, active)

        state, (y, err, act) = jax.lax.scan(body, state, x)
        return state, (y, err, act)


def convolution_matrix(h: np.ndarray, n: int) -> np.ndarray:
    """Toeplitz convolution matrix: C @ x = conv(h, x)[:n+len(h)-1] rows
    (parity: égaliseur convolution matrix, egalisation.cc:187-210)."""
    h = np.asarray(h)
    m = len(h)
    C = np.zeros((n + m - 1, n), dtype=h.dtype)
    for i in range(n):
        C[i:i + m, i] = h
    return C


def zfe_design(h: np.ndarray, n: int) -> np.ndarray:
    """Zero-forcing equalizer: least-squares inverse of the channel
    (parity: égaliseur_zfe, egalisation.cc:212-247) — g minimizing
    ||conv(h, g) - delta||, delay at the center."""
    h = np.asarray(h, np.complex128)
    m = len(h)
    C = convolution_matrix(h, n)
    d = np.zeros(n + m - 1, np.complex128)
    d[(n + m - 1) // 2] = 1.0
    g, *_ = np.linalg.lstsq(C, d, rcond=None)
    return g
