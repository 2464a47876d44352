"""Polyphase-FFT channelizer: split a wideband signal into M uniformly
spaced channels, each decimated by M, in one shot.

The reference declares channelization (canalise/décanalise,
core/src/telecom/canalisation/canalisation.cc) but its polyphase-FFT path
is legacy/commented-out; only the single-channel TranspoBB is live.  This
is the completed design: the polyphase partition is a reshape +
batched FIR, and the channel separation is ONE batched FFT across the
polyphase branches — matmuls and FFTs, no per-channel loops.

y[m, c] = channel c at decimated time m, centered at f_c = c/M.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..block import Block
from ..config import complex_dtype, real_dtype
from ..ops.fir_design import fir_lowpass

__all__ = ["Channelizer", "channelize", "dechannelize",
           "wola_analysis", "wola_synthesis"]


class Channelizer(Block):
    """M-channel critically sampled polyphase-FFT analysis bank.

    Prototype lowpass h (length K*M) is partitioned into M branches
    P[p, j] = h[j*M + p]; input phases x_p[m] = x[m*M - p] run through the
    branches and an M-point IFFT across p yields all channels at once.
    """

    P: jax.Array     # (M, K) polyphase branch taps
    M: int = struct.field(pytree_node=False)

    @classmethod
    def create(cls, M: int, taps_per_branch: int = 8,
               h: Optional[np.ndarray] = None) -> "Channelizer":
        if h is None:
            h = fir_lowpass(M * taps_per_branch, 0.5 / M, "hn") * M
        K = len(h) // M
        h = np.asarray(h[: K * M], np.float64)
        P = h.reshape(K, M).T  # P[p, j] = h[j*M + p]
        return cls(P=jnp.asarray(P, real_dtype), M=M)

    @property
    def ratio(self):
        return 1.0 / self.M

    def init(self):
        K = self.P.shape[1]
        return dict(
            hist=jnp.zeros((2, self.M, K - 1), real_dtype),
            raw=jnp.zeros((2, self.M - 1), real_dtype),  # last M-1 samples
        )

    def step(self, state, x: jax.Array):
        """x: (n,) with n % M == 0 -> (n//M, M) channel matrix."""
        M = self.M
        K = self.P.shape[1]
        n = x.shape[-1]
        assert n % M == 0
        m = n // M
        xc = x.astype(complex_dtype)
        # polyphase decomposition: branch p takes x[m*M - p].
        # x[mM - p] = x[(m-1)M + (M-p)]; the m=0 row for p>=1 needs the last
        # M-1 samples of the PREVIOUS block (carried in state)
        Xf = xc.reshape(m, M)               # Xf[m, q] = x[mM + q]
        b0 = Xf[:, 0:1]
        prev_raw = (state["raw"][0] + 1j * state["raw"][1]).astype(
            complex_dtype)                   # x[-(M-1)..-1] of the stream
        first_row = prev_raw[::-1][None, :]  # [p-1] = x[-p]
        bp = jnp.concatenate([first_row, Xf[:-1, 1:][:, ::-1]], axis=0)
        B = jnp.concatenate([b0, bp], axis=1)  # (m, M): B[m, p] = x[mM - p]
        # FIR each branch over time with carried history.  Slice-MAC, not
        # an index-array window gather: the (M, m, K) advanced-index take
        # lowers to an element-rate gather; K static shifted slices with
        # broadcast MACs are plain vectorized passes.
        hist = (state["hist"][0] + 1j * state["hist"][1]).astype(
            complex_dtype)                   # (M, K-1)
        Bt = B.T  # (M, m)
        full = jnp.concatenate([hist, Bt], axis=1)  # (M, K-1+m)
        taps = jnp.flip(self.P, axis=1)  # conv: newest sample * h[0]
        tc = taps.astype(complex_dtype)
        Y = None
        for k in range(K):
            term = jax.lax.slice_in_dim(full, k, k + m, axis=1) * tc[:, k:k + 1]
            Y = term if Y is None else Y + term
        # channel separation: IFFT across branches
        ch = jnp.fft.ifft(Y, axis=0) * M  # (M, m)
        # shape-based slices: -(K-1)/-(M-1) would be -0 for K==1 / M==1
        # and return the WHOLE buffer (state growing every step; scan
        # carry shape crash)
        new_hist = full[:, full.shape[1] - (K - 1):]
        new_state = dict(
            hist=jnp.stack([jnp.real(new_hist), jnp.imag(new_hist)]),
            raw=jnp.stack([jnp.real(xc[xc.shape[-1] - (M - 1):]),
                           jnp.imag(xc[xc.shape[-1] - (M - 1):])]),
        )
        return new_state, ch.T

    def frequencies(self) -> np.ndarray:
        """Channel center frequencies (normalized)."""
        f = np.arange(self.M) / self.M
        return np.where(f >= 0.5, f - 1.0, f)


def channelize(x: jax.Array, M: int, taps_per_branch: int = 8,
               bank: "Channelizer" = None) -> jax.Array:
    """One-shot channelization -> (n//M, M).

    ``bank``: optional pre-built Channelizer — per-block streaming loops
    should pass one (each bare call otherwise re-runs the host-side
    prototype design and re-uploads the tap matrix)."""
    c = bank if bank is not None else Channelizer.create(M,
                                                        taps_per_branch)
    from ..block import pad_to_multiple
    xp = pad_to_multiple(x, M, axis=x.ndim - 1)
    _, y = c.step(c.init(), xp)
    return y


def dechannelize(ch: jax.Array, M: int, taps_per_branch: int = 8,
                 bank: "Channelizer" = None) -> jax.Array:
    """Synthesis bank: reassemble the wideband signal from channels.

    x_hat[rM + q] = sum_j h[(r-j)M + q] V[q, j] with
    V[q, j] = sum_c ch[c, j] e^{+2πi cq/M} = IFFT_c — the SAME transform
    direction as the analysis (an earlier revision used the FFT here,
    which negates every channel's center frequency and reconstructs
    garbage; caught by the round-trip test).  Unit passband gain.

    Accuracy: a critically sampled single-prototype DFT bank is NOT a
    perfect-reconstruction pair — signals at channel centers round-trip
    to ~0.2% but broadband content incurs crossover aliasing (~ -13 dB,
    converging slowly with prototype length; measured in
    tests/test_advanced.py).  For near-perfect reconstruction use the 2x
    oversampled WOLA pair (wola_analysis/wola_synthesis)."""
    m = ch.shape[0]
    V = jnp.fft.ifft(ch.T, axis=0)  # (M, m); the analysis' *M and this
    #                                 ifft's 1/M cancel -> unit gain
    # zero-stuff each branch to rate M and filter with branch p of h —
    # ALL branches at once via slice-MAC (the per-branch python loop with
    # an index-array window unrolled M gathers and was element-rate bound)
    c = bank if bank is not None else Channelizer.create(M,
                                                        taps_per_branch)
    K = c.P.shape[1]
    histf = jnp.concatenate(
        [jnp.zeros((M, K - 1), complex_dtype), V], axis=1)  # (M, K-1+m)
    tapsf = jnp.flip(c.P, axis=1).astype(complex_dtype)     # (M, K)
    fb = None
    for k in range(K):
        term = jax.lax.slice_in_dim(histf, k, k + m, axis=1) \
            * tapsf[:, k:k + 1]
        fb = term if fb is None else fb + term              # (M, m)
    # out[t*M + q] = fb[q, t]: interleave branches
    return fb.T.reshape(m * M)


# ---------------------------------------------------------------------------
# 2x-oversampled WOLA channelizer pair: NEAR-PERFECT reconstruction.
#
# The critically sampled bank above cannot reconstruct broadband content
# (crossover aliasing is structural, ~-13 dB).  Oversampling the channel
# streams by M/R (R = hop, default M/2 -> 2x) pushes the decimation
# aliases into the prototype's stopband, so the round-trip error equals
# the stopband leakage — arbitrarily small with a longer prototype.
# This is the standard weighted-overlap-add (WOLA) structure; everything
# is reshapes, static shifted slices, one batched FFT, and an
# overlap-add of shifted adds — no gathers (see the analysis-bank note
# above).
# ---------------------------------------------------------------------------

def _wola_prototype(M: int, K: int) -> np.ndarray:
    """Root-Nyquist prototype of length K*M: root-raised-cosine with
    beta=1, symbol period M.  The band-edge crossing is -3 dB, so the
    analysis x synthesis cascade H(f)G(f) is the RAISED cosine — an
    M-band Nyquist filter — and adjacent channels sum to exactly 1
    across the crossover (measured round-trip: -71 dB broadband at K=16,
    -83 dB at K=32).  A plain -6 dB lowpass here loses half the energy
    at every channel edge (each edge tone passes the prototype twice)."""
    from ..ops.fir_design import root_raised_cosine
    return root_raised_cosine(K * M, 1.0, M) * M


def wola_analysis(x: jax.Array, M: int, R: Optional[int] = None,
                  taps_per_branch: int = 16,
                  h: Optional[np.ndarray] = None) -> jax.Array:
    """Oversampled analysis bank: (..., n) -> (..., nj, M) channel matrix
    with hop R (default M//2 = 2x oversampled channels).  Leading axes
    are independent streams — batch them to fill the device (one stream
    at small M under-uses it R-fold).

    ch[j, c] = sum_n h[n] x[jR+n] e^{-2i pi c (jR+n)/M}: channel c
    demodulated to baseband, filtered by h, sampled every R samples.
    """
    if R is None:
        R = M // 2
    assert M % R == 0, (M, R)
    if h is None:
        h = _wola_prototype(M, taps_per_branch)
    K = len(h) // M
    n = x.shape[-1]
    xc = x.astype(complex_dtype)
    KM = K * M
    nj = (n - KM) // R + 1
    assert nj >= 1, "signal shorter than the prototype"
    # Polyphase fold, gather-free AND expansion-free.  The textbook form
    # frames(x, KM, R) * h -> fold K segments materializes an (nj, KM)
    # intermediate = KM/R (= 2K at the default hop) times the input size
    # in HBM.  Fold directly instead: with M = P*R and q = p*R + s,
    #   F[j, pR+s] = sum_k h[kM+pR+s] * x[(j+kP+p)R + s]
    # i.e. K*P static shifted slices of the R-column reshape of x, each a
    # broadcast MAC over an (nj, R) tile — the only materialized array is
    # the (nj, M) output itself (and likewise the mirrored synthesis
    # fold).
    P = M // R
    total = (nj + K * P - 1) * R                     # = (nj-1)*R + KM <= n
    Xr = xc[..., :total].reshape(*xc.shape[:-1], nj + K * P - 1, R)
    Hr = np.asarray(h[: K * M], np.float64).reshape(K, P, R)
    cols = []
    for p in range(P):
        acc = None
        for k in range(K):
            term = (jax.lax.slice_in_dim(Xr, k * P + p, k * P + p + nj,
                                         axis=-2)
                    * jnp.asarray(Hr[k, p], real_dtype))
            acc = term if acc is None else acc + term
        cols.append(acc)                             # (..., nj, R)
    F = jnp.concatenate(cols, axis=-1)               # (..., nj, M)
    # phase fixup e^{-2i pi c jR/M}: circular time shift of F by +jR mod M
    # (shift theorem with numpy-roll convention roll(y, s)[q] = y[q - s]:
    # FFT(roll(y, s))[c] = e^{-2i pi cs/M} FFT(y)[c]).  jR mod M cycles
    # with period M//R; pad nj to a multiple so the de/interleave is pure
    # reshapes.
    Fsh = _roll_rows_mod(F, [(j * R) % M for j in range(M // R)])
    return jnp.fft.fft(Fsh, axis=-1)                 # (..., nj, M)


def _roll_rows_mod(F: jax.Array, shifts) -> jax.Array:
    """Roll row j (axis -2) of F by shifts[j mod P] along the last axis,
    gather-free (pad rows to a multiple of P, reshape-deinterleave, roll
    per residue, reshape-interleave, slice).  Batch axes lead."""
    P = len(shifts)
    nj, M = F.shape[-2:]
    njp = -(-nj // P) * P
    if njp > nj:
        z = jnp.zeros(F.shape[:-2] + (njp - nj, M), F.dtype)
        F = jnp.concatenate([F, z], axis=-2)
    G = F.reshape(*F.shape[:-2], njp // P, P, M)
    G = jnp.stack([jnp.roll(G[..., p, :], shifts[p], axis=-1)
                   for p in range(P)], axis=-2)
    return G.reshape(*G.shape[:-3], njp, M)[..., :nj, :]


def wola_synthesis(ch: jax.Array, M: int, R: Optional[int] = None,
                   taps_per_branch: int = 16,
                   h: Optional[np.ndarray] = None) -> jax.Array:
    """Inverse of :func:`wola_analysis` (same M, R, prototype):
    (..., nj, M) -> (..., ~n) with unit passband gain and ZERO net
    delay: the round trip is index-aligned, xr[t] reconstructs x[t]
    (the analysis and synthesis prototype delays cancel by
    construction — measured: compensating a K*M - R "group delay"
    as an earlier docstring claimed misaligns by 248 samples at the
    defaults and reconstructs garbage).  Leading axes are independent
    streams.

    Round-trip accuracy is set by the prototype (root-Nyquist default:
    ~3e-4 broadband at taps_per_branch=16, ~7e-5 at 32 — measured in
    tests/test_advanced.py) — this is the reconstruction-grade path; the
    critically sampled pair trades it for M-fold decimation."""
    if R is None:
        R = M // 2
    assert M % R == 0
    if h is None:
        h = _wola_prototype(M, taps_per_branch)
    K = len(h) // M
    nj = ch.shape[-2]
    KM = K * M
    # u_j[q] = (1/M) sum_c ch[j, c] e^{+2i pi c q/M}, then undo the
    # analysis' phase fixup by shifting back by +(jR mod M)
    # u'_j[t] = IFFT(ch[j] . e^{+2i pi c jR/M})[t] = roll(IFFT(ch[j]), -jR)
    # — the inverse of the analysis' phase fixup
    u = jnp.fft.ifft(ch, axis=-1)                        # (..., nj, M)
    us = _roll_rows_mod(u, [(-(j * R)) % M for j in range(M // R)])
    # COLA normalization: in-band content reaches here already carrying
    # the analysis filter's response (ch = H(delta) * x, |H| ~ Sum h at
    # baseband, cancelled by the ifft's 1/M since Sum h = M), so the
    # synthesis OLA envelope is env[q] = sum_s g[q + sR] to the FIRST
    # power (R-periodic); divide it out for unit in-band gain.  (An
    # earlier h^2 envelope — correct for sample-level WOLA like an STFT,
    # wrong for a filter bank — left ~5% frame-rate amplitude ripple.)
    # env from the HOST prototype (h may be a traced array only when the
    # caller passes a device array; require numpy for the static env)
    hn = np.asarray(h[: K * M], np.float64)
    env = np.zeros(R)
    for s in range(KM // R):
        env += hn[s * R: (s + 1) * R]
    # Polyphase-folded overlap-add, expansion-free (mirror of the
    # analysis fold): out[(j+kP+p)R + s] += h[kM+pR+s] * us[j, pR+s],
    # i.e. each (k, p) term is the (nj, R) column block p of us scaled by
    # a tap row and placed at row offset kP+p — K*P zero-padded shifted
    # adds, never materializing the (nj, KM) per-frame contributions
    # (XLA parallelizes/fuses the adds; a serial dynamic_update_slice
    # chain here forced serial passes).
    P = M // R
    S = KM // R                                          # = K*P
    nrows = nj + S - 1
    b = us.shape[:-2]
    Hr = hn.reshape(K, P, R)
    out = None
    for p in range(P):
        up = us[..., p * R:(p + 1) * R]                  # (..., nj, R)
        for k in range(K):
            s0 = k * P + p
            part = jnp.concatenate(
                [jnp.zeros(b + (s0, R), complex_dtype),
                 up * jnp.asarray(Hr[k, p], real_dtype),
                 jnp.zeros(b + (S - 1 - s0, R), complex_dtype)], axis=-2)
            out = part if out is None else out + part
    out = out / jnp.asarray(env, real_dtype)[None, :]
    return out.reshape(*b, nrows * R)
