"""Streaming filter runtime (JAX, jit-able).

Parity: core/src/filtrage/filtre-rt.cc (delay line, FIR, decimator, IIR DF1,
SOS cascade, DC blocker, moving average, exponential smoother) and
core/src/fourier/fourier.cc:741-1010 (OLA FFT filtering).

Design (not a port):

* **FIR = banded Toeplitz matmul.**  Frame the signal into rows of
  L=128 samples; then ``Y[r] = sum_d X[r-d] @ G_d`` where ``G_d[m, i] =
  h[d*L + i - m]`` are precomputed L x L tap matrices (D = ceil(K/L)+1 of
  them).  All FLOPs are dense matrix products and device-memory traffic
  is one pass over the signal.  The reference's per-sample sliding
  window loop (filtre-rt.cc:67-110) has no data-parallel equivalent
  worth keeping.
* **Streaming state is explicit**: a FIR block carries the last K-1 input
  samples; an OLA block carries the overlap tail; IIR carries canonical
  state.  `state, y = block.step(state, x)`.
* **Recursive filters** use `lax.associative_scan` for first order
  (log-depth) and `lax.scan` over samples for SOS cascades (the sequential
  dependency is irreducible; batch across channels/sections instead).

All blocks accept batched inputs with leading channel axes where documented.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..block import Block
from ..config import complex_dtype, from_ri, real_dtype, to_ri

__all__ = [
    "fir_toeplitz_mats", "fir_filter", "fir_filter_valid", "Fir",
    "Decimator", "DelayLine", "FirDecim", "MovingAverage", "ExpSmoother",
    "DcBlocker", "Iir", "IirFrame", "iir_filter", "sos_frame_chain", "Sos",
    "OlaFft", "FirFft", "filter_signal", "filtfilt",
]

_L = 128  # Toeplitz frame size


def fir_toeplitz_mats(h: np.ndarray, L: int = _L) -> np.ndarray:
    """Precompute the banded Toeplitz tap matrices G_d (host, float64 in,
    float32 out).

    G_d[m, i] = h[d*L + i - m] (0 <= m,i < L), zero outside [0, K).
    Then y[r*L + i] = sum_d sum_m x[(r-d)*L + m] * G_d[m, i].
    """
    h = np.asarray(h)
    K = len(h)
    D = (K - 2) // L + 2  # number of diagonal blocks covering lag K-1
    G = np.zeros((D, L, L), dtype=h.dtype)
    m = np.arange(L)[:, None]
    i = np.arange(L)[None, :]
    for d in range(D):
        idx = d * L + i - m
        valid = (idx >= 0) & (idx < K)
        G[d] = np.where(valid, h[np.clip(idx, 0, K - 1)], 0.0)
    return G


def _mm_prec(a: jax.Array, b: jax.Array, prec: str) -> jax.Array:
    """Real matmul at a precision tier: "highest" (full float32, ~1e-7),
    "split" (3-pass bf16 hi/lo decomposition, ~1e-5 relative), "bf16"
    (single pass, ~2.5e-3)."""
    if prec == "highest":
        return jnp.matmul(a, b, preferred_element_type=real_dtype,
                          precision=jax.lax.Precision.HIGHEST)
    mm = functools.partial(jnp.matmul, preferred_element_type=real_dtype)
    if prec == "bf16":
        return mm(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16))
    assert prec == "split", prec
    ah = a.astype(jnp.bfloat16)
    al = (a - ah.astype(real_dtype)).astype(jnp.bfloat16)
    bh = b.astype(jnp.bfloat16)
    bl = (b - bh.astype(real_dtype)).astype(jnp.bfloat16)
    return mm(ah, bh) + mm(al, bh) + mm(ah, bl)


def _fir_frames(xf: jax.Array, G: jax.Array,
                prec: str = "highest") -> jax.Array:
    """Apply the Toeplitz matmul to framed input.

    xf: (..., nf + D - 1, L) — includes D-1 history frames in front.
    G:  (D, L, L).
    Returns (..., nf, L).

    A complex xf with REAL taps runs as ONE batched real matmul over
    stacked re/im planes — half the matmul work of the naive
    cast-to-complex route (whose imag-factor matmuls multiply by zero).
    """
    if jnp.iscomplexobj(xf) and not jnp.iscomplexobj(G):
        planes = jnp.stack([jnp.real(xf), jnp.imag(xf)])
        out = _fir_frames(planes, G, prec)
        return (out[0] + 1j * out[1]).astype(complex_dtype)
    D = G.shape[0]
    nf = xf.shape[-2] - (D - 1)
    out = None
    for d in range(D):
        seg = jax.lax.slice_in_dim(xf, D - 1 - d, D - 1 - d + nf, axis=-2)
        if jnp.iscomplexobj(seg) or jnp.iscomplexobj(G):
            term = _cmatmul(seg, G[d], prec)
        else:
            term = _mm_prec(seg, G[d], prec)
        out = term if out is None else out + term
    return out


def _cmatmul(a: jax.Array, b: jax.Array, prec: str = "highest") -> jax.Array:
    """Complex matmul via 4 real matmuls (real matrix units)."""
    ar, ai = jnp.real(a), jnp.imag(a)
    br, bi = jnp.real(b), jnp.imag(b)
    mm = functools.partial(_mm_prec, prec=prec)
    rr = mm(ar, br) - mm(ai, bi)
    ri = mm(ar, bi) + mm(ai, br)
    return (rr + 1j * ri).astype(complex_dtype)


def fir_filter(h, x: jax.Array) -> jax.Array:
    """One-shot FIR, same-length output, zero initial state:
    y[n] = sum_k h[k] x[n-k] (parity: filtrer(h, x),
    core/include/tsd/filtrage.hpp:1730-1744 / FiltreRIF::step).

    x may have leading batch axes; filtering runs along the last axis.
    """
    h = np.asarray(h)
    x = jnp.asarray(x)
    # real taps + complex x stays MIXED: Fir runs the re/im planes
    # through one batched real matmul (half the passes of complex taps)
    blk = Fir.create(h)
    state = blk.init_for(x)
    _, y = blk.step(state, x)
    return y


def fir_filter_valid(h, x: jax.Array) -> jax.Array:
    """FIR with 'valid' output: only the len(x)-K+1 samples with full overlap."""
    y = fir_filter(h, x)
    K = len(np.asarray(h))
    return y[..., K - 1:]


class Fir(Block):
    """Streaming FIR block (Toeplitz-matmul path).

    State: the last K-1 input samples per channel.  Output sample n depends on
    inputs n-K+1..n, so output aligns with input (group delay (K-1)/2 for
    linear phase).  Parity: FiltreRIF, filtre-rt.cc:54-110.
    """

    G_: jax.Array         # (D, L, L) real taps, or (2, D, L, L) re/im planes
    K: int = struct.field(pytree_node=False)
    complex_taps: bool = struct.field(pytree_node=False, default=False)
    # matmul tier: "highest" (default, ~1e-7), "split" (3-pass bf16
    # hi/lo, ~1e-5 — ample for any loop whose EVM floor is >1e-3),
    # "bf16" (single pass, ~2.5e-3)
    precision: str = struct.field(pytree_node=False, default="highest")

    @property
    def tail_state(self) -> bool:
        # state = the last K-1 INPUT samples: the overlap-save contract
        # the parallel tail halo relies on
        return True

    @property
    def G(self) -> jax.Array:
        return from_ri(self.G_) if self.complex_taps else self.G_

    @classmethod
    def create(cls, h, precision: str = "highest") -> "Fir":
        h = np.asarray(h)
        cplx = bool(np.iscomplexobj(h))
        G = fir_toeplitz_mats(h.astype(np.complex128 if cplx else np.float64))
        return cls(G_=to_ri(G) if cplx else jnp.asarray(G, real_dtype),
                   K=len(h), complex_taps=cplx, precision=precision)

    def init(self):
        dt = complex_dtype if self.complex_taps else real_dtype
        return jnp.zeros((self.K - 1,), dt)

    def init_for(self, x: jax.Array):
        """State for batched input (leading axes of x)."""
        dt = complex_dtype if (self.complex_taps or jnp.iscomplexobj(x)) \
            else real_dtype
        return jnp.zeros(x.shape[:-1] + (self.K - 1,), dt)

    @property
    def delay(self) -> float:
        return (self.K - 1) / 2

    def step(self, state, x: jax.Array):
        n = x.shape[-1]
        D = self.G.shape[0]
        hist = (D - 1) * _L
        # place state (K-1 samples) right before x, pad front to frame align
        xx = jnp.concatenate([state, x], axis=-1)
        pad_front = hist - (self.K - 1)
        pad_back = (-n) % _L
        # zero history in front, frame padding behind (block.safe_pad)
        from ..block import safe_pad
        xx = safe_pad(xx, pad_front, pad_back, axis=-1)
        xf = xx.reshape(*xx.shape[:-1], -1, _L)
        G = self.G
        if jnp.iscomplexobj(G):
            xf = xf.astype(complex_dtype)
        # complex x with real taps stays MIXED: _fir_frames runs the re/im
        # planes through ONE batched real matmul (half the passes of
        # casting G to complex)
        yf = _fir_frames(xf, G, self.precision)
        y = yf.reshape(*x.shape[:-1], -1)[..., :n]
        xx2 = jnp.concatenate([state, x], axis=-1)
        # NOT [-(K-1):]: for K=1 that slice is [-0:] = everything, and
        # the carried state would grow by n every step
        new_state = xx2[..., xx2.shape[-1] - (self.K - 1):]
        return new_state, y


class DelayLine(Block):
    """Integer delay of d samples (parity: LigneARetard,
    filtre-rt.cc:13-46)."""

    d: int = struct.field(pytree_node=False)
    dtype: str = struct.field(pytree_node=False, default="float32")

    def init(self):
        return jnp.zeros((self.d,), jnp.dtype(self.dtype))

    @property
    def delay(self) -> float:
        return float(self.d)

    def step(self, state, x):
        if self.d == 0:
            return state, x
        xx = jnp.concatenate([state, x], axis=-1)
        return xx[..., -self.d:], xx[..., : x.shape[-1]]


class Decimator(Block):
    """Keep 1 sample in R with phase carried across blocks (parity:
    Decimateur, filtre-rt.cc:120-170).  Block length must be a multiple of R
    so output shapes stay static."""

    R: int = struct.field(pytree_node=False)

    def init(self):
        return jnp.zeros((), jnp.int32)  # phase: index of next kept sample

    @property
    def ratio(self) -> float:
        return 1.0 / self.R

    def step(self, state, x):
        n = x.shape[-1]
        assert n % self.R == 0, "block length must be a multiple of R"
        # select column `state` of the (n//R, R) reshape via a one-hot
        # masked reduction — a take_along_axis with a traced phase lowers
        # to an element-rate gather
        xf = x.reshape(*x.shape[:-1], n // self.R, self.R)
        oh = jnp.arange(self.R) == state
        y = jnp.sum(jnp.where(oh, xf, 0), axis=-1)
        new_phase = (state + 0) % self.R  # phase unchanged when R | n
        return new_phase, y


class FirDecim(Block):
    """Polyphase decimating FIR: filter + keep-1-in-R, computing only kept
    outputs (parity: FiltreRIFDecim, core/src/reechan/polyphase.cc:157-245).

    Design: reshape input to (n/R, R), multiply with the polyphase tap
    matrix (Kp, R) summed over taps via matmul.
    """

    P: jax.Array          # (Kp, R) polyphase taps, P[j, r] = h[j*R + r]
    K: int = struct.field(pytree_node=False)
    R: int = struct.field(pytree_node=False)

    @classmethod
    def create(cls, h, R: int) -> "FirDecim":
        h = np.asarray(h, np.float64)
        K = len(h)
        Kp = (K + R - 1) // R
        P = np.zeros((Kp, R))
        for j in range(Kp):
            for r in range(R):
                if j * R + r < K:
                    P[j, r] = h[j * R + r]
        return cls(P=jnp.asarray(P, real_dtype), K=K, R=R)

    def init(self):
        return jnp.zeros((self.P.shape[0] * self.R,), real_dtype)

    def init_for(self, x):
        dt = complex_dtype if jnp.iscomplexobj(x) else real_dtype
        return jnp.zeros(x.shape[:-1] + (self.P.shape[0] * self.R,), dt)

    @property
    def ratio(self) -> float:
        return 1.0 / self.R

    @property
    def delay(self) -> float:
        return (self.K - 1) / 2 / self.R

    def step(self, state, x):
        n = x.shape[-1]
        R = self.R
        assert n % R == 0, "block length must be a multiple of R"
        Kp = self.P.shape[0]
        hist = Kp * R
        xx = jnp.concatenate([state, x], axis=-1)
        nout = n // R
        # y[m] = sum_k h[k] x[mR - k], k = jR + r.  GATHER-FREE: one
        # reshape gives frames Fr[t, s] = xx[1 + tR + s]; flipping s
        # yields z[t, r] = xx[hist + (t-(Kp-1))R - r], and each polyphase
        # lag j is a STATIC slice of z dotted with tap row P[j] — the
        # fancy-index window gather this replaces lowered to an
        # element-rate gather from device memory (the same pattern
        # RationalResampler avoids)
        Text = nout + Kp - 1
        Fr = xx[..., 1:1 + Text * R].reshape(
            *xx.shape[:-1], Text, R)[..., ::-1]
        hp = jax.lax.Precision.HIGHEST

        def accum(fr, P):
            y = None
            for j in range(Kp):
                seg = jax.lax.slice_in_dim(fr, Kp - 1 - j,
                                           Kp - 1 - j + nout, axis=-2)
                term = jnp.einsum("...mr,r->...m", seg, P[j],
                                  precision=hp)
                y = term if y is None else y + term
            return y

        if jnp.iscomplexobj(Fr):
            pl = jnp.stack([jnp.real(Fr), jnp.imag(Fr)])
            out = accum(pl, self.P)
            y = (out[0] + 1j * out[1]).astype(complex_dtype)
        else:
            y = accum(Fr, self.P.astype(Fr.dtype))
        new_state = xx[..., -hist:]
        return new_state, y


class MovingAverage(Block):
    """K-sample moving average with double accumulation (parity:
    MoyenneGlissante, filtre-rt.cc:634-724, accumulator type param).

    Implemented as cumsum difference per block with carried history —
    O(n) with XLA's parallel prefix sum, no per-sample loop."""

    K: int = struct.field(pytree_node=False)

    def init(self):
        return jnp.zeros((self.K - 1,), real_dtype)

    def init_for(self, x):
        dt = complex_dtype if jnp.iscomplexobj(x) else real_dtype
        return jnp.zeros(x.shape[:-1] + (self.K - 1,), dt)

    @property
    def delay(self) -> float:
        return (self.K - 1) / 2

    def step(self, state, x):
        xx = jnp.concatenate([state, x], axis=-1)
        c = jnp.cumsum(xx.astype(jnp.float32 if not jnp.iscomplexobj(xx)
                                 else complex_dtype), axis=-1)
        zero = jnp.zeros_like(c[..., :1])
        c = jnp.concatenate([zero, c], axis=-1)
        y = (c[..., self.K:] - c[..., :-self.K]) / self.K
        # xx.shape-based slice: [-(K-1):] would be [-0:] for K=1 and
        # grow the state by n every step
        return xx[..., xx.shape[-1] - (self.K - 1):], y.astype(x.dtype)


class ExpSmoother(Block):
    """First-order exponential smoother y = g x + (1-g) y_prev via
    associative scan (parity: FiltreLExp, filtre-rt.cc:726-780)."""

    g: jax.Array

    @classmethod
    def create(cls, gamma: float) -> "ExpSmoother":
        return cls(g=jnp.asarray(gamma, real_dtype))

    def init(self):
        return jnp.zeros((), real_dtype)

    def step(self, state, x):
        y = _first_order_scan(1.0 - self.g, self.g * x, state)
        return y[..., -1], y


class DcBlocker(Block):
    """DC blocker y[n] = r*((x[n] - x[n-1]) + y[n-1]) (parity: FiltreDC,
    filtre-rt.cc:605-633: y(i) = alpha*((x(i) - xp) + yp))."""

    r: jax.Array

    @classmethod
    def create(cls, fc: float) -> "DcBlocker":
        from .iir_design import lexp_coef
        return cls(r=jnp.asarray(1.0 - lexp_coef(fc), real_dtype))

    def init(self):
        # (previous input, previous output)
        return (jnp.zeros((), real_dtype), jnp.zeros((), real_dtype))

    def step(self, state, x):
        x_prev, y_prev = state
        xd = x - jnp.concatenate(
            [jnp.broadcast_to(x_prev, x.shape[:-1] + (1,)), x[..., :-1]],
            axis=-1)
        # y[0] = r*y_prev + r*xd[0]: seed the scan with y_prev DIRECTLY
        # (a y_prev/r seed gave y_prev + r*xd[0] at every block boundary
        # — a (1-r)*y_prev streaming discontinuity vs the one-shot run)
        y = _first_order_scan(self.r, self.r * xd, y_prev)
        return (x[..., -1], y[..., -1]), y


def _first_order_scan(a, b: jax.Array, y0) -> jax.Array:
    """Solve y[n] = a*y[n-1] + b[n] with y[-1] = y0, via associative scan.

    The affine recurrence composes associatively:
    (a1, b1) o (a2, b2) = (a1*a2, a2*b1 + b2).
    """
    n = b.shape[-1]
    a_arr = jnp.broadcast_to(jnp.asarray(a, b.dtype), b.shape)
    b0 = b.at[..., 0].add(a_arr[..., 0] * y0)

    def combine(l, r):
        al, bl = l
        ar, br = r
        return al * ar, ar * bl + br

    _, y = jax.lax.associative_scan(combine, (a_arr, b0), axis=-1)
    return y


class Iir(Block):
    """Direct-form-II IIR from (b, a) coefficients via lax.scan (parity:
    FiltreRII, filtre-rt.cc:178-284).

    For order 1 the associative-scan fast path is used automatically.
    """

    b: jax.Array
    a: jax.Array  # a[0] == 1

    @classmethod
    def create(cls, b, a) -> "Iir":
        b = np.atleast_1d(np.asarray(b, np.float64))
        a = np.atleast_1d(np.asarray(a, np.float64))
        b = b / a[0]
        a = a / a[0]
        n = max(len(b), len(a))
        b = np.pad(b, (0, n - len(b)))
        a = np.pad(a, (0, n - len(a)))
        return cls(b=jnp.asarray(b, real_dtype), a=jnp.asarray(a, real_dtype))

    def init(self):
        return jnp.zeros((self.b.shape[0] - 1,), real_dtype)

    def init_for(self, x):
        dt = complex_dtype if jnp.iscomplexobj(x) else real_dtype
        return jnp.zeros(x.shape[:-1] + (self.b.shape[0] - 1,), dt)

    def step(self, state, x):
        order = self.b.shape[0] - 1
        if order == 0:
            return state, self.b[0] * x
        if order == 1:
            # transposed DF-II, order 1: y[n] = b0 x[n] + w[n-1];
            # w[n] = b1 x[n] - a1 y[n].  Substituting gives the affine
            # recurrence w[n] = -a1 w[n-1] + (b1 - a1 b0) x[n], solved in
            # log-depth by associative scan; then y from w.
            b0, b1, a1 = self.b[0], self.b[1], self.a[1]
            w = _first_order_scan(-a1, (b1 - a1 * b0) * x, state[..., 0])
            wprev = jnp.concatenate(
                [jnp.broadcast_to(state[..., 0:1], x.shape[:-1] + (1,)),
                 w[..., :-1]], axis=-1)
            y = b0 * x + wprev
            return w[..., -1:], y
        return self._scan_step(state, x)

    def _scan_step(self, state, x):
        b, a = self.b, self.a
        order = b.shape[0] - 1

        def body(w, xn):
            # transposed direct form II
            yn = b[0] * xn + w[..., 0]
            wn = jnp.concatenate(
                [w[..., 1:], jnp.zeros_like(w[..., :1])], axis=-1)
            wn = wn + b[1:] * xn[..., None] - a[1:] * yn[..., None]
            return wn, yn

        # scan over the sample axis (move it to front)
        xs = jnp.moveaxis(x, -1, 0)
        state, ys = jax.lax.scan(body, state, xs)
        return state, jnp.moveaxis(ys, 0, -1)


def _iir_frame_mats(b: np.ndarray, a: np.ndarray, L: int = _L):
    """Precompute the frame operators of an LTI recursion (host, float64).

    State-space form (controller-canonical) of y = (b/a)(z) x with state
    s just before each sample: s[n+1] = A s[n] + B x[n], y[n] = C s[n] +
    D x[n].  Over an L-sample frame starting in state s0:

        y[j]  = (C A^j) s0 + sum_{i<=j} h[j-i] x[i]   (h = impulse resp.)
        s_end = A^L s0 + sum_i A^{L-1-i} B x[i]

    so a whole frame is ONE (L,L) lower-triangular Toeplitz matmul
    plus rank-k state terms — exact LTI algebra, no approximation.

    Returns T (L,L) in-frame Toeplitz, S (L,k) state->output, W (k,L)
    with W[:,m] = A^m B (input->state powers; frame update uses its
    flip), Apow (L+1,k,k) powers of A.  All float32, computed in float64.
    """
    b = np.atleast_1d(np.asarray(b, np.float64))
    a = np.atleast_1d(np.asarray(a, np.float64))
    b, a = b / a[0], a / a[0]
    k = max(len(a), len(b)) - 1
    if k == 0:
        raise ValueError("IirFrame needs order >= 1 (a pure gain has no "
                         "state); use iir_filter or Iir for order 0.")
    a = np.pad(a, (0, k + 1 - len(a)))
    bp = np.pad(b, (0, k + 1 - len(b)))
    # controller canonical: A = [[-a1..-ak],[I 0]], B = e0,
    # C[i] = b[i+1] - a[i+1] b0, D = b0
    A = np.zeros((k, k))
    A[0, :] = -a[1:]
    A[1:, :-1] = np.eye(k - 1)
    B = np.zeros(k)
    B[0] = 1.0
    C = bp[1:] - a[1:] * bp[0]
    D = bp[0]
    Apow = np.empty((L + 1, k, k))
    Apow[0] = np.eye(k)
    for m in range(1, L + 1):
        Apow[m] = A @ Apow[m - 1]
    # impulse response h[0]=D, h[m]=C A^{m-1} B
    h = np.empty(L)
    h[0] = D
    for m in range(1, L):
        h[m] = C @ Apow[m - 1] @ B
    i = np.arange(L)
    idx = i[:, None] - i[None, :]
    T = np.where(idx >= 0, h[np.clip(idx, 0, L - 1)], 0.0)
    S = np.stack([C @ Apow[j] for j in range(L)])          # (L, k)
    W = np.stack([Apow[m] @ B for m in range(L)], axis=1)  # (k, L)
    f32 = lambda M: np.asarray(M, np.float32)
    return f32(T), f32(S), f32(W), f32(Apow)


def _affine_matrix_scan(M: jax.Array, u: jax.Array) -> jax.Array:
    """s_m = M s_{m-1} + u_m with s_{-1} folded into u_0; returns all s_m.

    u: (..., nf, k).  Associative in the frame axis: (M1,v1) o (M2,v2) =
    (M2 M1, M2 v1 + v2) — log-depth instead of a length-nf scan.
    """
    nf = u.shape[-2]
    uf = jnp.moveaxis(u, -2, 0)                       # (nf, ..., k)
    Ms = jnp.broadcast_to(M, (nf,) + u.shape[:-2] + M.shape)

    def combine(l, r):
        Ml, vl = l
        Mr, vr = r
        return (jnp.matmul(Mr, Ml, precision=jax.lax.Precision.HIGHEST),
                jnp.einsum("...ij,...j->...i", Mr, vl,
                           precision=jax.lax.Precision.HIGHEST) + vr)

    _, s = jax.lax.associative_scan(combine, (Ms, uf), axis=0)
    return jnp.moveaxis(s, 0, -2)


class IirFrame(Block):
    """Frame-parallel IIR: the data-parallel runtime for order >= 2.

    The per-sample recursion is restated as exact block state-space
    algebra over L=128-sample frames (see _iir_frame_mats): all in-frame
    work becomes one (nframes, L) @ (L, L) matmul, and the only
    sequential dependence left is the k-dimensional state hop between
    frames, solved in log-depth by an associative scan.  Identical
    semantics to `Iir` (same one-shot outputs, same streaming protocol);
    a pure re-design of FiltreRII (filtre-rt.cc:178-284) — the
    reference's per-sample loop has no data-parallel equivalent worth
    keeping.

    State: the k-dim canonical state vector (NOT the DF-II delay line).
    Input length must be a multiple of 128 per step (use `Rebuffer` or
    pad upstream for ragged tails; `iir_filter` handles the tail).
    """

    T: jax.Array      # (L, L) in-frame Toeplitz
    S: jax.Array      # (L, k) state -> in-frame output
    Wf: jax.Array     # (L, k) flipped input -> state-update weights
    M: jax.Array      # (k, k) = A^L frame state hop

    @classmethod
    def create(cls, b, a, L: int = _L) -> "IirFrame":
        T, S, W, Apow = _iir_frame_mats(b, a, L)
        return cls(T=jnp.asarray(T), S=jnp.asarray(S),
                   Wf=jnp.asarray(W[:, ::-1].T.copy()),
                   M=jnp.asarray(Apow[L]))

    @property
    def order(self) -> int:
        return self.S.shape[1]

    def init(self):
        return jnp.zeros((self.order,), real_dtype)

    def init_for(self, x):
        dt = complex_dtype if jnp.iscomplexobj(x) else real_dtype
        return jnp.zeros(x.shape[:-1] + (self.order,), dt)

    def step(self, state, x):
        L = self.T.shape[0]
        n = x.shape[-1]
        assert n % L == 0, f"IirFrame.step needs len(x) % {L} == 0, got {n}"
        if jnp.iscomplexobj(x):
            sr, yr = self.step(jnp.real(state), jnp.real(x))
            si, yi = self.step(jnp.imag(state), jnp.imag(x))
            return sr + 1j * si, yr + 1j * yi
        hp = functools.partial(jnp.matmul,
                               precision=jax.lax.Precision.HIGHEST,
                               preferred_element_type=real_dtype)
        xf = x.reshape(x.shape[:-1] + (n // L, L))
        u = hp(xf, self.Wf)                     # (..., nf, k)
        # fold the incoming state into frame 0's affine term
        u = u.at[..., 0, :].add(
            jnp.einsum("ij,...j->...i", self.M, state,
                       precision=jax.lax.Precision.HIGHEST))
        s_end = _affine_matrix_scan(self.M, u)  # state AFTER each frame
        s_start = jnp.concatenate(
            [state[..., None, :], s_end[..., :-1, :]], axis=-2)
        y = hp(xf, self.T.T) + hp(s_start, self.S.T)
        return s_end[..., -1, :], y.reshape(x.shape)


def iir_filter(b, a, x: jax.Array) -> jax.Array:
    """One-shot IIR (zero initial state), frame-parallel fast path.

    Pads x up to a multiple of 128 internally (zero-padding an LTI filter
    does not change the first len(x) outputs), so any length works.

    Order > 4 is factored into second-order sections first
    (sos_frame_chain) — like any float32 IIR runtime, a high-order
    expanded transfer function is ill-conditioned (measured: order-6
    elliptic 6e-2 rel direct vs 1e-5 as SOS), and the reference itself
    cascades biquads for the same reason (filtre_sois,
    filtre-rt.cc:295-581)."""
    x = jnp.asarray(x)
    n = x.shape[-1]
    a_np = np.atleast_1d(np.asarray(a, np.float64))
    b_np = np.atleast_1d(np.asarray(b, np.float64))
    from ..block import safe_pad
    # leading zeros of b = a pure z^-d delay factor: filter with the
    # trimmed numerator, then shift the output (LTI ops commute)
    nz = np.flatnonzero(b_np)
    if nz.size == 0:
        return jnp.zeros_like(x)
    d = int(nz[0])
    if d:
        y = iir_filter(b_np[d:], a_np, x)
        return safe_pad(y, d, 0, axis=-1)[..., :n]
    order = max(len(a_np), len(b_np)) - 1
    if order == 0:
        return (b_np[0] / a_np[0]) * x
    if order > 4:
        from .iir_design import ZPK, zpk_to_sos
        zpk = ZPK(z=np.roots(b_np / b_np[0]), p=np.roots(a_np / a_np[0]),
                  k=float(b_np[0] / a_np[0]))
        sos, k = zpk_to_sos(zpk)
        blk = sos_frame_chain(sos, k)
        L = blk.blocks[0].T.shape[0]
    else:
        blk = IirFrame.create(b, a)
        L = blk.T.shape[0]
    xp = safe_pad(x, 0, (-n) % L, axis=-1)
    _, y = blk.step(blk.init_for(xp), xp)
    return y[..., :n]


def sos_frame_chain(sos, k: float = 1.0, L: int = _L):
    """Frame-parallel SOS cascade: each second-order section as an
    `IirFrame` (Toeplitz matmul + 2-dim state hop), composed with `Chain`.
    Keeps the cascade's numerical conditioning (no polynomial expansion)
    while replacing the per-sample scan of `Sos` with matmuls.
    """
    from ..block import Chain
    sos = np.asarray(sos, np.float64)
    blocks = []
    for s in range(sos.shape[0]):
        b = sos[s, :3] * (k if s == 0 else 1.0)
        blocks.append(IirFrame.create(b, sos[s, 3:], L=L))
    return Chain(blocks=tuple(blocks))


class Sos(Block):
    """Cascade of second-order sections, transposed DF-II per section,
    single fused scan over samples (parity: SOIS/ChaineSOIS/filtre_sois,
    filtre-rt.cc:295-581).

    sos: (nsec, 6) rows [b0 b1 b2 1 a1 a2]; gain applied once at input.
    """

    sos: jax.Array   # (nsec, 6)
    k: jax.Array     # scalar gain

    @classmethod
    def create(cls, sos, k: float = 1.0) -> "Sos":
        sos = np.asarray(sos, np.float64)
        return cls(sos=jnp.asarray(sos, real_dtype),
                   k=jnp.asarray(k, real_dtype))

    @classmethod
    def from_zpk(cls, zpk) -> "Sos":
        from .iir_design import zpk_to_sos
        sos, k = zpk_to_sos(zpk)
        return cls.create(sos, k)

    def init(self):
        return jnp.zeros((self.sos.shape[0], 2), real_dtype)

    def init_for(self, x):
        dt = complex_dtype if jnp.iscomplexobj(x) else real_dtype
        return jnp.zeros(x.shape[:-1] + (self.sos.shape[0], 2), dt)

    def step(self, state, x):
        sos = self.sos
        nsec = sos.shape[0]
        b0, b1, b2 = sos[:, 0], sos[:, 1], sos[:, 2]
        a1, a2 = sos[:, 4], sos[:, 5]

        def body(w, xn):
            # w: (..., nsec, 2)
            v = self.k * xn
            new_w = []
            for s in range(nsec):
                y = b0[s] * v + w[..., s, 0]
                w0 = b1[s] * v - a1[s] * y + w[..., s, 1]
                w1 = b2[s] * v - a2[s] * y
                new_w.append(jnp.stack([w0, w1], axis=-1))
                v = y
            return jnp.stack(new_w, axis=-2), v

        xs = jnp.moveaxis(x, -1, 0)
        state, ys = jax.lax.scan(body, state, xs)
        return state, jnp.moveaxis(ys, 0, -1)


class OlaFft(Block):
    """Overlap-add FFT-domain block filter with a frequency-domain transform
    callback (parity: filtre_fft / FiltreFFT, fourier.cc:708-935).

    Processes fixed blocks of Ne input samples; each block is zero-padded to
    Nf = next_pow2(Ne + M - 1), transformed, multiplied/transformed by the
    user callback, inverse-transformed, and overlap-added with the carried
    tail.  Streaming: step() input length must be a multiple of Ne.
    """

    H_ri: jax.Array       # (2, Nf) re/im planes of the frequency response
    Ne: int = struct.field(pytree_node=False)
    Nf: int = struct.field(pytree_node=False)
    M: int = struct.field(pytree_node=False)   # filter length (tail M-1)
    complex_taps: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def create(cls, h, Ne: Optional[int] = None) -> "OlaFft":
        """Ne: block (hop) size; by default the one that minimises the
        operation count for this filter length."""
        from .fft import ola_complexity_optimize, next_pow2
        h = np.asarray(h)
        M = len(h)
        if Ne is None:
            _, Nf, _, Ne = ola_complexity_optimize(M)
        else:
            Nf = next_pow2(Ne + M - 1)
        H = np.fft.fft(h, Nf)
        return cls(H_ri=to_ri(H), Ne=Ne, Nf=Nf, M=M,
                   complex_taps=bool(np.iscomplexobj(h)))

    def init(self):
        return jnp.zeros((self.Nf - self.Ne,), complex_dtype)

    def init_for(self, x):
        return jnp.zeros(x.shape[:-1] + (self.Nf - self.Ne,), complex_dtype)

    @property
    def delay(self) -> float:
        return (self.M - 1) / 2

    def step(self, state, x):
        n = x.shape[-1]
        Ne, Nf = self.Ne, self.Nf
        assert n % Ne == 0, "input must be a multiple of Ne"
        nblk = n // Ne
        is_complex = jnp.iscomplexobj(x)
        xb = x.reshape(*x.shape[:-1], nblk, Ne)
        X = jnp.fft.fft(xb.astype(complex_dtype), n=Nf, axis=-1)
        Y = X * from_ri(self.H_ri)
        yb = jnp.fft.ifft(Y, axis=-1)  # (..., nblk, Nf)
        # overlap-add: carry tail of length Nf-Ne across blocks.
        # carry_padded = [carry, 0...Ne zeros]; out = yrow[:Ne] + carry_p[:Ne];
        # new carry = carry_p[Ne:] + yrow[Ne:].  Handles tail_len ><= Ne.
        def body(tail, yrow):
            from ..block import safe_pad
            tail_p = safe_pad(tail, 0, Ne)
            out = yrow[..., :Ne] + tail_p[..., :Ne]
            new_tail = tail_p[..., Ne:] + yrow[..., Ne:]
            return new_tail, out

        ybm = jnp.moveaxis(yb, -2, 0)  # (nblk, ..., Nf)
        state, ys = jax.lax.scan(body, state, ybm)
        y = jnp.moveaxis(ys, 0, -2).reshape(*x.shape[:-1], n)
        # complex TAPS on a real signal still produce a complex response
        # (analytic/matched filters) — only drop the imaginary part when
        # both signal and taps are real
        if not is_complex and not self.complex_taps:
            y = jnp.real(y)
        return state, y


class FirFft(OlaFft):
    """FIR filtering through the OLA engine (parity: filtre_rif_fft,
    fourier.cc:974-1010)."""
    pass


def _as_design(h):
    """Normalize a filter spec: taps array -> FIR; (b, a) tuple or ZPK ->
    IIR (parity: the reference's Design accepting RIF coefs or an FRat,
    filtrage.hpp:1684-1782)."""
    if isinstance(h, tuple) and len(h) == 2:
        return ("iir", h[0], h[1])
    # duck-type ZPK from ops.iir_design
    if hasattr(h, "to_ba") and hasattr(h, "p"):
        b, a = h.to_ba()
        return ("iir", b, a)
    return ("fir", h, None)


def filter_signal(h, x: jax.Array, mode: str = "direct") -> jax.Array:
    """One-shot filtering (parity: filtrer one-shot wrappers,
    filtrage.hpp:1684-1744).  h may be FIR taps, a (b, a) tuple, or a
    ZPK design (IIR routed through the frame-parallel runtime);
    mode="fft" selects the OLA FFT path (FIR only)."""
    kind, b, a = _as_design(h)
    if kind == "iir":
        return iir_filter(b, a, x)
    if mode == "fft":
        h = np.asarray(h)
        blk = OlaFft.create(h)
        n = x.shape[-1]
        from ..block import pad_to_multiple
        xp = pad_to_multiple(x, blk.Ne, axis=x.ndim - 1)
        _, y = blk.step(blk.init_for(xp), xp)
        return y[..., :n]
    return fir_filter(h, x)


def filtfilt(h, x: jax.Array) -> jax.Array:
    """Zero-phase forward-backward filtering, FIR or IIR (parity:
    filtfilt, filtrage.hpp:1663-1782)."""
    kind, b, a = _as_design(h)
    one = (lambda v: iir_filter(b, a, v)) if kind == "iir" \
        else (lambda v: fir_filter(h, v))
    y = one(x)
    y = jnp.flip(y, axis=-1)
    y = one(y)
    return jnp.flip(y, axis=-1)
