"""Base signal toolbox: generators and vector utilities (JAX, jit-able).

Parity: core/include/tsd/tsd.hpp:103-1360, core/src/tsd.cc.

Generators take a normalized frequency f in [-1/2, 1/2] (cycles/sample) and a
length n, like the reference (tsd.hpp:1113-1236).  The reference uses a
recursive harmonic oscillator for speed on CPU; on a data-parallel device a
direct vectorized evaluation is both faster and drift-free, so that is the
implementation here
(behavior parity, not implementation parity — tsd.cc:179-300).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .. import struct

from ..block import Block
from ..config import complex_dtype, real_dtype

__all__ = [
    "cycles",
    "sigexp", "sigsin", "sigcos", "sigtri", "sigsquare", "sigsawtooth",
    "sigimp", "siggsin", "siggauss", "sigchirp", "signyquist",
    "linspace", "logspace", "irange",
    "diff", "cumsum", "unwrap_phase",
    "db2mag", "mag2db", "db2pow", "pow2db",
    "wrap_2pi", "wrap_pm_pi",
    "downsample", "upsample", "zero_pad", "rotate_vec",
    "find", "find_first", "find_last", "find_first_local_max",
    "length_match", "sample_hold", "trange",
    "sinc", "NCO", "nco_phase", "sliding_frames",
]


# ---------------------------------------------------------------- generators

def _k(n: int) -> jax.Array:
    return jnp.arange(n, dtype=real_dtype)


def cycles(f, n: int) -> jax.Array:
    """Wrapped cycle ramp (f*k) mod 1 for k = 0..n-1, as accurately as the
    input allows.

    For a host scalar f the product is formed in float64 and reduced mod 1
    BEFORE the float32 cast, so the phase argument handed to sin/cos stays
    in [0, 2*pi) at full float32 precision for ANY n.  (The float32 product
    f*k alone already has ~1e-5-cycle error by k ~ 2000 — the reference's
    double-precision recursive oscillators, tsd.cc:583-600, do not, and
    golden diffs against the binary exposed the gap.)  A traced f falls
    back to float32 mod on device.
    """
    import numpy as _np
    if isinstance(f, (int, float, _np.floating, _np.integer)):
        if n <= (1 << 16):
            c = _np.mod(_np.float64(f) * _np.arange(n, dtype=_np.float64),
                        1.0)
            return jnp.asarray(c, real_dtype)
        # large n: two host-f64-exact tables summed on device —
        # mod(f*(q*L + r), 1) = mod(t1[q] + t0[r], 1) with both terms
        # individually reduced in f64.  Keeps the baked trace constants
        # tiny (~(n/L + L) floats instead of n) at the same ~1-ulp
        # accuracy; the (nq, L) broadcast sum is output-sized work
        L = 4096
        nq = -(-n // L)
        t0 = _np.mod(_np.float64(f) * _np.arange(L, dtype=_np.float64),
                     1.0)
        t1 = _np.mod(_np.float64(f) * L * _np.arange(nq,
                                                     dtype=_np.float64),
                     1.0)
        c = jnp.mod(jnp.asarray(t1, real_dtype)[:, None]
                    + jnp.asarray(t0, real_dtype)[None, :], 1.0)
        return c.reshape(-1)[:n]
    return jnp.mod(jnp.asarray(f, real_dtype) * _k(n), 1.0)


def sigexp(f: float, n: int) -> jax.Array:
    """y_k = exp(2*pi*i*k*f) (parity: tsd.hpp:1113)."""
    return jnp.exp(2j * jnp.pi * cycles(f, n)).astype(complex_dtype)


def sigsin(f: float, n: int) -> jax.Array:
    """y_k = sin(2*pi*k*f) (parity: tsd.hpp:1134)."""
    return jnp.sin(2 * jnp.pi * cycles(f, n))


def sigcos(f: float, n: int) -> jax.Array:
    """y_k = cos(2*pi*k*f) (parity: tsd.hpp:1155)."""
    return jnp.cos(2 * jnp.pi * cycles(f, n))


def sigtri(p: int, n: int) -> jax.Array:
    """Periodic triangle, period p samples, range [-1,1], starts at 1
    (parity: tsd.hpp:1169, tsd.cc)."""
    k = jnp.arange(n)
    ph = (k % p).astype(real_dtype) / p  # [0,1)
    return 1.0 - 4.0 * jnp.minimum(ph, 1.0 - ph)


def sigsquare(p: int, n: int) -> jax.Array:
    """Periodic square wave, period p samples (parity: sigcar, tsd.hpp:1182)."""
    k = jnp.arange(n)
    return jnp.where((k % p) < (p + 1) // 2, 1.0, -1.0).astype(real_dtype)


def sigsawtooth(p: int, n: int) -> jax.Array:
    """Sawtooth, period p, -1..1 (parity: sigscie, tsd.hpp:1208)."""
    k = jnp.arange(n)
    ph = (k % p).astype(real_dtype) / max(p - 1, 1)
    return 2.0 * ph - 1.0


def sigimp(n: int, p: int = 0) -> jax.Array:
    """Discrete impulse at position p (parity: tsd.hpp:1194)."""
    return (jnp.arange(n) == p).astype(real_dtype)


def siggauss(n: int, a: float = 10.0) -> jax.Array:
    """Gaussian pulse exp(-a*((k-N/2)/(N/2))^2) (parity: tsd.hpp:1249)."""
    k = _k(n)
    t = (k - n / 2) / (n / 2)
    return jnp.exp(-a * t * t)


def siggsin(f: float, n: int, a: float = 10.0) -> jax.Array:
    """Gaussian-windowed sine (parity: tsd.hpp:1236)."""
    return siggauss(n, a) * sigsin(f, n)


def sigchirp(f0: float, f1: float, n: int, mode: str = "l") -> jax.Array:
    """Linear ('l') or quadratic ('q') chirp: x_k = cos(2*pi*cumsum(f_k))
    (parity: tsd.hpp:1297, instantaneous frequency swept f0 -> f1)."""
    k = _k(n) / max(n - 1, 1)
    if mode == "l":
        f = f0 + (f1 - f0) * k
    elif mode == "q":
        f = f0 + (f1 - f0) * k * k
    else:
        raise ValueError("mode must be 'l' or 'q'")
    phase = 2 * jnp.pi * jnp.cumsum(f)
    return jnp.cos(phase)


def signyquist(n: int) -> jax.Array:
    """Alternating -1,1,-1,1,... (parity: tsd.hpp:1316, starts at -1)."""
    return jnp.where(jnp.arange(n) % 2 == 0, -1.0, 1.0).astype(real_dtype)


# ------------------------------------------------------------------ ranges

def linspace(a: float, b: float, n: int) -> jax.Array:
    return jnp.linspace(a, b, n, dtype=real_dtype)


def logspace(a: float, b: float, n: int) -> jax.Array:
    """n log-spaced points from a to b (absolute values, not exponents —
    parity: tsd.hpp logspace)."""
    return jnp.logspace(jnp.log10(a), jnp.log10(b), n, dtype=real_dtype)


def irange(a: int, b: int) -> jax.Array:
    """Integer range a..b inclusive (parity: intervalle_entier)."""
    return jnp.arange(a, b + 1)


# ------------------------------------------------------------- differences

def diff(x: jax.Array) -> jax.Array:
    """First difference, length n-1 (parity: tsd.hpp diff)."""
    return x[1:] - x[:-1]


def cumsum(x: jax.Array) -> jax.Array:
    return jnp.cumsum(x)


def unwrap_phase(x: jax.Array) -> jax.Array:
    """Unwrap phase jumps > pi (parity: déplie_phase, tsd.hpp)."""
    return jnp.unwrap(x)


# ------------------------------------------------------------------- dB

def db2mag(x):
    return 10.0 ** (jnp.asarray(x) / 20.0)


def mag2db(x):
    return 20.0 * jnp.log10(jnp.asarray(x))


def db2pow(x):
    return 10.0 ** (jnp.asarray(x) / 10.0)


def pow2db(x):
    return 10.0 * jnp.log10(jnp.asarray(x))


# --------------------------------------------------------------- wrapping

def wrap_2pi(x):
    """Wrap to [0, 2*pi) (parity: modulo_2π)."""
    two_pi = 2 * jnp.pi
    return jnp.mod(x, two_pi)


def wrap_pm_pi(x):
    """Wrap to [-pi, pi) (parity: modulo_pm_π)."""
    return jnp.mod(x + jnp.pi, 2 * jnp.pi) - jnp.pi


# ------------------------------------------------------------- re-sampling

def downsample(x: jax.Array, r: int, phase: int = 0) -> jax.Array:
    """Keep one sample in r (parity: sousech, tsd.hpp)."""
    return x[phase::r]


def upsample(x: jax.Array, r: int) -> jax.Array:
    """Insert r-1 zeros between samples (parity: surech, tsd.hpp)."""
    n = x.shape[0]
    y = jnp.zeros((n, r), dtype=x.dtype)
    y = y.at[:, 0].set(x)
    return y.reshape(n * r)


def sample_hold(x: jax.Array, r: int) -> jax.Array:
    """Repeat each sample r times — zero-order hold (parity: sah,
    dsp/telecom.hpp:513)."""
    return jnp.repeat(x, r, axis=0)


def trange(n: int, fs: float) -> jax.Array:
    """Time vector of n samples at rate fs: k/fs (parity:
    intervalle_temporel, tsd.hpp:989)."""
    return jnp.arange(n, dtype=real_dtype) / fs


def zero_pad(x: jax.Array, n: int) -> jax.Array:
    """Pad with zeros to total length n."""
    if n <= x.shape[0]:
        return x[:n]
    from ..block import safe_pad
    return safe_pad(x, 0, n - x.shape[0], axis=0)


def rotate_vec(x: jax.Array, k: int) -> jax.Array:
    """Circular rotation by k (parity: rotation_vec, tsd.hpp)."""
    return jnp.roll(x, -k)


def length_match(x: jax.Array, y: jax.Array):
    """Zero-pad the shorter of two vectors so lengths match."""
    n = max(x.shape[0], y.shape[0])
    return zero_pad(x, n), zero_pad(y, n)


# ------------------------------------------------------------------ find

def find(mask: jax.Array, size: Optional[int] = None, fill: int = -1) -> jax.Array:
    """Indices where mask is true (parity: trouve, tsd.hpp).  Under jit a
    static ``size`` is required; extra slots are ``fill``."""
    if size is None:
        return jnp.where(mask)[0]
    return jnp.where(mask, size=size, fill_value=fill)[0]


def find_first(mask: jax.Array) -> jax.Array:
    """Index of first true element, -1 if none (parity: trouve_premier)."""
    idx = jnp.argmax(mask)
    return jnp.where(jnp.any(mask), idx, -1)


def find_last(mask: jax.Array) -> jax.Array:
    """Index of last true element, -1 if none (parity: trouve_dernier,
    tsd.hpp:322)."""
    n = mask.shape[0]
    idx = n - 1 - jnp.argmax(mask[::-1])
    return jnp.where(jnp.any(mask), idx, -1)


def find_first_local_max(x: jax.Array) -> jax.Array:
    """Index of the first interior STRICT local maximum
    x[i-1] < x[i] > x[i+1], -1 if none — plateaus don't count, matching
    the reference exactly (parity: trouve_premier_max_local,
    tsd.hpp:327)."""
    if x.shape[0] < 3:
        return jnp.asarray(-1)
    interior = (x[1:-1] > x[:-2]) & (x[1:-1] > x[2:])
    idx = find_first(interior)
    return jnp.where(idx >= 0, idx + 1, -1)


# ------------------------------------------------------------------- misc

def sinc(x):
    """Normalized-in-the-DSP-sense sinc: sin(pi x)/(pi x)
    (parity: tsd::sinc, core/src/divers.cc:6-30)."""
    return jnp.sinc(x)


def nco_phase(freq: jax.Array, n: int, phase0: jax.Array = 0.0) -> jax.Array:
    """Phase ramp 2*pi*f*k + phase0, wrapped — building block for
    oscillators.  The ramp is reduced in CYCLES before scaling to radians
    (an unreduced float32 radian ramp loses ~0.1 rad by k ~ 1e6)."""
    k = jnp.arange(n, dtype=real_dtype)
    cyc = jnp.mod(jnp.asarray(freq, real_dtype) * k, 1.0)
    return wrap_pm_pi(phase0 + 2 * jnp.pi * cyc)


class NCO(Block):
    """Streaming complex oscillator source: z_k = exp(2*pi*i*(k0+k)*f).

    Parity: source_ohc / source_ohr (tsd.hpp:1318-1356, tsd.cc:547+).  State
    is the accumulated phase (wrapped), so arbitrarily long streams do not
    drift — an improvement over the reference's recursive oscillator which
    documents gain/phase drift for large n.

    ``step`` input is the block length request encoded by an integer-shaped
    dummy array; more usefully, use :meth:`gen` with a static n.
    """

    # STATIC frequency (host float64): the per-block phase increment
    # (freq * n) mod 1 is then computed exactly at trace time — the
    # actual no-drift guarantee.  (A traced float32 frequency cannot
    # reduce freq*n mod 1 without ~1e-5-cycle/block systematic drift.)
    freq: float = struct.field(pytree_node=False, default=0.0)

    @classmethod
    def create(cls, freq: float) -> "NCO":
        return cls(freq=float(freq))

    def init(self):
        return jnp.zeros((), real_dtype)  # current phase in radians

    def gen(self, state, n: int):
        # in-block ramp reduced in CYCLES (mod 1) — an unreduced
        # 2*pi*f*k float32 ramp drifts ~0.5 rad per 1e7 samples
        k = jnp.arange(n, dtype=real_dtype)
        cyc = jnp.mod(jnp.asarray(self.freq, real_dtype) * k, 1.0)
        ph = state + 2 * jnp.pi * cyc
        new_state = wrap_pm_pi(
            state + jnp.asarray(2 * jnp.pi * ((self.freq * n) % 1.0),
                                real_dtype))
        return new_state, jnp.exp(1j * ph).astype(complex_dtype)

    def step(self, state, x):
        """Mix input with the oscillator (x * exp(i*phase)) — the typical
        downconversion use; produces same-length output."""
        assert x.ndim >= 1, "NCO.step mixes a sample block, not a scalar"
        state, lo = self.gen(state, x.shape[-1])
        return state, x * lo


def sliding_frames(x: jax.Array, width: int, hop: int,
                   nframes: int) -> jax.Array:
    """Overlapping frames, gather-free: (..., nframes, width) where frame
    j = x[..., j*hop : j*hop + width].

    An index-array window take lowers to an element-rate gather; this
    builds the frames from ceil(width/hop) static shifted slices of the
    hop-column reshape instead (vectorized copies).
    Zero-pads x internally as needed; callers must not rely on values
    past ``(nframes-1)*hop + width``."""
    from ..block import safe_pad
    S = -(-width // hop)
    total = (nframes + S - 1) * hop
    n = x.shape[-1]
    if total > n:
        x = safe_pad(x, 0, total - n, axis=-1)
    xr = x[..., :total].reshape(*x.shape[:-1], nframes + S - 1, hop)
    return jnp.concatenate(
        [jax.lax.slice_in_dim(xr, s, s + nframes, axis=-2)
         for s in range(S)], axis=-1)[..., :width]
