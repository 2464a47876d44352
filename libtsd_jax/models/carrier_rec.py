"""Carrier (phase/frequency) recovery: loop filters, phase-error detectors,
PLLs, FFT-based coarse frequency estimation.

Parity: core/src/telecom/carrier-rec.cc and
core/include/tsd/telecom.hpp:774-792.

The per-sample PLL is a `lax.scan` (irreducible feedback, SURVEY
hard-part #1); PEDs are pure functions usable inside any scan.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..block import Block
from ..config import complex_dtype, real_dtype
from ..ops.signal import cycles

__all__ = [
    "LoopFilter1", "LoopFilter2", "ped_costas", "ped_ploop", "ped_tloop",
    "ped_decision", "make_ped", "Cpll", "CpllConfig", "Rpll",
    "peak_frequency",
]


# ------------------------------------------------------------ loop filters

@dataclasses.dataclass(frozen=True)
class LoopFilter1:
    """First-order loop: theta += alpha * e (parity: LF1,
    carrier-rec.cc:38-56; alpha from time constant)."""
    tau: float = 10.0

    @property
    def alpha(self) -> float:
        from ..ops.iir_design import lexp_tc_to_coef
        return lexp_tc_to_coef(self.tau)

    def init(self):
        return jnp.zeros((), real_dtype)  # theta

    def step(self, st, e):
        theta = st + self.alpha * e
        return theta, theta


@dataclasses.dataclass(frozen=True)
class LoopFilter2:
    """Second-order loop (parity: LF2, carrier-rec.cc:13-36):
    gamma = 16 eta^2 BL / (1+4 eta^2); rho = 4 BL / (1+4 eta^2);
    theta += mu; mu += gamma ((1+rho) e - e_prev)."""
    BL: float = 0.01
    eta: float = 1.0

    @property
    def gamma(self) -> float:
        return (16 * self.eta ** 2 * self.BL) / (1 + 4 * self.eta ** 2)

    @property
    def rho(self) -> float:
        return (4 * self.BL) / (1 + 4 * self.eta ** 2)

    def init(self):
        return (jnp.zeros((), real_dtype),  # theta
                jnp.zeros((), real_dtype),  # mu
                jnp.zeros((), real_dtype))  # last ped

    def step(self, st, e):
        theta, mu, last = st
        theta = theta + mu
        mu = mu + self.gamma * ((1 + self.rho) * e - last)
        return (theta, mu, e), theta


# --------------------------------------------------------------- PEDs

def ped_costas(M: int) -> Callable:
    """Costas loop PED for BPSK/QPSK (parity: ped_costa,
    carrier-rec.cc:70-97)."""
    if M == 2:
        return lambda x: jnp.real(x) * jnp.imag(x)
    assert M == 4

    def f(x):
        z = x * jnp.exp(1j * jnp.pi / 4).astype(complex_dtype)
        return (jnp.imag(z) * jnp.sign(jnp.real(z))
                - jnp.real(z) * jnp.sign(jnp.imag(z)))
    return f


def _ref_rot(ref, M):
    """conj(ref^M)/|ref^M| as a traced complex scalar (ref may be a traced
    constellation point — no host conversion allowed)."""
    r = jnp.asarray(ref) ** M
    mag = jnp.abs(r)
    return jnp.where(mag > 1e-9, jnp.conj(r) / jnp.maximum(mag, 1e-9),
                     jnp.asarray(1.0 + 0j, complex_dtype))


def ped_ploop(M: int, ref=1.0 + 0j) -> Callable:
    """Power loop: Im(x^M * conj(ref^M))/M (parity: ped_ploop,
    carrier-rec.cc:98-105; needs an AGC upstream).

    ``ref`` is an ideal constellation point — x^M must be derotated by the
    constellation's M-th-power phase (e.g. QPSK at pi/4 offsets has
    ref^4 = -1), otherwise the loop locks 45 degrees off.
    """
    def f(x):
        return jnp.imag(x ** M * _ref_rot(ref, M)) / M
    return f


def ped_tloop(M: int, ref=1.0 + 0j) -> Callable:
    """Tan loop: arg(x^M * conj(ref^M))/M (parity: ped_tloop,
    carrier-rec.cc:106-113)."""
    def f(x):
        xm = x ** M * _ref_rot(ref, M)
        return jnp.where(jnp.abs(x) > 0,
                         jnp.angle(xm) / M, 0.0).astype(real_dtype)
    return f


def ped_decision(wf) -> Callable:
    """Decision-directed PED: arg(x * conj(nearest symbol)) (parity:
    ped_decision, carrier-rec.cc:114-123).

    For rotating constellations (pi/4-QPSK) the union constellation is used
    so the PED is parity-free."""
    symbols = wf.constellation() if getattr(wf, "rotating", False)         else wf.symbols

    def f(x):
        d = jnp.abs(x - symbols) ** 2
        s = symbols[jnp.argmin(d)]
        c = x * jnp.conj(s)
        return jnp.where(jnp.abs(c) > 0, jnp.angle(c), 0.0).astype(real_dtype)
    return f


def make_ped(kind: str, wf=None, M: Optional[int] = None) -> Callable:
    """Parity: ped_init, carrier-rec.cc:126-154 (incl. AUTO selection)."""
    if M is None and wf is not None:
        M = wf.info.M
        if wf.info.is_ask:
            M = 2
    if kind == "auto":
        if wf is not None and wf.info.is_psk:
            kind = "ploop"
        elif wf is not None and wf.info.is_ask:
            kind = "tloop"
        else:
            kind = "dec"
    ref = 1.0 + 0j
    if wf is not None:
        # traced constellation point (stays on device)
        ref = wf.symbols[wf.info.M - 1 if wf.info.is_ask else 0]
    if kind in ("costa", "costas"):
        return ped_costas(M)
    if kind == "ploop":
        return ped_ploop(M, ref)
    if kind == "tloop":
        return ped_tloop(M, ref)
    if kind in ("dec", "decision"):
        return ped_decision(wf)
    raise ValueError(f"unknown PED {kind!r}")


# ---------------------------------------------------------------- PLLs

@dataclasses.dataclass(frozen=True)
class CpllConfig:
    """Complex PLL config (parity: PLLConfig, telecom.hpp).

    M: PED nonlinearity order; None (default) derives it from the
    waveform when one is attached to the Cpll (e.g. QPSK -> 4), falling
    back to 2 — an explicit value always wins."""
    ped: str = "costas"
    M: Optional[int] = None
    order: int = 2
    BL: float = 0.01      # normalized loop bandwidth (order 2)
    eta: float = 1.0
    tau: float = 10.0     # time constant (order 1)


class Cpll(Block):
    """Complex PLL: y[n] = x[n] * exp(-i theta[n]); theta from PED + loop
    filter (parity: CPLL, carrier-rec.cc:295-384)."""

    cfg: CpllConfig = struct.field(pytree_node=False)
    wf: Optional[object] = None

    @property
    def _lf(self):
        return (LoopFilter2(self.cfg.BL, self.cfg.eta)
                if self.cfg.order == 2 else LoopFilter1(self.cfg.tau))

    @property
    def _ped(self):
        # cfg.M None -> make_ped derives the order from the waveform
        # (wf=QPSK -> M=4); a PED with the wrong M would not strip the
        # modulation and the loop could never lock
        M = self.cfg.M
        if M is None and self.wf is None:
            M = 2
        return make_ped(self.cfg.ped, wf=self.wf, M=M)

    def init(self):
        return self._lf.init()

    def step(self, state, x: jax.Array, valid: Optional[jax.Array] = None):
        """valid: optional per-sample mask; the loop FREEZES on invalid
        entries (e.g. the zero-padded tail of a clock-recovery block) —
        without it each pad entry would advance theta by mu and clobber
        the loop registers with a zero-input error."""
        lf = self._lf
        ped = self._ped

        def body(st, inp):
            xi, v = inp
            # apply current phase estimate, then update
            theta = st[0] if isinstance(st, tuple) else st
            y = xi * jnp.exp(-1j * theta).astype(complex_dtype)
            e = ped(y)
            st2, _ = lf.step(st, e)
            st = jax.tree_util.tree_map(
                lambda a, b: jnp.where(v, a, b), st2, st)
            return st, y

        if valid is None:
            valid = jnp.ones(x.shape, bool)
        state, y = jax.lax.scan(body, state, (x, valid))
        return state, y

    def _grouped_lf(self, G: int):
        """Loop filter with the per-update bandwidth rescaled by the
        group size (one shared definition for the PED and data-aided
        grouped paths — the stability cap must not diverge between
        them)."""
        cfg = self.cfg
        return (LoopFilter2(min(0.2, cfg.BL * G), cfg.eta)
                if cfg.order == 2 else LoopFilter1(max(1.0, cfg.tau / G)))

    def step_grouped(self, state, x: jax.Array, G: int,
                     err_fn=None, aux: tuple = ()):
        """PLL with one loop update per GROUP of ``G`` symbols: the
        current phase is applied to the whole group, the per-symbol
        errors are averaged, and the loop filter advances once.
        Sequential scan length drops from n to ceil(n/G) — the lever
        that makes the frame receiver's residual-phase tracking ~G x
        shorter in its sequential dependency chain (the dominant
        per-step cost at small batch).  The per-symbol loop bandwidth is
        preserved by scaling the per-update bandwidth by G (capped for
        stability); within a group the phase is a zero-order hold, so a
        residual frequency offset f leaves a bounded staircase error
        ~pi*G*f (choose G so G*f << 1 — frame receivers apply this AFTER
        the header-derived phase correction, where f is the small
        uncorrected residue).

        ``err_fn(y, *aux_elems)``: optional per-symbol error function
        replacing the configured PED (used by step_aided); ``aux`` are
        same-length arrays zipped alongside x (padded/grouped with it).
        """
        if G <= 1 and err_fn is None:
            return self.step(state, x)
        lf = self._grouped_lf(G) if G > 1 else self._lf
        ped = self._ped
        if err_fn is None:
            err_fn = lambda y: ped(y)
        n = x.shape[-1]
        ng = -(-n // G)
        # pad by repeating the last entry: err_fn(edge value) keeps the
        # mean error sane (zeros would inject a bogus error term)
        pad = ng * G - n

        def prep(a):
            if pad:
                a = jnp.concatenate(
                    [a, jnp.broadcast_to(a[..., -1:], (pad,))])
            return a.reshape(ng, G)

        xs = prep(x)
        auxs = tuple(prep(a) for a in aux)

        def body(st, inp):
            xg = inp[0]
            ag = inp[1:]
            theta = st[0] if isinstance(st, tuple) else st
            y = xg * jnp.exp(-1j * theta).astype(complex_dtype)
            # vmap: the PEDs are written for scalar symbols (the
            # decision PED broadcasts against the constellation)
            e = jnp.mean(jax.vmap(err_fn)(y, *ag))
            st, _ = lf.step(st, e)
            return st, y

        state, yg = jax.lax.scan(body, state, (xs,) + auxs)
        return state, yg.reshape(-1)[:n]

    def step_aided(self, state, x: jax.Array, ref: jax.Array,
                   ref_mask: jax.Array, G: int = 1):
        """PLL step with per-symbol data-aided phase errors where
        ``ref_mask`` is True: e = arg(y * conj(ref)) against the KNOWN
        symbol ``ref`` (e.g. a frame's sync header), falling back to the
        configured PED elsewhere.  Used by the frame receiver when the
        header rides a different waveform than the payload (fo_entete,
        telecom.hpp:1214): the payload-constellation PED would compute
        nonsense decisions on the header symbols, but the header symbols
        are known exactly — data-aided tracking there is strictly
        better.

        ``G > 1`` delegates to step_grouped (one update per G symbols,
        bandwidth rescaled) so Receiver(pll_stride=G) shortens the
        sequential chain on fo_entete frames too."""
        ped = self._ped

        def err(y, r, use_r):
            e_dd = ped(y)
            # guard |ref| ~ 0 (angle(0) is 0 but keep the branch safe)
            e_da = jnp.angle(y * jnp.conj(r)
                             + jnp.asarray(1e-30, complex_dtype))
            return jnp.where(use_r, e_da, e_dd)

        if G > 1:
            return self.step_grouped(state, x, G, err_fn=err,
                                     aux=(ref, ref_mask))
        lf = self._lf

        def body(st, inp):
            xi, r, use_r = inp
            theta = st[0] if isinstance(st, tuple) else st
            y = xi * jnp.exp(-1j * theta).astype(complex_dtype)
            st, _ = lf.step(st, err(y, r, use_r))
            return st, y

        state, y = jax.lax.scan(body, state, (x, ref, ref_mask))
        return state, y


class Rpll(Block):
    """Real-input PLL: downconvert by a nominal frequency, baseband image
    lowpass, then the complex PLL (parity: RPLL, carrier-rec.cc:201-293,
    including the design_rif_cs baseband filter).

    ``regen_carrier=True`` additionally upconverts the locked baseband
    replica back to the carrier frequency and returns its real part
    (``real(conj(osc) * cpll_out)``, carrier-rec.cc:242-253) — the
    regenerated-carrier output used e.g. for the 19 kHz stereo pilot in
    broadcast FM.  Default False returns the locked baseband signal."""

    cpll: Cpll
    bb_filter: "object"
    freq: float = struct.field(pytree_node=False, default=0.25)
    regen_carrier: bool = struct.field(pytree_node=False, default=False)

    @classmethod
    def create(cls, freq: float, cfg: Optional[CpllConfig] = None,
               bb_cut: float = 0.1, ncoefs_bb: int = 63,
               regen_carrier: bool = False) -> "Rpll":
        from ..ops.fir_design import raised_cosine
        from ..ops.filter_rt import Fir
        h = raised_cosine(ncoefs_bb, 0.1, bb_cut / 2)
        return cls(cpll=Cpll(cfg=cfg or CpllConfig(ped="tloop", M=1,
                                                   order=2, BL=0.02)),
                   bb_filter=Fir.create(h), freq=freq,
                   regen_carrier=regen_carrier)

    def init(self):
        return (jnp.zeros((), real_dtype),
                self.bb_filter.init_for(jnp.zeros((0,), complex_dtype)),
                self.cpll.init())

    def step(self, state, x: jax.Array):
        ph, fst, pst = state
        n = x.shape[-1]
        # NCO phase in CYCLES, host-f64-exact ramp (signal.cycles —
        # the earlier on-device f32 product lost ~0.016 cycles by k~1e6
        # despite this comment claiming otherwise)
        cyc = ph / (2 * jnp.pi) + cycles(self.freq, n)
        lo = jnp.exp(-2j * jnp.pi * cyc)
        xb = x.astype(complex_dtype) * lo.astype(complex_dtype)
        ph = jnp.mod(ph + 2 * jnp.pi * ((self.freq * n) % 1.0),
                     2 * jnp.pi)
        # image rejection (the 2f mixing product) before the loop
        fst, xb = self.bb_filter.step(fst, xb)
        pst, y = self.cpll.step(pst, xb)
        if self.regen_carrier:
            y = jnp.real(jnp.conj(lo).astype(complex_dtype) * y)
        return (ph, fst, pst), y


# ----------------------------------------------- coarse frequency tracking

def peak_frequency(x: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Estimate dominant frequency by FFT peak with barycentric refinement;
    returns (freq, snr) (parity: localise_pic_frequence / SuiviPicFrequence,
    carrier-rec.cc:155-199)."""
    n = x.shape[-1]
    X = jnp.fft.fft(x.astype(complex_dtype))
    a2 = jnp.abs(X) ** 2
    i2 = jnp.argmax(a2)
    snr = a2[i2] / jnp.mean(a2)
    y1 = a2[(i2 - 1) % n]
    y2 = a2[i2]
    y3 = a2[(i2 + 1) % n]
    i2s = jnp.where(i2 >= n // 2, i2 - n, i2).astype(real_dtype)
    d = (y3 - y1) / (y1 + y2 + y3 + 1e-30)
    return (i2s + d) / n, snr
