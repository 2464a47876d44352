"""Clock (symbol timing) recovery.

Parity: core/src/telecom/clock-rec.cc (TEDs :11-95, ClockRec :97-392) and
core/include/tsd/telecom.hpp:703-745 (ClockRecConfig).

Design: the per-sample feedback loop is irreducibly sequential
(SURVEY hard-part #1), so it runs as a `lax.scan` over input samples at the
*input* rate, kept cheap (a LUT gather + dot per step) and batched across
channels via `vmap`.  Output symbols are emitted with a validity mask and
compacted by scatter — static shapes throughout.

Loop structure per input sample (parity: ClockRec::step,
clock-rec.cc:186-310):
  phase -= 1; push sample into interpolator window
  if phase < 1:
      y = interp(window, frac(phase));  phase += K1/K2
      every K2-th interpolation -> output symbol;
      TED e = Re((x2-x0)*conj(x1));  phase -= clamp(gain*e, +-K1/4)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..block import Block
from ..config import complex_dtype, real_dtype
from ..ops.resample import Interpolator, make_interpolator

__all__ = ["ted_gardner", "ted_mm", "ted_early_late",
           "ClockRecConfig", "ClockRec", "clock_rec"]


def ted_gardner(x0, x1, x2):
    """Gardner timing error detector (parity: TedGardner,
    clock-rec.cc:61-77): e = Re((x2 - x0) * conj(x1)) with x0/x2 the
    previous/current symbol samples and x1 the midpoint."""
    return jnp.real((x2 - x0) * jnp.conj(x1))


def _slicer(y):
    """Nearest-quadrant decision (the reference's TedMM notes the same
    sign-based slicer pending a modulation-aware one, clock-rec.cc:20-24)."""
    s = jnp.sign(jnp.real(y)) + 1j * jnp.sign(jnp.imag(y))
    return (s / jnp.sqrt(2.0)).astype(complex_dtype)


def ted_mm(d0, x0, d1, x1):
    """Mueller & Müller decision-directed TED at 1 sample/symbol (parity:
    TedMM, clock-rec.cc:11-28 — stubbed there, implemented here; same
    form as the repo's decision-directed demod loop, demod_dec.py):
    e = Re(conj(d0)*x1 - conj(d1)*x0) with (d, x) = (decision, sample) for
    the previous (0) and current (1) symbols."""
    return jnp.real(jnp.conj(d0) * x1 - jnp.conj(d1) * x0)


def ted_early_late(x0, x1, x2):
    """Early-late gate TED (parity: TedEL, clock-rec.cc:30-46 — stubbed
    there; the commented formula is implemented): x1 is the on-time symbol
    sample, x0/x2 the half-symbol early/late samples;
    e = -Re(conj(x1) * (x2 - x0))."""
    return -jnp.real(jnp.conj(x1) * (x2 - x0))


@dataclasses.dataclass(frozen=True)
class ClockRecConfig:
    """Parity: ClockRecConfig, telecom.hpp:703-745."""
    osf: int = 4          # input oversampling factor (K1)
    tc: float = 5.0       # loop time constant, in symbols
    ted_osf: int = 2      # TED working rate (K2); Gardner/early-late = 2
    itrp: str = "cspline"  # interpolator kind
    ted: str = "gardner"  # "gardner" | "mm" | "el" (TedType, telecom.hpp)

    @property
    def loop_gain(self) -> float:
        """First-order loop gain from the time constant (shared by
        ClockRec and ClockRec2 — same calibration, clock-rec.cc)."""
        K1 = self.osf
        return K1 * (1 - np.exp(-1.0 / (self.tc * K1)))


class ClockRec(Block):
    """Streaming Gardner clock recovery.

    ``step(state, x)`` returns ``(state, (symbols, valid))`` where
    symbols has static length ``n//osf + 2 + n//(64*osf)`` (nominal
    symbols plus catch-up headroom for timing drift) and ``valid`` marks
    real outputs (the instantaneous symbol rate wanders around fe/osf
    while the loop pulls in).
    """

    itrp: Interpolator
    cfg: ClockRecConfig = struct.field(pytree_node=False)

    @classmethod
    def create(cls, cfg: ClockRecConfig) -> "ClockRec":
        assert cfg.ted in ("gardner", "mm", "el"), cfg.ted
        if cfg.ted == "mm":
            # M&M works at 1 sample/symbol
            cfg = dataclasses.replace(cfg, ted_osf=1)
        if cfg.ted_osf >= 2 * cfg.osf:
            # the loop caps interpolations at 2/input sample; at
            # ted_osf >= 2*osf the AVERAGE need equals the cap, leaving
            # zero catch-up headroom — any timing deficit then becomes
            # a permanent phase underflow (silent mis-sampling)
            raise ValueError(
                f"ClockRecConfig: ted_osf={cfg.ted_osf} must be < "
                f"2*osf={2 * cfg.osf} (the interpolation budget is 2 "
                f"per input sample; use a higher osf or lower ted_osf)")
        itrp = make_interpolator(cfg.itrp)
        return cls(itrp=itrp, cfg=cfg)

    @property
    def gain(self) -> float:
        return self.cfg.loop_gain

    def init(self, clock_offset: float = 0.0):
        """``clock_offset``: initial clock phase preset in SYMBOLS,
        in [-1, 1] (parity: Démodulateur::regle_horloge /
        dsp tune_clock, telecom.hpp:935 — declared there but an empty
        stub in the reference; implemented here)."""
        K = self.itrp.K
        return dict(
            phase=jnp.asarray(self.cfg.osf / 2.0
                              + clock_offset * self.cfg.osf, real_dtype),
            window=jnp.zeros((K,), complex_dtype),
            x0=jnp.zeros((), complex_dtype),
            x1=jnp.zeros((), complex_dtype),
            x2=jnp.zeros((), complex_dtype),
            d1=jnp.zeros((), complex_dtype),   # last decision (M&M)
            cnt=jnp.zeros((), jnp.int32),
        )

    @property
    def ratio(self) -> float:
        return 1.0 / self.cfg.osf

    def step(self, state, x: jax.Array):
        K1 = self.cfg.osf
        K2 = self.cfg.ted_osf
        gain = self.gain
        K = self.itrp.K
        lut = self.itrp.lut
        nph = self.itrp.nphases
        max_interp = 2 if K1 <= K2 else 1  # interps per input sample

        ted = self.cfg.ted

        def interp_once(carry):
            ph, win, x0, x1, x2, d1, cnt = carry
            frac = jnp.clip(ph, 0.0, 1.0)
            # Interpolator.taps inlined NOWHERE else: one copy of the
            # LUT phase-quantization convention
            taps = self.itrp.taps(frac)
            y = jnp.sum(win * taps.astype(complex_dtype))
            ph = ph + K1 / K2
            x0, x1, x2 = x1, x2, y
            if ted == "mm":
                # one interpolation per symbol; decision-directed error
                emit = jnp.ones((), jnp.bool_)
                d2 = _slicer(y)
                e = ted_mm(d1, x1, d2, x2)
                dec = jnp.clip(gain * e, -K1 / 4.0, K1 / 4.0)
                ph = ph + dec       # positive e -> sample later
                d1 = d2
            elif ted == "el":
                # symbol emitted on cnt==K2-1; the TED fires on the
                # midpoint interpolation AFTER it, when (x0, x1, x2) =
                # (early, on-time, late) half-symbol samples
                emit = cnt == (K2 - 1)
                fire = cnt == 0
                e = ted_early_late(x0, x1, x2)
                dec = jnp.clip(gain * e, -K1 / 4.0, K1 / 4.0)
                ph = jnp.where(fire, ph - dec, ph)
                cnt = jnp.where(emit, 0, cnt + 1)
            else:  # gardner
                emit = cnt == (K2 - 1)
                e = ted_gardner(x0, x1, x2)
                dec = jnp.clip(gain * e, -K1 / 4.0, K1 / 4.0)
                ph = jnp.where(emit, ph - dec, ph)
                cnt = jnp.where(emit, 0, cnt + 1)
            return (ph, win, x0, x1, x2, d1, cnt), y, emit

        def body(st, xi):
            ph = st["phase"] - 1.0
            win = jnp.roll(st["window"], -1).at[-1].set(xi)
            carry = (ph, win, st["x0"], st["x1"], st["x2"], st["d1"],
                     st["cnt"])
            sym = jnp.zeros((), complex_dtype)
            valid = jnp.zeros((), jnp.bool_)
            for _ in range(max_interp):
                do = carry[0] < 1.0
                new_carry, y, emit = interp_once(carry)
                carry = jax.tree.map(
                    lambda a, b: jnp.where(do, b, a), carry, new_carry)
                sym = jnp.where(do & emit, y, sym)
                valid = valid | (do & emit)
            ph, win, x0, x1, x2, d1, cnt = carry
            new_st = dict(phase=ph, window=win, x0=x0, x1=x1, x2=x2,
                          d1=d1, cnt=cnt)
            return new_st, (sym, valid)

        state, (syms, valids) = jax.lax.scan(body, state, x)
        # compact into a static-length buffer; headroom scales with the
        # block (~1.6% + 2) so a realistic sample-rate offset cannot
        # overflow it and silently drop trailing symbols
        nmax = x.shape[-1] // K1 + 2 + x.shape[-1] // (64 * K1)
        pos = jnp.cumsum(valids.astype(jnp.int32)) - 1
        pos = jnp.where(valids, pos, nmax)  # invalid -> dumped past the end
        out = jnp.zeros((nmax + 1,), complex_dtype).at[pos].set(syms)
        count = jnp.sum(valids.astype(jnp.int32))
        mask = jnp.arange(nmax) < count
        return state, (out[:nmax], mask)


def clock_rec(x: jax.Array, cfg: ClockRecConfig) -> Tuple[jax.Array, jax.Array]:
    """One-shot clock recovery; returns (symbols, valid_mask)."""
    blk = ClockRec.create(cfg)
    _, (syms, mask) = blk.step(blk.init(), x)
    return syms, mask
