"""Demodulators.

Parity: the reference ships two architectures (SURVEY §2.5):
* non-decision ("sans décision"): baseband transposition -> (FSK:
  quadrature discriminator) -> matched filter -> clock recovery ->
  carrier PLL -> decisions (DemodGen, core/src/telecom/demod-ndec.cc:17-408)
* decision-directed: per-sample NCO/AGC/timing/phase feedback loop
  (DemodGen2, core/src/telecom/demod-dec.cc:193-625)

This module implements the non-decision architecture as a composition of
the framework's blocks (each already a scan or matmul), plus the
quadrature discriminator and LLR computation.  The decision-directed
variant fuses AGC + NCO + decision feedback into the symbol-rate scan.
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
from ..ops.filter_rt import Fir
from ..ops.signal import cycles
from .carrier_rec import Cpll, CpllConfig
from .clock_rec import ClockRec, ClockRecConfig
from .waveform import Waveform, symbol_indices_to_bits

__all__ = ["DemodConfig", "Demodulator", "quadrature_discriminator", "llr"]


def quadrature_discriminator(x: jax.Array, prev: Optional[jax.Array] = None
                             ) -> jax.Array:
    """Instantaneous frequency via arg(x[n] * conj(x[n-1])) (parity: the
    FSK discriminator in demod-ndec.cc and FM demod, analogique.cc:18-76)."""
    if prev is None:
        prev = x[..., :1]
    xm1 = jnp.concatenate([prev, x[..., :-1]], axis=-1)
    return jnp.angle(x * jnp.conj(xm1))


def llr(wf: Waveform, y: jax.Array, sigma2: float = 0.1) -> jax.Array:
    """Max-log-MAP bit LLRs from symbols (parity: the reference's LLR
    output, telecom.hpp:409-494 decode soft)."""
    symbols = wf.symbols
    k = wf.info.k
    d2 = jnp.abs(y[..., None] - symbols[None, :]) ** 2  # (n, M)
    idx = jnp.arange(symbols.shape[0])
    out = []
    for b in range(k):
        bit = (idx >> b) & 1
        d0 = jnp.min(jnp.where(bit == 0, d2, jnp.inf), axis=-1)
        d1 = jnp.min(jnp.where(bit == 1, d2, jnp.inf), axis=-1)
        out.append((d0 - d1) / sigma2)
    return jnp.stack(out, axis=-1).reshape(*y.shape[:-1], -1)


@dataclasses.dataclass(frozen=True)
class DemodConfig:
    """Parity: DemodConfig, telecom.hpp:1029-1109."""
    wf: Waveform = None
    fe: float = 1.0
    fi: float = 0.0
    fsymb: float = 0.25
    ncoefs_mf: int = 0
    clock_rec: ClockRecConfig = None
    carrier: CpllConfig = None
    # False = skip the carrier PLL (parity: bench_recepteur's
    # carrier_rec_bl=0, test-telecom.cc:768 — TX/RX phase-aligned
    # simulations measure matched-filter + clock-recovery loss only)
    carrier_active: bool = True
    architecture: str = "ndec"   # 'ndec' | 'dec'

    @property
    def osf(self) -> int:
        return int(round(self.fe / self.fsymb))


class Demodulator(Block):
    """Non-decision demodulator chain (parity: DemodGen,
    demod-ndec.cc:172-400).

    step(state, x) -> (state, (bits, symbols, mask)).
    """

    mf: Fir
    cr: ClockRec
    pll: Cpll
    wf: Waveform
    cfg: DemodConfig = struct.field(pytree_node=False)

    @classmethod
    def create(cls, cfg: DemodConfig) -> "Demodulator":
        wf = cfg.wf
        osf = cfg.osf
        mf = wf.shaping.matched_filter(cfg.ncoefs_mf, osf)
        crc = cfg.clock_rec or ClockRecConfig(osf=osf)
        if crc.osf != osf:
            crc = dataclasses.replace(crc, osf=osf)
        cr = ClockRec.create(crc)
        # rotating constellations (pi/4-QPSK) break the power-loop PED
        # (x^M alternates sign between even/odd symbols) -> decision PED
        default_ped = "dec" if wf.rotating else "auto"
        # M=None: make_ped derives the PED order from the waveform,
        # including its ASK -> 2 rule (an explicit M here would defeat it)
        pc = cfg.carrier or CpllConfig(
            ped=default_ped, M=None, order=2, BL=0.01)
        pll = Cpll(cfg=pc, wf=wf)
        cfg_static = dataclasses.replace(cfg, wf=None)
        return cls(mf=mf, cr=cr, pll=pll, wf=wf, cfg=cfg_static)

    def init(self):
        return dict(
            nco=jnp.zeros((), real_dtype),
            prev=jnp.zeros((1,), complex_dtype),
            mf=self.mf.init(),
            cr=self.cr.init(),
            pll=self.pll.init(),
            # pi/4-QPSK rotation parity of the next symbol; -1 = unknown
            # (detected on the first block, then carried — parity:
            # demod->reset(nb_symb) counter, recepteur.cc:487)
            par=jnp.asarray(-1, jnp.int32),
        )

    def step(self, state, x: jax.Array, debug: bool = False):
        """``debug=True`` additionally returns a dict of per-stage
        intermediate signals (parity: DemodConfig.debug_actif and the
        reference's demod debug figures, demod-ndec.cc/demod-dec.cc:
        347-371): post-transposition, post-discriminator (FSK),
        post-matched-filter, clock-recovery symbols, AGC output, PLL
        output + phase trajectory."""
        cfg = self.cfg
        n = x.shape[-1]
        dbg = {}
        st = dict(state)
        # (1) baseband transposition — NCO phase in wrapped CYCLES (the
        # per-block increment is reduced mod 1 in host float64; an
        # unreduced float32 ramp loses ~0.1 rad by k ~ 1e6)
        if cfg.fi != 0.0:
            f = cfg.fi / cfg.fe
            cyc = st["nco"] + cycles(f, n)
            x = x * jnp.exp(-2j * jnp.pi * cyc).astype(complex_dtype)
            st["nco"] = jnp.mod(st["nco"] + jnp.asarray((f * n) % 1.0,
                                                        real_dtype), 1.0)
        if debug:
            dbg["post_transpo"] = x
        # (2) FSK: quadrature discriminator -> real frequency signal
        if self.wf.info.is_fsk:
            d = quadrature_discriminator(x, st["prev"])
            st["prev"] = x[..., -1:]
            om_max = jnp.pi * self.wf.info.index / cfg.osf
            x = (d / om_max).astype(complex_dtype)
            if debug:
                dbg["post_discri"] = x
        # (3) matched filter
        st["mf"], z = self.mf.step(st["mf"], x)
        if debug:
            dbg["post_mf"] = z
        # (4) clock recovery
        st["cr"], (syms, mask) = self.cr.step(st["cr"], z)
        if debug:
            dbg["clockrec_syms"] = syms
            dbg["clockrec_mask"] = mask
        # (5) amplitude normalization (block AGC, parity: demod AGC
        # stage) — to the CONSTELLATION's RMS, not unit RMS: decisions
        # compare against the unnormalized constellation (QAM16 rms
        # sqrt(10)/3, 4-ASK sqrt(5)/3 — unit-RMS AGC would mis-scale
        # every decision boundary)
        nvalid = jnp.maximum(jnp.sum(mask), 1)
        power = jnp.sum(jnp.where(mask, jnp.abs(syms) ** 2, 0.0)) / nvalid
        rms_ref = jnp.sqrt(jnp.mean(jnp.abs(self.wf.symbols) ** 2))
        syms = syms * (rms_ref / jnp.sqrt(power + 1e-20))
        if debug:
            dbg["agc_syms"] = syms
        # (6) carrier recovery (not needed for FSK); the loop freezes on
        # the zero-padded invalid slots of the clock-recovery output
        if not self.wf.info.is_fsk and cfg.carrier_active:
            pre_pll = syms
            st["pll"], syms = self.pll.step(st["pll"], syms, valid=mask)
            if debug:
                dbg["pll_syms"] = syms
                dbg["pll_phase"] = jnp.angle(
                    pre_pll * jnp.conj(syms)
                    + jnp.asarray(1e-30, complex_dtype))
        # (7) decisions; rotating constellations carry the rotation parity
        # across blocks (detected once, then advanced by the number of
        # valid symbols emitted)
        if self.wf.rotating:
            detected = self.wf.detect_parity(syms, mask)
            par = jnp.where(st["par"] >= 0, st["par"], detected)
            idx = self.wf.closest(syms, parity=par)
            st["par"] = (par + jnp.sum(mask.astype(jnp.int32))) % 2
        else:
            idx = self.wf.closest(syms)
        bits = symbol_indices_to_bits(idx, self.wf.info.k)
        bmask = jnp.repeat(mask, self.wf.info.k)
        if debug:
            return st, (bits, syms, mask, bmask), dbg
        return st, (bits, syms, mask, bmask)

    def demodulate(self, x: jax.Array):
        """One-shot: returns (bits, symbols, mask, bit_mask)."""
        _, (bits, syms, mask, bmask) = self.step(self.init(), x)
        return bits, syms, mask, bmask
