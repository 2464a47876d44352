"""Pointer-based decision-directed demodulator: ONE symbol-rate scan.

A symbol-rate formulation of the full synchronization loop: each scan
step advances a fractional read pointer through the matched-filtered
signal, interpolates the symbol + Gardner midpoint, applies NCO phase and
AGC corrections, makes the decision, and updates the timing (Gardner),
carrier (2nd-order DD loop) and gain trackers.  Sequential step count =
number of SYMBOLS (the per-sample architecture runs osf x more steps, and
the composed chain runs two scans).

Same loop dynamics as demod_dec.py / the reference's DemodGen2
(core/src/telecom/demod-dec.cc) with RecHorloge replaced by the pointer
formulation (clock_rec2.py).
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
from ..ops.filter_rt import Fir
from ..ops.iir_design import lexp_tc_to_coef
from ..ops.resample import Interpolator, make_interpolator
from .carrier_rec import LoopFilter2
from .clock_rec import ted_gardner
from .demod_dec import DecDemodConfig
from .waveform import Waveform, symbol_indices_to_bits

__all__ = ["DecisionDemod2"]


class DecisionDemod2(Block):
    """step(state, x) -> (state, (bits, symbols, valid, bit_valid));
    output length = len(x)//osf + 1 + len(x)//(64*osf) symbols (static;
    nominal count plus catch-up headroom so an RX symbol clock faster
    than fe/osf cannot starve the carried pointer into the stale-tail
    re-anchor — the same budget as ClockRec2).  Consumers filter by the
    validity masks."""

    itrp: Interpolator
    mf: Fir
    wf: Waveform
    cfg: DecDemodConfig = struct.field(pytree_node=False)

    @classmethod
    def create(cls, wf: Waveform, cfg: DecDemodConfig) -> "DecisionDemod2":
        return cls(itrp=make_interpolator(cfg.itrp),
                   mf=wf.shaping.matched_filter(0, cfg.osf), wf=wf, cfg=cfg)

    @property
    def _timing_gain(self) -> float:
        return self.cfg.osf * lexp_tc_to_coef(self.cfg.tc)

    @property
    def _agc_alpha(self) -> float:
        return lexp_tc_to_coef(self.cfg.agc_tc)

    @property
    def T(self) -> int:
        """Carried matched-filter-output tail: symbol + Gardner-midpoint
        windows stay inside [tail | z] across block boundaries."""
        return self.itrp.K + 2 * self.cfg.osf

    def init(self, clock_offset: float = 0.0):
        """``clock_offset``: initial clock phase preset in SYMBOLS,
        in [-1, 1] (parity: Démodulateur::regle_horloge / tune_clock,
        telecom.hpp:935 — an empty stub in the reference; implemented
        here by presetting the fractional read pointer)."""
        lf = LoopFilter2(self.cfg.BL, self.cfg.eta)
        return dict(
            mf=self.mf.init(),
            lf=lf.init(),
            theta=jnp.zeros((), real_dtype),
            gain=jnp.ones((), real_dtype),
            ptr=jnp.asarray(self.cfg.osf / 2.0
                            + clock_offset * self.cfg.osf, real_dtype),
            yprev_ri=jnp.zeros((2,), real_dtype),
            # last T matched-filter outputs (block boundaries seamless)
            tail=jnp.zeros((self.itrp.K + 2 * self.cfg.osf,),
                           complex_dtype),
        )

    def step(self, state, x: jax.Array):
        cfg = self.cfg
        osf = cfg.osf
        K = self.itrp.K
        lut = self.itrp.lut
        nph = self.itrp.nphases
        lf = LoopFilter2(cfg.BL, cfg.eta)
        symbols = self.wf.symbols
        tgain = self._timing_gain
        aga = self._agc_alpha
        n = x.shape[-1]
        # headroom slots: see class docstring (negative-drift catch-up)
        nsym = n // osf + 1 + n // (64 * osf)

        T = self.T
        mf_state, z = self.mf.step(state["mf"], x)
        if cfg.agc_active:
            rms_ref = jnp.sqrt(jnp.mean(jnp.abs(symbols) ** 2))
            z = z * (rms_ref / jnp.sqrt(jnp.mean(jnp.abs(z) ** 2) + 1e-20))
        # [carried MF tail | block | guard pad]; z[t] sits at index T+t —
        # block boundaries are seamless (the old zero-front-pad corrupted
        # the first ~K/osf symbols of every block and dropped the last)
        zp = jnp.concatenate([state["tail"], z,
                              jnp.zeros(K + osf, z.dtype)])

        def interp_at(p):
            ip = jnp.floor(p).astype(jnp.int32)
            tau = p - ip.astype(real_dtype)
            win = jax.lax.dynamic_slice(zp, (T + ip + 1 - K,), (K,))
            # one copy of the LUT phase-quantization convention
            taps = self.itrp.taps(tau)
            return jnp.sum(win * taps.astype(win.dtype))

        def body(st, t):
            p = st["ptr"]
            # a pointer past the block end waits for the next block; a
            # pointer below the carried-tail depth (sustained negative
            # drift) would make the interpolation slice CLAMP and decode
            # stale samples forever — re-anchor to the nominal grid
            # instead (one invalid symbol, then recovery)
            inlow = p > -(1.0 * osf)
            ready = (p < n) & inlow
            nom = t.astype(real_dtype) * osf
            pc = jnp.where(ready, p, jnp.where(inlow, 0.0, nom))
            rot = jnp.exp(-1j * st["theta"]).astype(complex_dtype)
            y = interp_at(pc) * rot * st["gain"]
            ymid = interp_at(pc - osf / 2.0) * rot * st["gain"]
            yprev = (st["yprev_ri"][0] + 1j * st["yprev_ri"][1]
                     ).astype(complex_dtype)
            # decision
            d2 = jnp.abs(y - symbols) ** 2
            s_idx = jnp.argmin(d2).astype(jnp.int32)
            ye = symbols[s_idx]
            # Gardner timing from the corrected samples (shared TED helper
            # — same expression as ClockRec/ClockRec2)
            e_t = ted_gardner(yprev, ymid, y)
            dec = jnp.clip(tgain * e_t, -osf / 4.0, osf / 4.0)
            # carrier loop
            e_ph = jnp.where(jnp.abs(y) > 0,
                             jnp.angle(y * jnp.conj(ye)), 0.0)
            lf_state, theta = lf.step(st["lf"], e_ph)
            if not cfg.carrier_active:
                lf_state, theta = st["lf"], st["theta"]
            # AGC tracking
            gain = st["gain"]
            if cfg.agc_active:
                eg = jnp.abs(y) / jnp.maximum(jnp.abs(ye), 1e-9)
                gain = (1 - aga) * gain + aga / jnp.maximum(eg, 1e-9)
            # loop updates only on consumed (real) symbols
            new = dict(
                lf=jax.tree_util.tree_map(
                    lambda a, b: jnp.where(ready, a, b), lf_state,
                    st["lf"]),
                theta=jnp.where(ready, theta, st["theta"]),
                gain=jnp.where(ready, gain, st["gain"]),
                ptr=jnp.where(
                    ready, p + osf - (dec if cfg.clock_active else 0.0),
                    jnp.where(inlow, p, nom + osf)),
                yprev_ri=jnp.where(
                    ready, jnp.stack([jnp.real(y), jnp.imag(y)]),
                    st["yprev_ri"]),
            )
            return new, (jnp.where(ready, y, 0.0 * y),
                         jnp.where(ready, s_idx, 0), ready)

        scan_state = {k: state[k] for k in
                      ("lf", "theta", "gain", "ptr", "yprev_ri")}
        carry, (syms, sidx, valid) = jax.lax.scan(
            body, scan_state, jnp.arange(nsym))
        new_state = dict(carry, mf=mf_state, ptr=carry["ptr"] - n,
                         tail=zp[n: n + T])
        bits = symbol_indices_to_bits(sidx, self.wf.info.k)
        bvalid = jnp.repeat(valid, self.wf.info.k)
        return new_state, (bits, syms, valid, bvalid)
