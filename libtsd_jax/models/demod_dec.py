"""Decision-directed demodulator (the reference's second architecture).

Parity: DemodGen2 / RecHorloge, core/src/telecom/demod-dec.cc:38-625 —
per-sample loop fusing: NCO phase correction -> AGC -> interpolating clock
recovery -> decision -> decision-directed phase/timing/gain updates.

Design: ONE `lax.scan` over input samples carries the full loop state
(theta, loop-filter state, AGC gain, timing phase, interpolator window,
previous decision); symbol outputs are emitted with a validity mask and
compacted, as in clock_rec.py.  Runs after the matched filter, batched
across channels via vmap.
"""
from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
from .. import struct

from ..block import Block
from ..config import complex_dtype, real_dtype
from ..ops.filter_rt import Fir
from ..ops.iir_design import lexp_tc_to_coef
from ..ops.resample import Interpolator, make_interpolator
from .carrier_rec import LoopFilter2
from .waveform import Waveform, symbol_indices_to_bits

__all__ = ["DecDemodConfig", "DecisionDemod"]


@dataclasses.dataclass(frozen=True)
class DecDemodConfig:
    """Parity: DemodDecConfig, telecom.hpp (dec.* fields)."""
    osf: int = 4
    # carrier loop
    carrier_active: bool = True
    BL: float = 0.01
    eta: float = 1.0
    # clock recovery
    clock_active: bool = True
    tc: float = 10.0           # timing loop time constant, symbols
    itrp: str = "cspline"
    # AGC
    agc_active: bool = True
    agc_tc: float = 10.0


class DecisionDemod(Block):
    """Fused decision-directed demodulator (after matched filtering).

    step(state, x) -> (state, (bits, symbols, mask, bit_mask)).
    """

    itrp: Interpolator
    mf: Fir
    wf: Waveform
    cfg: DecDemodConfig = struct.field(pytree_node=False)

    @classmethod
    def create(cls, wf: Waveform, cfg: DecDemodConfig) -> "DecisionDemod":
        itrp = make_interpolator(cfg.itrp)
        mf = wf.shaping.matched_filter(0, cfg.osf)
        return cls(itrp=itrp, mf=mf, wf=wf, cfg=cfg)

    @property
    def _timing_gain(self) -> float:
        # parity: RecHorloge gain = osf * lexp_tc_vers_coef(tc),
        # demod-dec.cc:89
        return self.cfg.osf * lexp_tc_to_coef(self.cfg.tc)

    @property
    def _agc_alpha(self) -> float:
        return lexp_tc_to_coef(self.cfg.agc_tc)

    def init(self):
        K = self.itrp.K
        lf = LoopFilter2(self.cfg.BL, self.cfg.eta)
        return dict(
            # complex-typed MF state: step() carries complex input, and a
            # real init state would change the carry dtype after one step
            # (a lax.scan type mismatch under block.stream)
            mf=self.mf.init_for(jnp.zeros((0,), complex_dtype)),
            lf=lf.init(),
            theta=jnp.zeros((), real_dtype),
            gain=jnp.ones((), real_dtype),
            phase=jnp.asarray(self.cfg.osf / 2.0 + 1.0, real_dtype),
            window=jnp.zeros((2, K), real_dtype),   # ri planes
            lyi=jnp.zeros((2,), real_dtype),
            lye=jnp.zeros((2,), real_dtype),
            cnt=jnp.zeros((), jnp.int32),
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

        # matched filter first (Toeplitz matmul path)
        mf_state, z = self.mf.step(state["mf"], x)
        if cfg.agc_active:
            # coarse block AGC: bring the signal to the constellation's rms
            # before the loop; the decision-directed AGC then only tracks
            # residual variation (a decision-feedback AGC alone cannot
            # acquire large gain errors on multi-ring constellations)
            rms_ref = jnp.sqrt(jnp.mean(jnp.abs(symbols) ** 2))
            rms_in = jnp.sqrt(jnp.mean(jnp.abs(z) ** 2) + 1e-20)
            z = z * (rms_ref / rms_in)

        def body(st, xi):
            theta = st["theta"]
            # NCO phase correction + AGC (parity: demod-dec.cc:379-392)
            y = xi * jnp.exp(-1j * theta).astype(complex_dtype)
            if cfg.agc_active:
                y = y * st["gain"]
            # interpolating clock recovery
            ph = st["phase"] - 1.0
            win = jnp.roll(st["window"], -1, axis=-1)
            win = win.at[0, -1].set(jnp.real(y)).at[1, -1].set(jnp.imag(y))
            do = ph < 1.0

            frac = jnp.clip(ph, 0.0, 1.0)
            taps = lut[jnp.clip(jnp.round(frac * nph).astype(jnp.int32),
                                0, nph)]
            wc = (win[0] + 1j * win[1]).astype(complex_dtype)
            yi = jnp.sum(wc * taps.astype(complex_dtype))
            ph_after = jnp.where(do, ph + osf, ph)

            # decision
            d2 = jnp.abs(yi - symbols) ** 2
            s_idx = jnp.argmin(d2).astype(jnp.int32)
            ye = symbols[s_idx]

            # AGC update (parity: demod-dec.cc:447-454)
            gain = st["gain"]
            if cfg.agc_active:
                eg = jnp.abs(yi) / jnp.maximum(jnp.abs(ye), 1e-9)
                gain_new = (1 - aga) * gain + aga / jnp.maximum(eg, 1e-9)
                gain = jnp.where(do, gain_new, gain)

            # phase error + carrier loop (parity: demod-dec.cc:456-471)
            lye = (st["lye"][0] + 1j * st["lye"][1]).astype(complex_dtype)
            lyi = (st["lyi"][0] + 1j * st["lyi"][1]).astype(complex_dtype)
            e_ph = jnp.where(jnp.abs(yi) > 0,
                             jnp.angle(yi * jnp.conj(ye)), 0.0)
            lf_new, theta_new = lf.step(st["lf"], e_ph)
            update_loops = do & (st["cnt"] >= 1) & jnp.asarray(
                cfg.carrier_active)
            lf_state = jax.tree.map(
                lambda a, b: jnp.where(update_loops, b, a),
                st["lf"], lf_new)
            theta = jnp.where(update_loops, theta_new, theta)

            # decision-directed Mueller&Muller timing update
            # e = Re(conj(lye)*yi - conj(ye)*lyi); positive e -> sample later
            # (phase counter counts down, so later == larger counter)
            if cfg.clock_active:
                e_t = jnp.real(jnp.conj(lye) * yi - jnp.conj(ye) * lyi)
                dec = jnp.clip(tgain * e_t, -osf / 4.0, osf / 4.0)
                ph_after = jnp.where(do & (st["cnt"] >= 1),
                                     ph_after + dec, ph_after)

            new = dict(
                mf=st["mf"], lf=lf_state, theta=theta, gain=gain,
                phase=ph_after, window=win,
                lyi=jnp.where(do, jnp.stack([jnp.real(yi), jnp.imag(yi)]),
                              st["lyi"]),
                lye=jnp.where(do, jnp.stack([jnp.real(ye), jnp.imag(ye)]),
                              st["lye"]),
                cnt=st["cnt"] + do.astype(jnp.int32),
            )
            return new, (yi, s_idx, do)

        scan_state = dict(state)
        scan_state["mf"] = mf_state
        new_state, (yis, sidxs, valids) = jax.lax.scan(body, scan_state, z)

        # compaction (as in clock_rec)
        # headroom scales with the block (see clock_rec.py note)
        nmax = x.shape[-1] // osf + 2 + x.shape[-1] // (64 * osf)
        pos = jnp.cumsum(valids.astype(jnp.int32)) - 1
        pos = jnp.where(valids, pos, nmax)
        syms = jnp.zeros((nmax + 1,), complex_dtype).at[pos].set(yis)[:nmax]
        sidx = jnp.zeros((nmax + 1,), jnp.int32).at[pos].set(sidxs)[:nmax]
        count = jnp.sum(valids.astype(jnp.int32))
        mask = jnp.arange(nmax) < count
        bits = symbol_indices_to_bits(sidx, self.wf.info.k)
        bmask = jnp.repeat(mask, self.wf.info.k)
        return new_state, (bits, syms, mask, bmask)
