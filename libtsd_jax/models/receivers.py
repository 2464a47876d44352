"""Flagship receiver pipelines (BASELINE.json configs 4 and 5).

* :class:`FmReceiver` — FM broadcast chain: channelize (NCO mix + lowpass)
  -> decimate -> quadrature demod -> de-emphasis, streaming overlap-save
  blocks, batched over channels (config 4).
* :class:`Qam16Modem` — QAM-16 with RRC matched filter, Gardner timing
  recovery and Costas-style carrier loop, EVM/SNR-checked (config 5).

These compose the framework's blocks; both are jit-able, batched across a
leading channel axis, and shard over a ("chan", "time") mesh (see
parallel/).  Parity anchor: the reference's FM demod chain
(core/src/telecom/analogique.cc:381-658) and QAM modem test
(core/tests/test-telecom.cc:206-234 test_recepteur_unit).
"""
from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..block import Block
from ..config import complex_dtype, from_ri, real_dtype, to_ri
from ..ops.filter_rt import Fir, FirDecim, Iir
from ..ops.fir_design import fir_design_windowed
from ..ops.iir_design import design_lexp
from ..ops.signal import cycles
from .carrier_rec import Cpll, CpllConfig
from .clock_rec import ClockRec, ClockRecConfig
from .clock_rec2 import ClockRec2
from .demod_dec import DecDemodConfig
from .demod_dec2 import DecisionDemod2
from .demod import quadrature_discriminator
from .modulator import ModConfig, Modulator
from .waveform import PulseShape, Waveform, wf_qam

__all__ = ["FmReceiverConfig", "FmReceiver", "Qam16Modem", "evm"]


# --------------------------------------------------------- FM receiver

@dataclasses.dataclass(frozen=True)
class FmReceiverConfig:
    """Config 4: channelize -> decimate -> quadrature demod -> de-emphasis."""
    channel_freq: float = 0.25    # channel center (normalized at input rate)
    decim: int = 4                # decimation to audio rate
    chan_taps: int = 63           # channel-select lowpass taps
    deviation: float = 0.1        # FM deviation at the DECIMATED rate
    deemph_fc: float = 0.05       # de-emphasis cutoff (decimated rate)


class FmReceiver(Block):
    """Streaming FM broadcast receiver, batched over channels: input
    (..., n) complex IF samples -> (..., n/decim) audio."""

    chan_filt: FirDecim
    deemph: Iir
    cfg: FmReceiverConfig = struct.field(pytree_node=False)

    @classmethod
    def create(cls, cfg: FmReceiverConfig) -> "FmReceiver":
        h = fir_design_windowed(cfg.chan_taps, "lp",
                                0.4 / cfg.decim, "hn")
        if cfg.deemph_fc > 0:
            b, a = design_lexp(cfg.deemph_fc)
        else:
            b, a = np.array([1.0]), np.array([1.0])  # no de-emphasis
        return cls(chan_filt=FirDecim.create(h, cfg.decim),
                   deemph=Iir.create(b, a), cfg=cfg)

    @property
    def ratio(self):
        return 1.0 / self.cfg.decim

    def init(self):
        return dict(
            nco=jnp.zeros((), real_dtype),
            chan=self.chan_filt.init_for(jnp.zeros((0,), complex_dtype)),
            prev_ri=jnp.zeros((2, 1), real_dtype),
            de=self.deemph.init(),
        )

    def init_for(self, x):
        return dict(
            nco=jnp.zeros((), real_dtype),
            chan=self.chan_filt.init_for(x),
            prev_ri=jnp.zeros((2,) + x.shape[:-1] + (1,), real_dtype),
            de=self.deemph.init_for(jnp.real(x)),
        )

    def step(self, state, x: jax.Array):
        cfg = self.cfg
        n = x.shape[-1]
        # (1) channelize: mix the selected channel to baseband — NCO
        # phase in wrapped CYCLES, host-f64-exact within the block
        # (signal.cycles; a raw f32 f*k ramp quantizes to ~2^-9 cycles by
        # k ~ 1e6, breaking parity with the sharded fm chain at scale)
        f = cfg.channel_freq
        cyc = state["nco"] + cycles(f, n)
        xb = x.astype(complex_dtype) * jnp.exp(
            -2j * jnp.pi * cyc).astype(complex_dtype)
        nco = jnp.mod(state["nco"] + jnp.asarray((f * n) % 1.0, real_dtype),
                      1.0)
        # (2) channel-select lowpass + decimate (polyphase matmul)
        cst, xd = self.chan_filt.step(state["chan"], xb)
        # (3) quadrature discriminator
        prev = from_ri(state["prev_ri"])
        d = quadrature_discriminator(xd, prev)
        audio = d / (2 * jnp.pi * cfg.deviation)
        # (4) de-emphasis (first-order IIR, associative-scan path)
        dst, audio = self.deemph.step(state["de"], audio)
        new_state = dict(nco=nco, chan=cst,
                         prev_ri=to_ri(xd[..., -1:]), de=dst)
        return new_state, audio


# --------------------------------------------------------- QAM-16 modem

def evm(symbols: jax.Array, wf: Waveform) -> jax.Array:
    """Error-vector magnitude (rms, relative) against the nearest
    constellation points."""
    s = wf.symbols
    d = jnp.abs(symbols[..., None] - s) ** 2
    e2 = jnp.min(d, axis=-1)
    p = jnp.mean(jnp.abs(s) ** 2)
    return jnp.sqrt(jnp.mean(e2, axis=-1) / p)


def _tail_evm(syms: jax.Array, mask: jax.Array, wf: Waveform) -> jax.Array:
    """EVM over the converged tail (second half of the valid symbols)."""
    nmask = jnp.sum(mask)
    tail = jnp.where(jnp.arange(syms.shape[0]) >= nmask // 2, mask, False)
    s = wf.symbols
    d2 = jnp.min(jnp.abs(syms[..., None] - s) ** 2, axis=-1)
    p_ref = jnp.mean(jnp.abs(s) ** 2)
    return jnp.sqrt(jnp.sum(jnp.where(tail, d2, 0.0))
                    / (jnp.maximum(jnp.sum(tail), 1) * p_ref))


class Qam16Modem(struct.PyTreeNode):
    """QAM-16 modem: RRC shaping TX; RX = matched filter -> Gardner clock
    recovery -> decision-directed carrier loop -> decisions + EVM
    (config 5).  All pieces jit-able; RX batched via vmap over channels."""

    wf: Waveform
    mod: Modulator
    mf: Fir
    cr: Block
    pll: Cpll
    dd2: DecisionDemod2
    osf: int = struct.field(pytree_node=False, default=4)
    rx_mode: str = struct.field(pytree_node=False, default="composed")

    @classmethod
    def create(cls, osf: int = 4, beta: float = 0.25,
               clock: str = "ptr", rx_mode: str = "composed") -> "Qam16Modem":
        wf = wf_qam(16, PulseShape.rcs(beta))
        mod = Modulator.create(ModConfig(wf=wf, fe=float(osf), fsymb=1.0))
        mf = wf.shaping.matched_filter(0, osf)
        # 'ptr' = symbol-rate pointer scan (osf x fewer scan steps);
        # 'sample' = per-sample loop (streaming parity)
        crc = ClockRecConfig(osf=osf, tc=10.0)
        cr = ClockRec2.create(crc) if clock == "ptr" \
            else ClockRec.create(crc)
        pll = Cpll(cfg=CpllConfig(ped="dec", M=16, order=2, BL=0.01), wf=wf)
        # rx_mode 'composed' (default): separate clock-recovery and PLL
        # stages — Gardner runs at 2x symbol rate, robust on multi-ring
        # QAM.  'fused': single symbol-rate scan fusing timing + carrier +
        # AGC (DecisionDemod2) — ~2x fewer sequential steps; best for
        # constant-modulus (PSK-class) waveforms, where Gardner self-noise
        # is low (the reference notes the same Gardner/QAM caveat,
        # clock-rec.cc:60)
        dd2 = DecisionDemod2.create(
            wf, DecDemodConfig(osf=osf, tc=10.0, BL=0.01, agc_tc=10.0))
        return cls(wf=wf, mod=mod, mf=mf, cr=cr, pll=pll, dd2=dd2, osf=osf,
                   rx_mode=rx_mode)

    def transmit(self, bits: jax.Array) -> jax.Array:
        return self.mod.modulate(bits)[0]

    def receive(self, x: jax.Array):
        """x: (n,) baseband samples -> (bits, symbols, mask, evm)."""
        if self.rx_mode == "fused":
            _, (bits, syms, mask, bmask) = self.dd2.step(self.dd2.init(), x)
            return bits, syms, mask, _tail_evm(syms, mask, self.wf)
        _, z = self.mf.step(self.mf.init_for(x), x)
        _, (syms, mask) = self.cr.step(self.cr.init(), z)
        # AGC to the CONSTELLATION's RMS (the QAM-16 grid has
        # E|s|^2 = 10/9 — unit-RMS normalization would park every symbol
        # at ~0.949 of its grid point, a ~5% systematic EVM floor)
        nv = jnp.maximum(jnp.sum(mask), 1)
        p = jnp.sum(jnp.where(mask, jnp.abs(syms) ** 2, 0.0)) / nv
        rms_ref = jnp.sqrt(jnp.mean(jnp.abs(self.wf.symbols) ** 2))
        syms = syms * (rms_ref / jnp.sqrt(p + 1e-20))
        # carrier loop (decision directed on the QAM grid); frozen on the
        # zero-padded invalid slots
        _, syms = self.pll.step(self.pll.init(), syms, valid=mask)
        from .waveform import symbol_indices_to_bits
        idx = self.wf.closest(syms)
        bits = symbol_indices_to_bits(idx, 4)
        return bits, syms, mask, _tail_evm(syms, mask, self.wf)
