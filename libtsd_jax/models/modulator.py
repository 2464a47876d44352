"""Modulator: bits -> shaped I/Q (or real IF) samples, streaming.

Parity: Modulateur / ModConfig, core/src/telecom/modulateur.cc:19-250,
core/include/tsd/telecom.hpp:852-875.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from .. import struct

from ..block import Block
from ..config import complex_dtype, real_dtype
from ..ops.signal import cycles
from .waveform import Waveform

__all__ = ["ModConfig", "Modulator"]


@dataclasses.dataclass(frozen=True)
class ModConfig:
    """Parity: ModConfig, telecom.hpp:852-875."""
    wf: Waveform = None
    fe: float = 1.0        # sample rate
    fi: float = 0.0        # intermediate (carrier) frequency
    fsymb: float = 0.25    # symbol rate
    real_output: bool = False  # sortie_réelle
    ncoefs: int = 0

    @property
    def osf(self) -> int:
        osf = self.fe / self.fsymb
        assert abs(osf - round(osf)) < 1e-6, "fe/fsymb must be an integer"
        return int(round(osf))


class Modulator(Block):
    """bits -> symbols -> pulse shaping (polyphase x OSF) -> optional IF
    upconversion (NCO mix) (parity: Modulateur::step,
    modulateur.cc:~130-237).

    State: (shaping filter state, NCO phase, symbol parity counter).
    ``delay`` is in output samples to the center of the first symbol
    (parity: latency accounting via filtre_rif_ups_délais).
    """

    shaper: Block
    wf: Waveform                        # pytree: constellation arrays are
    config: ModConfig = struct.field(pytree_node=False)  # leaves, jit-safe
    nc: int = struct.field(pytree_node=False)

    @classmethod
    def create(cls, config: ModConfig) -> "Modulator":
        wf = config.wf
        osf = config.osf
        shaper = wf.shaping.shaping_filter(config.ncoefs, osf)
        nc = len(wf.shaping.get_coefs(config.ncoefs, osf))
        # static metadata must not hold arrays: keep the waveform only as a
        # pytree field, store the config with wf stripped
        cfg_static = dataclasses.replace(config, wf=None)
        return cls(shaper=shaper, wf=wf, config=cfg_static, nc=nc)

    @property
    def delay(self) -> float:
        # our FirUps convention: end-padded taps, delay = (nc-1)/2 output
        # samples (see FirUps.delay)
        return (self.nc - 1) / 2.0

    @property
    def ratio(self) -> float:
        return self.config.osf / self.wf.info.k

    def init(self):
        return (self.shaper.init_for(jnp.zeros((0,), complex_dtype)),
                jnp.zeros((), real_dtype),   # NCO phase
                jnp.zeros((), real_dtype),   # FSK integrated phase
                jnp.zeros((), jnp.int32))    # rotation parity (pi/4-QPSK)

    def _post_shaper(self, y, ph, fsk_ph):
        """FSK phase integration, IF upconversion, real output — shared by
        step() and flush()."""
        cfg = self.config
        if self.wf.info.is_fsk and y.shape[-1] > 0:
            om_max = jnp.pi * self.wf.info.index / cfg.osf
            vr = jnp.real(y)
            # normalize by the STATIC constellation extreme, not the
            # per-block data max: a block containing only inner levels
            # would otherwise transmit them at inflated deviation, making
            # the RF depend on the blocking
            vmax = jnp.max(jnp.abs(jnp.real(self.wf.symbols)))
            vf = vr * (om_max / jnp.maximum(vmax, 1e-30))
            phases = fsk_ph + jnp.cumsum(vf)
            y = jnp.exp(1j * phases).astype(complex_dtype)
            fsk_ph = jnp.mod(phases[-1], 2 * jnp.pi)
        if cfg.fi != 0.0:
            # NCO phase in wrapped CYCLES (per-block increment reduced
            # mod 1 in host float64 — an unreduced float32 radian ramp
            # random-walks the carrier phase over long streams)
            n = y.shape[-1]
            f = cfg.fi / cfg.fe
            cyc = ph + cycles(f, n)
            y = y * jnp.exp(2j * jnp.pi * cyc).astype(complex_dtype)
            ph = jnp.mod(ph + jnp.asarray((f * n) % 1.0, real_dtype), 1.0)
        if cfg.real_output:
            y = jnp.sqrt(2.0) * jnp.real(y)
        return y, ph, fsk_ph

    def step(self, state, bits: jax.Array):
        # the carried symbol-count parity continues the pi/4-QPSK
        # rotation across blocks (a per-block restart would emit every
        # second block pi/4 off — streaming != one-shot)
        par = state[3]
        symbs = self.wf.make_symbols(bits, parity=par)
        return self.step_symbols(state, symbs)

    def step_symbols(self, state, symbs: jax.Array):
        """Feed already-mapped symbols through the shared shaping filter +
        IF chain.  This is the hook for a distinct header waveform
        (fo_entete): the reference swaps only the symbol mapper mid-frame
        (Modulateur::def_forme_onde, modulateur.cc:43-46) while the
        shaping filter and NCO keep their state — here the caller maps
        header and payload bits with their own waveforms and concatenates
        the symbol streams."""
        sh_state, ph, fsk_ph, par = state
        sh_state, y = self.shaper.step(sh_state, symbs)
        y, ph, fsk_ph = self._post_shaper(y, ph, fsk_ph)
        par = (par + symbs.shape[-1]) % 2
        return (sh_state, ph, fsk_ph, par), y

    def flush(self, state) -> Tuple[tuple, jax.Array]:
        """Push zero SYMBOLS through to drain the filter delay (parity:
        Modulateur flush, modulateur.cc / emetteur.cc:108; matches
        Waveform.gen_samples).  Zero bits would NOT work: they map to
        constellation point 0 (e.g. -1 for BPSK) and would transmit
        phantom full-power symbols that add ISI to the data tail."""
        nflush = (self.nc + self.config.osf - 1) // self.config.osf
        sh_state, ph, fsk_ph, par = state
        zsym = jnp.zeros((nflush,), complex_dtype)
        sh_state, y = self.shaper.step(sh_state, zsym)
        y, ph, fsk_ph = self._post_shaper(y, ph, fsk_ph)
        return (sh_state, ph, fsk_ph, par), y

    def modulate(self, bits: jax.Array) -> Tuple[jax.Array, float]:
        """One-shot: modulate + flush; returns (samples, delay)."""
        st = self.init()
        st, y1 = self.step(st, bits)
        _, y2 = self.flush(st)
        return jnp.concatenate([y1, y2]), float(self.delay)
