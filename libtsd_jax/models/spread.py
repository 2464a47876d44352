"""Spread spectrum: DSSS chip modulation and FHSS frequency hopping,
plus baseband transposition (channelization).

Parity: core/src/telecom/canalisation/etalement-spectre.cc (FHSS :13-63,
DSSS :93-160), transpo-bb.cc:15-70.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..block import Block
from ..config import complex_dtype, real_dtype
from ..ops.filter_rt import Fir
from ..ops.fir_design import fir_design_windowed

__all__ = ["dsss_modulate", "dsss_demodulate", "fhss_modulate",
           "TranspoBBConfig", "TranspoBB"]


def dsss_modulate(x: jax.Array, chips: jax.Array, osf_in: int = 1) -> jax.Array:
    """Direct-sequence spreading: upsample the symbol stream to the chip
    rate and multiply by the repeated chip sequence (parity:
    DSSSModulation, etalement-spectre.cc:93-160)."""
    chips = jnp.asarray(chips, real_dtype)
    nchips = chips.shape[0]
    assert nchips % osf_in == 0, "chips length must be a multiple of osf_in"
    rep = nchips // osf_in
    # rectangular interpolation (sample-and-hold) to the chip rate
    y = jnp.repeat(x, rep, axis=-1)
    n = y.shape[-1]
    seq = jnp.tile(chips, n // nchips + 1)[:n]
    return y * seq.astype(y.dtype)


def dsss_demodulate(y: jax.Array, chips: jax.Array, osf_in: int = 1) -> jax.Array:
    """Despread: multiply by the chip sequence and integrate over each
    symbol period."""
    chips = jnp.asarray(chips, real_dtype)
    nchips = chips.shape[0]
    rep = nchips // osf_in
    n = (y.shape[-1] // nchips) * nchips
    z = y[..., :n] * jnp.tile(chips, n // nchips).astype(y.dtype)
    return z.reshape(*z.shape[:-1], -1, rep).mean(axis=-1)


def fhss_modulate(x: jax.Array, hop_seq: jax.Array, slot_len: int,
                  nfreqs: int) -> jax.Array:
    """Frequency-hopping: each slot of ``slot_len`` samples is mixed with
    the oscillator at frequency seq[i]/nfreqs (parity: FHSSModulation,
    etalement-spectre.cc:13-63; phase-continuous per frequency)."""
    n = (x.shape[-1] // slot_len) * slot_len
    x = x[..., :n]
    nslots = n // slot_len
    if nfreqs > 46340:
        # the modular product below is bounded by nfreqs^2, which must
        # fit int32 (the library runs x64-disabled: a jnp.int64 request
        # would silently truncate to int32 anyway)
        raise ValueError(f"nfreqs={nfreqs} > 46340 would overflow the "
                         f"int32 exact-phase arithmetic")
    hop = jnp.asarray(jnp.asarray(hop_seq).astype(jnp.int32)
                      if isinstance(hop_seq, jax.Array)
                      else np.asarray(hop_seq, np.int32))[
        jnp.arange(nslots) % hop_seq.shape[0]]
    hop = hop % nfreqs
    # EXACT phase via integer modular arithmetic: f = hop/nfreqs with
    # hop, nfreqs integers, so phase cycles = (hop*k mod nfreqs)/nfreqs
    # computed in int32 (both factors < nfreqs <= 46340) never loses a
    # bit at ANY signal length — the old float32 f*k ramp had ulp ~0.03
    # cycles by k ~ 1e6 (the exact hazard ops/signal.cycles exists for,
    # but here the frequency varies per slot and the integer route is
    # exact AND cheaper)
    k = jnp.arange(n, dtype=jnp.int32)
    hop_per_sample = jnp.repeat(hop, slot_len)
    ph_int = (hop_per_sample * (k % nfreqs)) % nfreqs
    cyc = ph_int.astype(real_dtype) / nfreqs
    lo = jnp.exp(2j * jnp.pi * cyc).astype(complex_dtype)
    return x * lo


@dataclasses.dataclass(frozen=True)
class TranspoBBConfig:
    """Parity: TranspoBBConfig, telecom.hpp:649-691."""
    fi: float = 0.25     # intermediate frequency (normalized)
    ntaps: int = 63


class TranspoBB(Block):
    """Baseband transposition: mix down by fi and (for real inputs) filter
    the image (parity: TranspoBB, transpo-bb.cc:15-70)."""

    img_filter: Fir
    cfg: TranspoBBConfig = struct.field(pytree_node=False)
    real_input: bool = struct.field(pytree_node=False, default=True)

    @classmethod
    def create(cls, cfg: TranspoBBConfig, real_input: bool = True) -> "TranspoBB":
        fc = cfg.fi if cfg.fi < 0.25 else 0.5 - cfg.fi
        h = fir_design_windowed(cfg.ntaps, "lp", max(fc, 0.01))
        return cls(img_filter=Fir.create(h), cfg=cfg, real_input=real_input)

    def init(self):
        # mixer phase carried in CYCLES (wrapped to [0,1) every block)
        return (jnp.zeros((), real_dtype),
                self.img_filter.init_for(jnp.zeros((0,), complex_dtype)))

    @property
    def delay(self):
        return self.img_filter.delay if self.real_input else 0.0

    def step(self, state, x: jax.Array):
        ph, fstate = state
        n = x.shape[-1]
        f = self.cfg.fi
        # phase in wrapped CYCLES with the per-block increment reduced
        # mod 1 in host float64 (the same NCO pattern as every other
        # mixer in the repo, ops/signal.cycles): the old radian
        # accumulator rounded 2*pi*f*n to float32 BEFORE the mod,
        # adding the same ~1e-4 rad error every block — a deterministic
        # spurious frequency offset over long streams
        from ..ops.signal import cycles
        cyc = ph + cycles(f, n)
        lo = jnp.exp(-2j * jnp.pi * cyc).astype(complex_dtype)
        y = x.astype(complex_dtype) * lo
        ph = jnp.mod(ph + jnp.asarray((f * n) % 1.0, real_dtype), 1.0)
        if self.real_input:
            fstate, y = self.img_filter.step(fstate, y)
        return (ph, fstate), y
