"""Waveforms: symbol mappings, pulse shaping, theoretical BER.

Parity: FormeOnde & subclasses (core/src/telecom/modulations.cc:260-793,
header core/include/tsd/telecom.hpp:26-339).

All symbol mapping / decision operations are vectorized over
whole blocks (the reference's per-sample ``Ctx::step`` virtual calls become
index arithmetic); phase-memory modulations (pi/4-QPSK, FSK) use parity
indexing and cumulative phase instead of mutable state.

Bit order: LSB-first within a symbol (parity: symmap_binaire,
modulations.cc:78-106).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from ..config import complex_dtype, from_ri, real_dtype, to_ri
from ..ops import fir_design as FD
from ..ops.filter_rt import Fir, FirDecim
from ..ops.resample import FirUps, fir_ups_delay

__all__ = [
    "PulseShape", "Waveform", "make_waveform",
    "wf_bpsk", "wf_qpsk", "wf_pi4_qpsk", "wf_psk", "wf_ask", "wf_qam",
    "wf_fsk", "bits_to_symbol_indices", "symbol_indices_to_bits",
    "diff_encode", "diff_decode",
]


# ------------------------------------------------------- symbol mapping

def bits_to_symbol_indices(bits: jax.Array, k: int) -> jax.Array:
    """Pack k bits (LSB first) into symbol indices (parity: symmap_binaire,
    modulations.cc:78-106; trailing partial symbol zero-padded)."""
    n = bits.shape[0]
    nsymb = (n + k - 1) // k
    pad = nsymb * k - n
    from ..block import safe_pad
    b = safe_pad(bits.astype(jnp.int32), 0, pad, axis=0).reshape(nsymb, k)
    weights = (2 ** jnp.arange(k)).astype(jnp.int32)
    return jnp.sum(b * weights, axis=1)


def symbol_indices_to_bits(idx: jax.Array, k: int) -> jax.Array:
    """Unpack symbol indices to bits, LSB first (parity: symdemap_binaire)."""
    j = jnp.arange(k)
    return ((idx[:, None] >> j[None, :]) & 1).astype(jnp.int8).reshape(-1)


def diff_encode(idx: jax.Array, M: int) -> jax.Array:
    """Differential encoding y[n] = (y[n-1] + x[n]) mod M (parity:
    diff_encode, telecom.cc)."""
    return jnp.cumsum(idx, axis=-1) % M


def diff_decode(idx: jax.Array, M: int) -> jax.Array:
    first = idx[..., :1]
    rest = (idx[..., 1:] - idx[..., :-1]) % M
    return jnp.concatenate([first, rest], axis=-1)


# ---------------------------------------------------------- pulse shaping

@dataclasses.dataclass(frozen=True)
class PulseShape:
    """Pulse-shaping filter spec (parity: SpecFiltreMiseEnForme,
    telecom.hpp:26-121).  type: 'nrz' | 'none' | 'gaussian' | 'rcs'."""

    type: str = "rcs"
    BT: float = 0.8
    beta: float = 0.2

    @classmethod
    def none(cls):
        return cls(type="none")

    @classmethod
    def nrz(cls):
        return cls(type="nrz")

    @classmethod
    def gaussian(cls, BT: float = 0.8):
        return cls(type="gaussian", BT=BT)

    @classmethod
    def rcs(cls, beta: float = 0.2):
        return cls(type="rcs", beta=beta)

    def get_coefs(self, ncoefs: int, osf: int) -> np.ndarray:
        """Parity: SpecFiltreMiseEnForme::get_coefs,
        modulations.cc:797-856."""
        if osf == 1:
            return np.array([1.0])
        if ncoefs == 0:
            ncoefs = 5 * osf + 1
            if ncoefs % 2 == 0:
                ncoefs += 1
        if self.type == "nrz":
            return np.ones(osf) / osf
        if self.type == "none":
            return np.ones(1)
        if self.type == "gaussian":
            return FD.gaussian_fir_telecom(ncoefs, self.BT, osf)
        if self.type == "rcs":
            return FD.root_raised_cosine(ncoefs, self.beta, osf)
        raise ValueError(f"unknown pulse shape {self.type!r}")

    def shaping_filter(self, ncoefs: int, R: int) -> FirUps:
        """Upsampling pulse-shaping filter, energy normalized so input and
        output powers match (parity: filtre_mise_en_forme,
        modulations.cc:858-876: h *= sqrt(R/energy)/R, then FirUps scales
        by R)."""
        h = self.get_coefs(ncoefs, R)
        en = np.sum(h * h)
        h = h * (np.sqrt(R) / np.sqrt(en)) / R
        return FirUps.create(h, R)

    def matched_filter(self, ncoefs: int, osf: int) -> Fir:
        """Matched filter at the sample rate (parity: filtre_adapté)."""
        h = self.get_coefs(ncoefs, osf)
        en = np.sum(h * h)
        return Fir.create(h / np.sqrt(en * osf))

    def matched_filter_decim(self, ncoefs: int, osf: int) -> FirDecim:
        """Matched filter + decimation to symbol rate (parity:
        filtre_adapté_décimation)."""
        h = self.get_coefs(ncoefs, osf)
        en = np.sum(h * h)
        return FirDecim.create(h / np.sqrt(en * osf), osf)


# -------------------------------------------------------------- waveforms

@dataclasses.dataclass(frozen=True)
class WaveformInfo:
    """Parity: FormeOnde::Infos, telecom.hpp:205-230."""
    is_linear: bool = True
    is_psk: bool = False
    is_ask: bool = False
    is_fsk: bool = False
    is_qam: bool = False
    index: float = 1.0   # FSK modulation index
    M: int = 2
    k: int = 1


def _psk_constellation(M: int) -> np.ndarray:
    # parity: psk_constellation, modulations.cc:43-52 (QPSK offset pi/4)
    if M == 2:
        return np.array([-1.0 + 0j, 1.0 + 0j])
    dec = np.pi / 4 if M == 4 else 0.0
    return np.exp(1j * (dec + 2 * np.pi * np.arange(M) / M))


def _ask_constellation(M: int, K1: float, K2: float) -> np.ndarray:
    # parity: ask_constellation, modulations.cc:54-57
    return (K1 + np.linspace(0, M - 1, M) * (K2 / (M - 1))).astype(complex)


def _qam_constellation(M: int) -> np.ndarray:
    # parity: FormeOndeQAM ctor, modulations.cc:500-530 (column-major grid)
    M2 = int(np.sqrt(M))
    assert M2 * M2 == M, "QAM M must be a perfect square"
    x = np.arange(M2) / (M2 - 1) * 2 - 1
    re, im = np.meshgrid(x, x, indexing="ij")  # re over rows (x), im cols (y)
    return (re + 1j * im).reshape(M2 * M2, order="F")


class Waveform(struct.PyTreeNode):
    """A linear waveform (ASK/PSK/QAM) or FSK, with vectorized mapping.

    For pi/4-QPSK, ``rotating=True``: odd symbols use the constellation
    rotated by pi/4 (parity: FormeOnde_π4QPSK, modulations.cc:407-489).

    The constellation is stored as (2, M) float32 re/im planes
    (``symbols_ri``, see config.to_ri); ``symbols`` unpacks it
    (trace-safe).
    """

    symbols_ri: jax.Array                    # (2, M) re/im planes
    info: WaveformInfo = struct.field(pytree_node=False)
    shaping: PulseShape = struct.field(pytree_node=False)
    rotating: bool = struct.field(pytree_node=False, default=False)
    name: str = struct.field(pytree_node=False, default="wf")

    @property
    def symbols(self) -> jax.Array:
        return from_ri(self.symbols_ri)

    # --- symbol generation ----------------------------------------------
    def make_symbols(self, bits: jax.Array, parity=0) -> jax.Array:
        """bits -> I/Q symbols (parity: génère_symboles,
        modulations.cc:108-120).

        ``parity``: rotation parity of the FIRST symbol for rotating
        constellations (pi/4-QPSK) — streaming modulators pass their
        carried symbol-count parity so the pi/4 alternation continues
        across blocks instead of restarting at even."""
        idx = bits_to_symbol_indices(bits, self.info.k)
        if self.info.is_fsk:
            return self.symbols[idx]  # real frequency levels, complex dtype
        s = self.symbols[idx]
        if self.rotating:
            rot = jnp.where((jnp.arange(idx.shape[0]) + parity) % 2 == 1,
                            jnp.exp(1j * jnp.pi / 4).astype(complex_dtype),
                            jnp.asarray(1.0 + 0j, complex_dtype))
            s = s * rot
        return s

    def gen_samples(self, bits: jax.Array, ncoefs: int = 0,
                    osf: int = 8) -> Tuple[jax.Array, float]:
        """bits -> shaped I/Q samples; returns (samples, delay-in-samples)
        (parity: génère_échantillons, modulations.cc:163-207, including the
        FSK phase-integration path)."""
        symbs = self.make_symbols(bits)
        h = self.shaping.get_coefs(ncoefs, osf)
        nc = len(h)
        nflush = (nc + osf - 1) // osf
        symbs = jnp.concatenate(
            [symbs, jnp.zeros(nflush, symbs.dtype)])
        f = self.shaping.shaping_filter(ncoefs, osf)
        _, y = f.step(f.init_for(symbs), symbs)
        delay = fir_ups_delay(nc, osf)
        if self.info.is_fsk:
            om_max = jnp.pi * self.info.index / osf
            vr = jnp.real(y)
            # normalize by the CONSTELLATION extreme, not the per-call
            # data maximum: a block using only inner FSK levels must not
            # be stretched to full deviation (Modulator._post_shaper
            # documents the same requirement)
            # SAME zero guard expression as Modulator._post_shaper
            # (keep in lockstep: one-shot and streaming FSK must match
            # bit-for-bit)
            vmax = jnp.max(jnp.abs(jnp.real(self.symbols)))
            vf = vr * (om_max / jnp.maximum(vmax, 1e-30))
            y = jnp.exp(1j * jnp.cumsum(vf)).astype(complex_dtype)
        return y, float(delay)

    # --- decisions -------------------------------------------------------
    def _derotate(self, x: jax.Array, parity) -> jax.Array:
        """Undo the alternating pi/4 rotation given the parity of the
        first symbol (0: even-index symbols unrotated)."""
        n = x.shape[0]
        odd = (jnp.arange(n) + parity) % 2 == 1
        rot = jnp.where(odd,
                        jnp.exp(-1j * jnp.pi / 4).astype(complex_dtype),
                        jnp.asarray(1.0 + 0j, complex_dtype))
        return x * rot

    def detect_parity(self, x: jax.Array,
                      mask: Optional[jax.Array] = None) -> jax.Array:
        """Estimate the pi/4-QPSK rotation parity of x[0] by trying both
        and keeping the lower total decision error (the receiver does not
        know the transmit parity — clock recovery may drop symbols)."""
        def err(p):
            xs = self._derotate(x, p)
            e = jnp.min(jnp.abs(xs[..., None] - self.symbols) ** 2, axis=-1)
            if mask is not None:
                e = jnp.where(mask, e, 0.0)
            return jnp.sum(e)
        return (err(1) < err(0)).astype(jnp.int32)

    def closest(self, x: jax.Array, parity=None) -> jax.Array:
        """Nearest constellation index, vectorized (parity:
        symbole_plus_proche, modulations.cc:260-276; BPSK/QPSK fast paths
        :23-41).

        For rotating constellations (pi/4-QPSK), ``parity`` selects the
        de-rotation phase of x[0] explicitly — streaming demods carry it
        in state (the reference's demod reset(nb_symb) counter,
        recepteur.cc:487) — or None for a per-call trial."""
        M = self.info.M
        if self.info.is_psk and M == 2 and not self.rotating:
            return (jnp.real(x) >= 0).astype(jnp.int32)
        if self.rotating:
            if parity is None:
                parity = self.detect_parity(x)
            x = self._derotate(x, parity)
        d = jnp.abs(x[..., None] - self.symbols[None, :]) ** 2
        return jnp.argmin(d, axis=-1).astype(jnp.int32)

    def decode_symbols(self, x: jax.Array) -> jax.Array:
        """I/Q symbols -> bits (parity: decode_symboles,
        modulations.cc:238-250)."""
        return symbol_indices_to_bits(self.closest(x), self.info.k)

    # --- theory ----------------------------------------------------------
    def ber(self, EbN0_db) -> jax.Array:
        """Theoretical BER (parity: each FormeOnde::ber; Proakis eqs)."""
        from jax.scipy.special import erfc
        e = 10.0 ** (jnp.asarray(EbN0_db, real_dtype) / 10.0)
        M, k = self.info.M, self.info.k
        if self.info.is_fsk:
            # coherent non-orthogonal detector (modulations.cc:735-744;
            # the reference leaves the tone correlation rho at 0 with a
            # "?" — here binary FSK uses the actual rho = sinc(2h) of the
            # modulation index, which reduces to the reference's formula
            # at h = 0.5 (orthogonal))
            if k == 1:
                h_idx = self.info.index
                rho = float(np.sinc(2.0 * h_idx))
                return 0.5 * erfc(jnp.sqrt(e * (1.0 - rho) / 2))
            return 0.5 * erfc(jnp.sqrt(e / 2))
        if self.info.is_ask:
            return ((M - 1.0) / M) * erfc(
                jnp.sqrt(3.0 * k * e / (M * M - 1.0))) / k
        if self.info.is_qam:
            return (2.0 / k) * (1 - 1 / np.sqrt(M)) * erfc(
                jnp.sqrt(3.0 * k * e / (2.0 * (M - 1))))
        # PSK (incl. pi/4-QPSK)
        b = erfc(jnp.sqrt(k * e) * np.sin(np.pi / M)) / k
        if M == 2:
            b = b / 2
        return b

    def constellation(self) -> jax.Array:
        if self.rotating:
            return jnp.concatenate(
                [self.symbols,
                 self.symbols * jnp.exp(1j * jnp.pi / 4).astype(complex_dtype)])
        return self.symbols

    @property
    def excursion(self) -> float:
        return self.info.index if self.info.is_fsk else 1.0


# ---------------------------------------------------------------- factories

def wf_psk(M: int, shaping: PulseShape = PulseShape()) -> Waveform:
    return Waveform(
        symbols_ri=to_ri(_psk_constellation(M)),
        info=WaveformInfo(is_psk=True, M=M, k=int(np.log2(M))),
        shaping=shaping, name=f"{M}PSK" if M > 4 else ("BPSK" if M == 2 else "QPSK"))


def wf_bpsk(shaping: PulseShape = PulseShape()) -> Waveform:
    return wf_psk(2, shaping)


def wf_qpsk(shaping: PulseShape = PulseShape()) -> Waveform:
    return wf_psk(4, shaping)


def wf_pi4_qpsk(shaping: PulseShape = PulseShape()) -> Waveform:
    return Waveform(
        symbols_ri=to_ri(_psk_constellation(4)),
        info=WaveformInfo(is_psk=True, M=4, k=2),
        shaping=shaping, rotating=True, name="pi4-QPSK")


def wf_ask(M: int = 2, K1: float = -1.0, K2: float = 2.0,
           shaping: PulseShape = PulseShape.nrz()) -> Waveform:
    return Waveform(
        symbols_ri=to_ri(_ask_constellation(M, K1, K2)),
        info=WaveformInfo(is_ask=True, M=M, k=int(np.log2(M))),
        shaping=shaping, name=f"{M}-ASK")


def wf_qam(M: int, shaping: PulseShape = PulseShape()) -> Waveform:
    return Waveform(
        symbols_ri=to_ri(_qam_constellation(M)),
        info=WaveformInfo(is_qam=True, M=M, k=int(np.log2(M))),
        shaping=shaping, name=f"QAM{M}")


def wf_fsk(M: int = 2, index: float = 0.4,
           shaping: PulseShape = PulseShape.nrz()) -> Waveform:
    # frequency levels -1..1 (parity: FormeOndeFSK ctor)
    lv = (np.arange(M) / (M - 1)) * 2 - 1
    return Waveform(
        symbols_ri=to_ri(lv.astype(complex)),
        info=WaveformInfo(is_linear=False, is_fsk=True, index=index, M=M,
                          k=int(np.log2(M))),
        shaping=shaping, name=("G" if shaping.type == "gaussian" else "")
        + ("MSK" if index == 0.5 else "FSK"))


def make_waveform(name: str, **kw) -> Waveform:
    """Factory by name (parity: forme_onde_* factories,
    telecom.hpp:268-339)."""
    name = name.lower()
    sh = kw.pop("shaping", None)
    if name == "bpsk":
        return wf_bpsk(sh or PulseShape())
    if name == "qpsk":
        return wf_qpsk(sh or PulseShape())
    if name in ("pi4-qpsk", "pi4qpsk", "π4-qpsk"):
        return wf_pi4_qpsk(sh or PulseShape())
    if name == "psk":
        return wf_psk(kw.pop("M", 8), sh or PulseShape())
    if name == "ask":
        return wf_ask(kw.pop("M", 2), shaping=sh or PulseShape.nrz(), **kw)
    if name == "qam":
        return wf_qam(kw.pop("M", 16), sh or PulseShape())
    if name in ("fsk", "msk", "gfsk", "gmsk"):
        index = kw.pop("index", 0.5 if "msk" in name else 0.4)
        default_sh = PulseShape.gaussian(kw.pop("BT", 0.8)) \
            if name.startswith("g") else PulseShape.nrz()
        return wf_fsk(kw.pop("M", 2), index, sh or default_sh)
    raise ValueError(f"unknown waveform {name!r}")
