"""ADS-B (Mode S 1090ES) demodulator / decoder.

Parity: the reference DECLARES this component but never implements it —
`demodulateur_adsb()` and the `ADSBDecodeurConfig{fe, Ne}` /
`ADSBTrame{bs, score, texte}` structs exist only as a header
(core/include/tsd/telecom/protocols.hpp:12-48; no matching code in
core/src/).  This module is therefore a working superset of the declared
API, built for a data-parallel device:

* the preamble search is DENSE — half-slot sliding sums (cumsum
  differences) give the 4-pulse correlation and the 8-us window energy at
  every sample offset in one vectorized pass; no per-sample host loop;
* peak extraction emits a FIXED ``max_frames`` candidates per block with a
  validity mask (same static-shape pattern as models/detector.py);
* the 112 PPM bits of every candidate are sliced with a single vmapped
  dynamic_slice and decided by comparing half-bit energies;
* the Mode S CRC-24 (polynomial 0x1FFF409) is evaluated as a GF(2)
  MATRIX product — syndrome = bits @ H^T mod 2, one (K, 112) x (112, 24)
  int matmul for all candidates at once (the matrix-unit form of a CRC);
* text decoding (callsign / altitude / CPR position) is host-side string
  work on the validated bits, as plotting is host-side: no per-sample
  cost.

Signal model (1090 MHz Extended Squitter): pulse-position modulation at
1 Mbit/s; preamble pulses at 0, 1.0, 3.5, 4.5 us; each data bit occupies
1 us split into two 0.5 us half-slots — energy in the FIRST half means
'1', in the second '0'.  fe must be an even integer multiple of 1 MHz
(>= 2 MS/s; 2 MS/s is the classic RTL-SDR rate).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

__all__ = ["AdsbConfig", "AdsbFrame", "AdsbDecoder", "AdsbStream", "adsb_crc",
           "adsb_waveform", "cpr_global", "decode_adsb_text"]

_GEN = 0x1FFF409            # Mode S CRC-24 generator (25 bits)
_PREAMBLE_HALFSLOTS = (0, 2, 7, 9)   # pulse positions in 0.5-us units
_PREAMBLE_US = 8
_FRAME_BITS = 112


# ----------------------------------------------------------------------
# CRC-24 as GF(2) linear algebra
# ----------------------------------------------------------------------

def _crc_bits_np(bits: np.ndarray) -> np.ndarray:
    """Bitwise long-division CRC-24 of a bit vector (MSB first)."""
    r = 0
    for b in bits:
        r = ((r << 1) | int(b)) & 0x1FFFFFF
        if r & 0x1000000:
            r ^= _GEN
    # flush 24 zero bits
    for _ in range(24):
        r = (r << 1) & 0x1FFFFFF
        if r & 0x1000000:
            r ^= _GEN
    return np.array([(r >> (23 - i)) & 1 for i in range(24)], np.int8)


def _crc_matrix(nbits: int) -> np.ndarray:
    """H with H[i, j] = CRC bit i of the unit message e_j (CRC is GF(2)-
    linear, so crc(m) = H @ m mod 2)."""
    H = np.zeros((24, nbits), np.int8)
    for j in range(nbits):
        e = np.zeros(nbits, np.int8)
        e[j] = 1
        H[:, j] = _crc_bits_np(e)
    return H


_H112 = _crc_matrix(112)
_H56 = _crc_matrix(56)


def adsb_crc(bits) -> np.ndarray:
    """CRC-24 remainder of a 56/112-bit Mode S frame INCLUDING its parity
    field (all-zero iff the frame checks, modulo interrogator overlay)."""
    b = np.asarray(bits, np.int8)
    H = _H112 if len(b) == 112 else _H56
    return (H @ b) % 2


# ----------------------------------------------------------------------
# Waveform synthesis (for tests / loopback benches)
# ----------------------------------------------------------------------

def adsb_waveform(bits, osf: int = 2) -> np.ndarray:
    """Unit-amplitude magnitude envelope of preamble + PPM payload
    (osf samples per us, even)."""
    bits = np.asarray(bits, np.int8)
    hs = osf // 2                       # samples per half-slot
    pre = np.zeros(_PREAMBLE_US * osf, np.float32)
    for p in _PREAMBLE_HALFSLOTS:
        pre[p * hs:(p + 1) * hs] = 1.0
    pay = np.zeros(len(bits) * osf, np.float32)
    for k, b in enumerate(bits):
        off = k * osf + (0 if b else hs)
        pay[off:off + hs] = 1.0
    return np.concatenate([pre, pay])


# ----------------------------------------------------------------------
# Decoder
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AdsbConfig:
    """Parity: ADSBDecodeurConfig{fe, Ne}, protocols.hpp:12-16."""
    fe: float = 2e6              # sample rate (even integer x 1 MHz)
    Ne: int = 1 << 16            # block size (samples)
    threshold: float = 0.55      # preamble energy-concentration score
    max_frames: int = 8          # static candidate count per block

    @property
    def osf(self) -> int:
        osf = int(round(self.fe / 1e6))
        assert osf >= 2 and osf % 2 == 0 and abs(osf * 1e6 - self.fe) < 1, \
            "fe must be an even integer multiple of 1 MHz"
        return osf


class AdsbDecode(struct.PyTreeNode):
    """Device-side decode result — fixed shapes, ``valid`` mask."""
    position: jax.Array      # preamble start (sample index, int32, (K,))
    score: jax.Array         # preamble energy concentration in [0,1], (K,)
    bits: jax.Array          # (K, 112) int8 PPM decisions
    crc_ok: jax.Array        # (K,) bool — CRC-24 syndrome == 0
    valid: jax.Array         # (K,) bool — candidate mask


@dataclasses.dataclass
class AdsbFrame:
    """Parity: ADSBTrame{bs, score, texte}, protocols.hpp:18-23."""
    bits: np.ndarray
    score: float
    text: str
    position: int = 0
    crc_ok: bool = True


class AdsbDecoder:
    """One-shot / blockwise Mode S decoder.

    ``decode_block(x)`` is the jitted device path (magnitude in, fixed-K
    `AdsbDecode` out); ``decode(x)`` wraps it and returns CRC-validated
    `AdsbFrame` records with decoded text, like the declared reference
    callback API would have.
    """

    def __init__(self, cfg: AdsbConfig = AdsbConfig()):
        self.cfg = cfg
        osf = cfg.osf
        self._H = jnp.asarray(_H112.T, jnp.int32)        # (112, 24)
        self._frame_len = (_PREAMBLE_US + _FRAME_BITS) * osf
        self._decode_jit = jax.jit(self._decode_block)

    # -------------------------------------------------- device path --
    def _decode_block(self, mag: jax.Array) -> AdsbDecode:
        cfg, osf = self.cfg, self.cfg.osf
        hs, K = osf // 2, cfg.max_frames
        n = mag.shape[0]
        mag = mag.astype(jnp.float32)

        # sliding half-slot sums ps[i] = sum mag[i : i+hs]
        c = jnp.concatenate([jnp.zeros((1,), jnp.float32), jnp.cumsum(mag)])
        def wsum(w):
            return c[w:] - c[:-w] if w < n else c[-1:] - c[:1]
        ps = wsum(hs)                                  # len n-hs+1
        we = wsum(_PREAMBLE_US * osf)                  # 8-us window energy

        # 4-pulse correlation at every offset
        L = n - _PREAMBLE_US * osf + 1
        corr = sum(jax.lax.dynamic_slice(ps, (p * hs,), (L,))
                   for p in _PREAMBLE_HALFSLOTS)
        score = corr / (we[:L] + 1e-9)
        # absolute floor: pulses must rise above the block's mean level
        floor = jnp.mean(mag) * (4 * hs)
        score = jnp.where(corr > 2.0 * floor, score, 0.0)

        # a full frame must fit in the block — including the last data
        # half-slot's width-hs sum over ps (len n-hs+1), or dynamic_slice
        # would clamp and decode the final bits one sample off
        last = n - self._frame_len - (hs - 1)
        idx = jnp.arange(L)
        score = jnp.where(idx <= last, score, 0.0)

        # non-max suppression over +-1 preamble length, then top-K
        w = _PREAMBLE_US * osf
        pad = jnp.full((w,), -1.0, jnp.float32)
        ext = jnp.concatenate([pad, score, pad])
        win = jnp.stack([jax.lax.dynamic_slice(ext, (k,), (L,))
                         for k in range(2 * w + 1)])
        ismax = score >= jnp.max(win, axis=0)
        cand = jnp.where(ismax & (score > cfg.threshold), score, 0.0)
        top_s, top_p = jax.lax.top_k(cand, K)
        valid = top_s > 0.0

        # PPM bit decisions: compare half-bit energies
        def bits_at(p):
            base = p + _PREAMBLE_US * osf
            seg = jax.lax.dynamic_slice(ps, (base,), (_FRAME_BITS * osf,))
            first = seg[::osf]
            second = seg[hs::osf]
            return (first > second).astype(jnp.int8)
        bits = jax.vmap(bits_at)(top_p)               # (K, 112)

        # CRC syndrome for all K frames in one matmul mod 2.  The
        # all-zero word is a codeword of any linear code, and silence
        # (e.g. the zero padding of a flushed partial block) decodes to
        # exactly that — reject degenerate frames explicitly.
        syn = jnp.mod(bits.astype(jnp.int32) @ self._H, 2)   # (K, 24)
        crc_ok = (jnp.sum(syn, axis=-1) == 0) & jnp.any(bits != 0, axis=-1)

        return AdsbDecode(position=top_p.astype(jnp.int32), score=top_s,
                          bits=bits, crc_ok=crc_ok, valid=valid)

    def decode_block(self, mag: jax.Array) -> AdsbDecode:
        assert mag.shape[0] >= self._frame_len
        return self._decode_jit(mag)

    # ---------------------------------------------------- host path --
    def decode(self, x, crc_filter: bool = True) -> List[AdsbFrame]:
        """x: magnitude (real) or IQ (complex) samples at cfg.fe."""
        xa = np.asarray(x)
        mag = np.abs(xa).astype(np.float32) if np.iscomplexobj(xa) else \
            xa.astype(np.float32)
        d = self.decode_block(jnp.asarray(mag))
        pos = np.asarray(d.position)
        sc = np.asarray(d.score)
        bits = np.asarray(d.bits)
        ok = np.asarray(d.crc_ok)
        val = np.asarray(d.valid)
        out = []
        for k in np.argsort(pos):
            if not val[k] or (crc_filter and not ok[k]):
                continue
            out.append(AdsbFrame(bits=bits[k], score=float(sc[k]),
                                 text=decode_adsb_text(bits[k]),
                                 position=int(pos[k]), crc_ok=bool(ok[k])))
        return out


class AdsbStream:
    """Streaming wrapper: push arbitrary-size sample chunks, get frames
    (parity: the declared `ProtocoleDemodulateur` is a push Sink,
    protocols.hpp:44-47).  Re-blocks to the decoder's fixed jit size with
    a one-frame overlap so frames straddling a push/block boundary are
    never lost; overlap duplicates are deduped by absolute position."""

    def __init__(self, cfg: AdsbConfig = AdsbConfig()):
        self.dec = AdsbDecoder(cfg)
        # a block only emits starts p <= Ne - frame_len - (hs-1) (the
        # decoder's tail mask), so the next block must rewind far enough
        # to see p = Ne - frame_len - hs + 2 at a non-negative index
        self._overlap = self.dec._frame_len + cfg.osf // 2 - 2
        assert cfg.Ne > 2 * self._overlap, "Ne too small for the overlap"
        self._buf = np.zeros((0,), np.float32)
        self._base = 0            # absolute index of _buf[0]
        self._seen: set = set()

    def _emit(self, block: np.ndarray) -> List[AdsbFrame]:
        out: List[AdsbFrame] = []
        for fr in self.dec.decode(block):
            p = self._base + fr.position
            # +-2 tolerance: a boundary frame can re-detect one sample
            # off in the next (overlapped) block
            if all(abs(p - q) > 2 for q in self._seen):
                self._seen.add(p)
                fr.position = p
                out.append(fr)
        return out

    def push(self, x) -> List[AdsbFrame]:
        xa = np.asarray(x)
        mag = np.abs(xa).astype(np.float32) if np.iscomplexobj(xa) else \
            xa.astype(np.float32)
        self._buf = np.concatenate([self._buf, mag])
        Ne = self.dec.cfg.Ne
        out: List[AdsbFrame] = []
        while len(self._buf) >= Ne:
            out += self._emit(self._buf[:Ne])
            adv = Ne - self._overlap
            self._buf = self._buf[adv:]
            self._base += adv
            # positions older than the retained overlap can never recur
            self._seen = {p for p in self._seen if p >= self._base}
        return out

    def flush(self) -> List[AdsbFrame]:
        """Decode the final partial block of a finite capture (zero-pad
        to the jit size); call once at end of stream."""
        Ne = self.dec.cfg.Ne
        out: List[AdsbFrame] = []
        if len(self._buf) > 0:
            # re-decoding the already-seen overlap region is harmless:
            # _seen dedupes, and a capture shorter than one block has
            # never been decoded at all
            blk = np.concatenate([self._buf,
                                  np.zeros((Ne - len(self._buf),),
                                           np.float32)])
            out = self._emit(blk)
        # advance by the samples actually consumed, NOT the padded block
        # size: a later push on this object must report absolute
        # positions continuous with the true sample count
        self._base += len(self._buf)
        self._buf = np.zeros((0,), np.float32)
        self._seen = set()
        return out


# ----------------------------------------------------------------------
# Host-side field decoding (texte)
# ----------------------------------------------------------------------

_CHARSET = "#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####_###############0123456789######"


def _field(bits: np.ndarray, lo: int, hi: int) -> int:
    """Bits [lo, hi) MSB-first as an integer."""
    v = 0
    for b in bits[lo:hi]:
        v = (v << 1) | int(b)
    return v


def decode_adsb_text(bits) -> str:
    """Render a validated frame as text: DF, ICAO, and (DF17/18) the ME
    payload — callsign for TC 1-4, barometric altitude for TC 9-18."""
    b = np.asarray(bits, np.int8)
    df = _field(b, 0, 5)
    if df not in (17, 18) or len(b) < 112:
        return f"DF{df}"
    icao = _field(b, 8, 32)
    tc = _field(b, 32, 37)
    txt = f"DF{df} ICAO {icao:06X} TC{tc}"
    if 1 <= tc <= 4:
        cs = "".join(_CHARSET[_field(b, 40 + 6 * i, 46 + 6 * i)]
                     for i in range(8))
        txt += f" ident {cs.rstrip('_#')}"
    elif 9 <= tc <= 18:
        alt = _field(b, 40, 52)
        q = (alt >> 4) & 1
        if q:
            n = ((alt >> 5) << 4) | (alt & 0xF)      # drop the Q bit
            txt += f" alt {25 * n - 1000} ft"
        oddflag = b[53]
        lat = _field(b, 54, 71)
        lon = _field(b, 71, 88)
        txt += f" cpr[{int(oddflag)}] lat {lat} lon {lon}"
    return txt


# ----------------------------------------------------------------------
# CPR global position decoding (even/odd frame pair)
# ----------------------------------------------------------------------

def _nl(lat: float) -> int:
    """Number of longitude zones at latitude (CPR NL function)."""
    if abs(lat) >= 87.0:
        return 1 if abs(lat) > 87.0 else 2
    a = 1 - np.cos(np.pi / 30)
    return int(np.floor(2 * np.pi / np.arccos(
        1 - a / np.cos(np.pi / 180 * lat) ** 2)))


def cpr_global(lat_even: int, lon_even: int, lat_odd: int, lon_odd: int,
               newest_odd: bool = True) -> Optional[Tuple[float, float]]:
    """Globally-unambiguous airborne position from an even/odd CPR pair
    (17-bit fields as transmitted).  Returns (lat, lon) in degrees, or
    None if the pair straddles a latitude-zone boundary."""
    sc = 1.0 / (1 << 17)
    ce, co = lat_even * sc, lat_odd * sc
    j = np.floor(59 * ce - 60 * co + 0.5)
    dlat_e, dlat_o = 360.0 / 60, 360.0 / 59
    lat_e = dlat_e * (j % 60 + ce)
    lat_o = dlat_o * (j % 59 + co)
    lat_e -= 360.0 * (lat_e >= 270)
    lat_o -= 360.0 * (lat_o >= 270)
    if _nl(lat_e) != _nl(lat_o):
        return None
    lat = lat_o if newest_odd else lat_e
    nl = _nl(lat)
    i_ = 1 if newest_odd else 0
    ni = max(nl - i_, 1)
    xe, xo = lon_even * sc, lon_odd * sc
    m = np.floor(xe * (nl - 1) - xo * nl + 0.5)
    lon = (360.0 / ni) * (m % ni + (xo if newest_odd else xe))
    lon -= 360.0 * (lon >= 180)
    return float(lat), float(lon)
