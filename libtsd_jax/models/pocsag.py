"""POCSAG pager protocol: encoder, FSK waveform, and decoder.

Parity: the reference DECLARES this component but never implements it —
`demodulateur_pocsag()` and the `POCSAGDecodeurConfig{fe, fi, debit}` /
`POCSAGMessage{ric, function, texte}` structs exist only as a header
(core/include/tsd/telecom/protocols.hpp:25-48; no matching code in
core/src/).  This module is a working superset of the declared API.

Protocol (ITU-R M.584): 2-FSK (+-4.5 kHz) at 512/1200/2400 baud.  A
transmission is a >=576-bit alternating preamble followed by batches:
a 32-bit frame-sync codeword (0x7CD215D8) + 8 frames x 2 codewords.
Each 32-bit codeword is BCH(31,21) (generator x^10+x^9+x^8+x^6+x^5+x^3+1
= 0x769) plus an even-parity bit; address codewords carry the 18 RIC
MSBs (the 3 LSBs are the frame index) and 2 function bits; message
codewords carry 20 data bits (7-bit ASCII LSB-first for alpha, 4-bit
BCD for numeric).  Idle codeword: 0x7A89C197.

Design (same shapes-static discipline as models/adsb.py):

* the FM discriminator and the resample-to-8-samples/bit front end reuse
  the library blocks (`models/demod.quadrature_discriminator`,
  `ops/resample.resample`);
* bit-rate detection (``debit = -1``) runs the dense sync scan at each
  candidate baud and keeps the best normalized score — three jitted
  evaluations, no trial demodulation loop;
* frame sync is DENSE: the +-1 sync template is correlated at every
  sample offset via 32 shifted slices of the sliding bit-integral (the
  ADS-B preamble trick), so clock phase is recovered for free and both
  signal polarities are resolved from the score's sign;
* all 16 codewords of every detected batch are sampled with one vmapped
  dynamic_slice and BCH-checked in one GF(2) matmul; 1- and 2-bit errors
  (BCH(31,21) is double-error-correcting, d=5) are corrected by matching
  the 10-bit syndrome against the 31 single-column and 465 pair
  syndromes (one-hot compares, no host loop);
* message/text assembly from validated codewords is host-side string
  work, like the reference's `texte` field.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from .. import struct

from .demod import quadrature_discriminator
from ..ops.resample import resample

__all__ = ["PocsagConfig", "PocsagMessage", "PocsagDecoder",
           "pocsag_encode", "pocsag_waveform", "bch3121_encode",
           "FSC", "IDLE"]

FSC = 0x7CD215D8
IDLE = 0x7A89C197
_G = 0x769                    # BCH(31,21) generator polynomial
_BAUDS = (512, 1200, 2400)
_OSF = 8                      # samples per bit after the front end
_CW_BITS = 32
_BATCH_CW = 16                # codewords after the sync word
_BATCH_BITS = _CW_BITS * (1 + _BATCH_CW)   # 544


# ----------------------------------------------------------------------
# BCH(31,21) + parity as GF(2) linear algebra
# ----------------------------------------------------------------------

def bch3121_encode(data21: int) -> int:
    """21 data bits -> 32-bit codeword (BCH check bits + even parity)."""
    rem = data21 << 10
    for i in range(30, 9, -1):
        if rem & (1 << i):
            rem ^= _G << (i - 10)
    cw31 = (data21 << 10) | rem
    parity = bin(cw31).count("1") & 1
    return (cw31 << 1) | parity


def _syndrome_matrix() -> np.ndarray:
    """S (10, 31): column j = x^(30-j) mod g(x) — the syndrome of an
    error in TRANSMITTED bit j of the 31-bit codeword."""
    S = np.zeros((10, 31), np.int8)
    for j in range(31):
        rem = 1 << (30 - j)
        for i in range(30, 9, -1):
            if rem & (1 << i):
                rem ^= _G << (i - 10)
        S[:, j] = [(rem >> (9 - k)) & 1 for k in range(10)]
    return S


_SYN = _syndrome_matrix()


def _word_bits(w: int, n: int = 32) -> np.ndarray:
    return np.array([(w >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


# ----------------------------------------------------------------------
# Encoder (host) — also the test oracle
# ----------------------------------------------------------------------

_NUMCHARS = "0123456789*U -)("


def pocsag_encode(ric: int, function: int, text: str = "",
                  numeric: bool = False, npreamble: int = 576) -> np.ndarray:
    """Bit sequence of one POCSAG transmission carrying a single message
    (preamble + batches, idle-filled)."""
    frame = ric & 7
    # address data21 = flag(0) | 18 address MSBs | 2 function bits
    addr_cw = bch3121_encode(((ric >> 3) << 2) | (function & 3))
    msg_cws = []
    if text:
        if numeric:
            chunks = [_NUMCHARS.index(ch) for ch in text]
            # pad to the 20-bit codeword boundary with SPACE nibbles
            # (0xC) — zero-padding would decode as spurious '0' digits
            while (4 * len(chunks)) % 20:
                chunks.append(0xC)
            bits = []
            for v in chunks:
                bits += [(v >> k) & 1 for k in range(4)]   # LSB first
        else:
            bits = []
            for ch in text:
                v = ord(ch) & 0x7F
                bits += [(v >> k) & 1 for k in range(7)]   # LSB first
            while len(bits) % 20:
                bits.append(0)
        for i in range(0, len(bits), 20):
            data20 = 0
            for b in bits[i:i + 20]:
                data20 = (data20 << 1) | b
            msg_cws.append(bch3121_encode((1 << 20) | data20))

    # lay codewords into batches: address at its frame slot, message
    # words immediately after, idle elsewhere
    slots = [IDLE] * (2 * 8)
    pos = 2 * frame
    slots[pos] = addr_cw
    k = pos + 1
    extra: List[int] = []
    for cw in msg_cws:
        if k < 16:
            slots[k] = cw
            k += 1
        else:
            extra.append(cw)
    batches = [slots]
    while extra:
        nxt, extra = extra[:16], extra[16:]
        batches.append(nxt + [IDLE] * (16 - len(nxt)))

    out = [np.tile([1, 0], npreamble // 2).astype(np.int8)]
    for b in batches:
        out.append(_word_bits(FSC))
        for cw in b:
            out.append(_word_bits(cw))
    return np.concatenate(out)


def pocsag_waveform(bits, fe: float, debit: int, fi: float = 0.0,
                    deviation: float = 4500.0) -> np.ndarray:
    """Complex-baseband 2-FSK signal at fe: bit '0' -> +deviation,
    bit '1' -> -deviation (ITU-R M.584 sense), carrier offset fi."""
    bits = np.asarray(bits, np.int8)
    osf = fe / debit
    n = int(np.ceil(len(bits) * osf))
    t = np.arange(n)
    nrz = 1.0 - 2.0 * bits[np.minimum((t / osf).astype(np.int64),
                                      len(bits) - 1)]
    finst = fi + deviation * nrz
    phase = 2 * np.pi * np.cumsum(finst) / fe
    return np.exp(1j * phase).astype(np.complex64)


# ----------------------------------------------------------------------
# Decoder
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PocsagConfig:
    """Parity: POCSAGDecodeurConfig{debug_actif, fe, fi, debit},
    protocols.hpp:25-35 (debit -1 = auto detection)."""
    fe: float = 38400.0
    fi: float = 0.0
    debit: int = -1              # 512 | 1200 | 2400 | -1 (auto)
    threshold: float = 0.6       # normalized sync-correlation score
    max_batches: int = 8         # static candidate count per call


@dataclasses.dataclass
class PocsagMessage:
    """Parity: POCSAGMessage{ric, function, texte}, protocols.hpp:37-42."""
    ric: int
    function: int
    text: str


class PocsagBatches(struct.PyTreeNode):
    """Device-side scan result — fixed shapes, ``valid`` mask."""
    position: jax.Array    # sync-word start in 8-samp/bit stream, (B,)
    score: jax.Array       # |normalized sync correlation|, (B,)
    bits: jax.Array        # (B, 16, 32) int8 corrected codeword bits
    cw_ok: jax.Array       # (B, 16) bool — BCH + parity valid
    valid: jax.Array       # (B,) bool


class PocsagDecoder:
    """decode(x) -> list[PocsagMessage].  x: complex IQ at cfg.fe
    (discriminated internally) or an already-discriminated real NRZ
    baseband."""

    def __init__(self, cfg: PocsagConfig = PocsagConfig()):
        self.cfg = cfg
        # host-side constants, embedded in the jitted fns as literals
        self._sync = (1.0 - 2.0 * _word_bits(FSC)).astype(np.float32)
        self._S = _SYN.T.astype(np.int32)                # (31, 10)
        # two-error tables: pair syndromes and their flip masks.  d=5
        # guarantees every pair syndrome is nonzero, distinct from every
        # single-column syndrome and from every other pair — the compares
        # below are one-hot
        pairs = [(i, j) for i in range(31) for j in range(i + 1, 31)]
        self._S2 = np.array([_SYN[:, i] ^ _SYN[:, j] for i, j in pairs],
                            np.int32)                    # (465, 10)
        M2 = np.zeros((len(pairs), 31), np.int32)
        for k, (i, j) in enumerate(pairs):
            M2[k, i] = M2[k, j] = 1
        self._M2 = M2                                    # (465, 31)
        self._scan_jit = {}

    # -------------------------------------------------- device path --
    def _scan(self, d: jax.Array, baud: int) -> PocsagBatches:
        """d: discriminator output at cfg.fe; returns batch candidates in
        the resampled 8-samples/bit domain."""
        cfg = self.cfg
        # trailing silence: flushes the resampler's group delay and
        # guarantees a transmission ending at the signal's last sample
        # still has a full batch window after its sync position
        npad = int(np.ceil(64 * cfg.fe / baud))
        d = jnp.concatenate([d.astype(jnp.float32),
                             jnp.zeros((npad,), jnp.float32)])
        y = resample(d, _OSF * baud / cfg.fe)
        n = y.shape[0]
        # sliding one-bit integral; s > 0 <=> '0' (positive deviation)
        c = jnp.concatenate([jnp.zeros((1,), jnp.float32), jnp.cumsum(y)])
        s = c[_OSF:] - c[:-_OSF]
        # zero-pad so a full batch always fits after any candidate sync
        # position (keeps every slice below static-shape and in range even
        # when probing a wrong candidate baud on a short signal)
        need = _BATCH_BITS * _OSF + cfg.max_batches
        if s.shape[0] < need:
            s = jnp.concatenate(
                [s, jnp.zeros((need - s.shape[0],), jnp.float32)])
        L = s.shape[0] - _BATCH_BITS * _OSF
        # dense +-1 sync correlation (bit k at offset 8k)
        corr = sum(float(t) * jax.lax.dynamic_slice(s, (k * _OSF,), (L,))
                   for k, t in enumerate(np.asarray(self._sync)))
        nrm = sum(jnp.abs(jax.lax.dynamic_slice(s, (k * _OSF,), (L,)))
                  for k in range(_CW_BITS))
        # bit '0' -> +deviation -> positive bit integral, template +1:
        # score -> +1 at a sync with normal polarity, -1 inverted.  (The
        # sign MUST come from the sync, not the BCH: the complement of a
        # valid codeword is itself valid — all-ones is a codeword — so
        # an inverted batch would decode to syntactically valid garbage.)
        # energy floor: at half-bit offsets inside the alternating
        # preamble every bit integral is ~0, and corr/nrm would be an
        # amplified noise ratio — require the window to hold real bit
        # energy before normalizing
        floor = 0.5 * _CW_BITS * jnp.mean(jnp.abs(s))
        score = jnp.where(nrm > floor, corr / (nrm + 1e-9), 0.0)
        a = jnp.abs(score)

        # EXACT non-max suppression over +-w, two stages: (1) one winner
        # per w-sized block (argmax, first index on ties — noise-free
        # signals produce flat score plateaus); (2) a winner dies only to
        # a strictly-better winner whose POSITION is within w (any point
        # within +-w of a block's winner lies in the same or an adjacent
        # block, so comparing neighbor winners with a distance gate is
        # exhaustive AND never over-suppresses; ties go to the earlier)
        w = _BATCH_BITS * _OSF // 2
        nb = -(-L // w)
        ab = jnp.concatenate([a, jnp.zeros((nb * w - L,), jnp.float32)])
        blocks = ab.reshape(nb, w)
        bm = blocks.max(axis=1)
        wi = jnp.argmax(blocks, 1) + jnp.arange(nb) * w   # flat positions
        pv, pw = jnp.concatenate([bm[:1] * 0, bm[:-1]]), \
            jnp.concatenate([wi[:1] * 0 - 2 * w, wi[:-1]])
        nv, nw = jnp.concatenate([bm[1:], bm[-1:] * 0]), \
            jnp.concatenate([wi[1:], wi[-1:] * 0 + 3 * nb * w])
        lose_prev = (wi - pw <= w) & (pv >= bm)       # earlier wins ties
        lose_next = (nw - wi <= w) & (nv > bm)
        keep = ~(lose_prev | lose_next)
        onehot = jnp.arange(w)[None, :] == jnp.argmax(blocks, 1)[:, None]
        ismax = (onehot & keep[:, None]).reshape(-1)[:L]
        cand = jnp.where(ismax & (a > cfg.threshold), a, 0.0)
        top_s, top_p = jax.lax.top_k(cand, cfg.max_batches)
        valid = top_s > 0.0
        pol = jnp.sign(jnp.take(score, top_p))   # +1 normal, -1 inverted

        def batch_bits(p, sg):
            seg = jax.lax.dynamic_slice(
                s, (p + _CW_BITS * _OSF,), (_BATCH_CW * _CW_BITS * _OSF,))
            soft = -sg * seg[::_OSF]              # >0 <=> bit '1'
            return (soft > 0).astype(jnp.int8).reshape(_BATCH_CW, _CW_BITS)
        bits = jax.vmap(batch_bits)(top_p, pol)   # (B, 16, 32)

        # BCH syndrome decoding, all codewords at once.  BCH(31,21) has
        # minimum distance 5 — DOUBLE-error-correcting: match the syndrome
        # against the 31 single-bit columns AND the 465 two-bit pair
        # syndromes (a one-hot compare each; single-error match preferred)
        cw31 = bits[..., :31].astype(jnp.int32)
        syn = jnp.mod(cw31 @ self._S, 2)                    # (B, 16, 10)
        clean = jnp.sum(syn, -1) == 0
        hit1 = jnp.all(syn[..., None, :] == self._S[None, None], -1)
        hit2 = jnp.all(syn[..., None, :] == self._S2[None, None], -1)
        flip2 = jnp.mod(hit2.astype(jnp.int32) @ self._M2, 2)  # (B,16,31)
        single = jnp.any(hit1, -1)
        double = jnp.any(hit2, -1)
        flip = jnp.where(single[..., None], hit1.astype(jnp.int8),
                         flip2.astype(jnp.int8))
        corrected = bits[..., :31] ^ flip
        bits = jnp.concatenate([corrected, bits[..., 31:]], -1)
        # d=6 decision table over (syndrome class, PRE-correction overall
        # parity par0).  The parity bit is OUTSIDE the syndrome, so under
        # the <=2-error assumption:
        #   clean  + par0 even -> 0 errors           : accept
        #   clean  + par0 odd  -> parity-bit error   : accept (data fine)
        #   single + par0 odd  -> 1 data error       : accept (corrected)
        #   single + par0 even -> data+parity errors : accept (corrected)
        #   double + par0 even -> 2 data errors      : accept (corrected)
        #   double + par0 odd  -> >=3 errors         : reject
        # (the earlier post-correction-parity gate wrongly rejected every
        # correctable pattern that included the parity bit)
        par0 = (jnp.sum(corrected ^ flip, -1)        # original 31 bits
                + bits[..., 31].astype(jnp.int32)) % 2
        cw_ok = clean | single | (double & (par0 == 0))
        return PocsagBatches(position=top_p.astype(jnp.int32),
                             score=top_s, bits=bits, cw_ok=cw_ok,
                             valid=valid)

    def scan(self, d: jax.Array, baud: int) -> PocsagBatches:
        if baud not in self._scan_jit:
            self._scan_jit[baud] = jax.jit(self._scan,
                                           static_argnums=(1,))
        return self._scan_jit[baud](d, baud)

    # ---------------------------------------------------- host path --
    def decode(self, x, return_baud: bool = False):
        cfg = self.cfg
        def front(re, im):
            z = re + 1j * im
            if cfg.fi:
                rot = jnp.exp(-2j * jnp.pi * cfg.fi / cfg.fe
                              * jnp.arange(re.shape[0]))
                z = z * rot.astype(z.dtype)
            return quadrature_discriminator(z)

        if not jnp.iscomplexobj(x):          # dtype check, no transfer
            d = jnp.asarray(x)
        elif isinstance(x, jax.Array):       # already on device
            d = jax.jit(lambda z: front(z.real, z.imag))(x)
        else:
            # ship the real/imag planes and rebuild + mix + discriminate
            # inside one jit (config.to_ri)
            xh = np.asarray(x)
            d = jax.jit(front)(jnp.asarray(xh.real, jnp.float32),
                               jnp.asarray(xh.imag, jnp.float32))
        bauds = _BAUDS if cfg.debit == -1 else (cfg.debit,)
        best, best_peak, best_baud = None, -1.0, 0
        for baud in bauds:
            r = self.scan(d, baud)
            psv = self._readback(r)
            B = self.cfg.max_batches
            peak = float(np.max(np.where(psv[2 * B:] > 0, psv[B:2 * B],
                                         0.0), initial=0.0))
            if best is None or peak > best_peak:
                best, best_peak, best_baud = (r, psv), peak, baud
        msgs = self._assemble(*best)
        return (msgs, best_baud) if return_baud else msgs

    def _readback(self, r: PocsagBatches) -> np.ndarray:
        """One packed (3B,) host read of position/score/valid instead of
        three tiny (B=8) per-field transfers."""
        if not hasattr(self, "_pack_jit"):
            self._pack_jit = jax.jit(lambda p, s, v: jnp.concatenate(
                [p.astype(jnp.float32), s, v.astype(jnp.float32)]))
        return np.asarray(self._pack_jit(r.position, r.score, r.valid))

    def _assemble(self, r: PocsagBatches,
                  psv: Optional[np.ndarray] = None) -> List[PocsagMessage]:
        """Walk validated codewords in transmission order (parity: the
        reference's declared callback yielding POCSAGMessage records)."""
        if psv is None:
            psv = self._readback(r)
        B = self.cfg.max_batches
        pos = psv[:B].astype(np.int64)
        bits = np.asarray(r.bits)
        ok = np.asarray(r.cw_ok)
        val = psv[2 * B:] > 0
        order = [k for k in np.argsort(pos) if val[k]]
        msgs: List[PocsagMessage] = []
        cur: Optional[Tuple[int, int]] = None   # (ric, function)
        data_bits: List[int] = []

        def flush():
            nonlocal cur, data_bits
            if cur is not None:
                ric, fn = cur
                msgs.append(PocsagMessage(
                    ric=ric, function=fn,
                    text=_decode_text(data_bits, fn)))
            cur, data_bits = None, []

        for k in order:
            for f in range(_BATCH_CW):
                if not ok[k, f]:
                    flush()
                    continue
                w = bits[k, f]
                word = 0
                for b in w:
                    word = (word << 1) | int(b)
                if w[0] == 0:                       # address / idle
                    flush()
                    if word == IDLE:
                        continue
                    # RIC = 18 transmitted address bits << 3 | frame index
                    addr18 = (word >> 13) & 0x3FFFF
                    fn = (word >> 11) & 3
                    cur = ((addr18 << 3) | (f // 2), fn)
                else:                               # message
                    if cur is not None:
                        data_bits += [int(b) for b in w[1:21]]
        flush()
        return msgs


def _decode_text(data_bits: List[int], function: int) -> str:
    """Message payload: alpha (7-bit ASCII, LSB transmitted first) for
    function 3, numeric (4-bit BCD) for functions 0-2."""
    if not data_bits:
        return ""
    if function == 3:
        out = []
        for i in range(0, len(data_bits) - 6, 7):
            v = sum(b << k for k, b in enumerate(data_bits[i:i + 7]))
            if v == 0:
                break
            out.append(chr(v))
        return "".join(out).rstrip("\x04\x17")
    out = []
    for i in range(0, len(data_bits) - 3, 4):
        v = sum(b << k for k, b in enumerate(data_bits[i:i + 4]))
        out.append(_NUMCHARS[v])
    # trailing SPACE nibbles are codeword padding (see pocsag_encode)
    return "".join(out).rstrip(" ")
