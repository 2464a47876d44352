"""Frame transmitter and receiver.

Parity: Émetteur (core/src/telecom/emetteur.cc:14-125) and Récepteur
(core/src/telecom/recepteur.cc:31-785) — the reference's flagship composite
(SURVEY §3.4).

Design: the receiver computes header correlation densely (Detector),
then extracts a FIXED-length frame at each detected position with
`dynamic_slice` and masking — no data-dependent shapes (SURVEY hard-part
#3).  Header-derived RF parameters (gain, phase, fractional delay) correct
the frame before matched filtering; symbol timing comes from the header
position, so the steady-state path needs no timing loop; a decision PLL
tracks residual phase.
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
from ..ops.resample import Interpolator, make_interpolator
from ..ops.signal import cycles
from .carrier_rec import Cpll, CpllConfig
from .detector import Detection, Detector, DetectorConfig
from .modulator import ModConfig, Modulator
from .waveform import Waveform, symbol_indices_to_bits

__all__ = ["FrameFormat", "Transmitter", "Receiver", "FrameRx",
           "MonitoredReceiver", "StreamReceiver"]


@dataclasses.dataclass(frozen=True)
class FrameFormat:
    """Parity: TrameFormat, telecom.hpp:1205-1218.

    ``header_wf``: optional distinct waveform for the sync header
    (parity: fo_entete, telecom.hpp:1214 — robust-header mode, e.g. a
    BPSK header in front of a QAM payload).  It must share the payload
    waveform's pulse shape: the reference's emitter shapes both through
    ONE filter (emetteur.cc:80-95, def_forme_onde swaps only the symbol
    mapper).  Rotating payload waveforms (pi/4-QPSK) are not supported
    together with a distinct header (the payload's rotation parity would
    need to continue through the header's symbol count)."""
    modulation: ModConfig = None
    header_bits: tuple = ()        # sync word (entête)
    payload_bits: int = 256        # nbits payload per frame
    header_wf: object = None       # fo_entete (None = payload waveform)


class Transmitter(Block):
    """header + payload -> modulated frame samples (parity: Émetteur,
    emetteur.cc:14-125; distinct header waveform per emetteur.cc:80-95)."""

    mod: Modulator
    hdr_wf: Optional[Waveform]
    fmt: FrameFormat = struct.field(pytree_node=False)

    @classmethod
    def create(cls, fmt: FrameFormat) -> "Transmitter":
        hdr_wf = fmt.header_wf
        if hdr_wf is not None:
            if fmt.modulation.wf.rotating:
                raise ValueError("distinct header waveform + rotating "
                                 "payload waveform is unsupported")
            if len(fmt.header_bits) % hdr_wf.info.k:
                raise ValueError("header bit count must be a multiple of "
                                 "the header waveform's bits/symbol")
        fmt_static = dataclasses.replace(
            fmt, header_wf=None,
            modulation=dataclasses.replace(fmt.modulation, wf=None))
        return cls(mod=Modulator.create(fmt.modulation), hdr_wf=hdr_wf,
                   fmt=fmt_static)

    def init(self):
        return self.mod.init()

    @property
    def delay(self):
        return self.mod.delay

    def step(self, state, payload_bits: jax.Array):
        hdr = jnp.asarray(self.fmt.header_bits, jnp.int8)
        if self.hdr_wf is None:
            bits = jnp.concatenate([hdr, payload_bits.astype(jnp.int8)])
            return self.mod.step(state, bits)
        # fo_entete: header symbols from the header waveform, payload
        # symbols from the payload waveform, ONE shared shaping filter
        # (symbol-stream concatenation == the reference's two step()
        # calls on one modulator, emetteur.cc:88-94)
        syms = jnp.concatenate([
            self.hdr_wf.make_symbols(hdr),
            self.mod.wf.make_symbols(payload_bits.astype(jnp.int8))])
        return self.mod.step_symbols(state, syms)

    def transmit(self, payload_bits: jax.Array) -> jax.Array:
        """One-shot: frame samples including modulator flush."""
        st = self.init()
        st, y1 = self.step(st, payload_bits)
        _, y2 = self.mod.flush(st)
        return jnp.concatenate([y1, y2])


class FrameRx(struct.PyTreeNode):
    """One received frame (parity: RécepteurTrame, telecom.hpp:1256-1272)."""
    bits: jax.Array        # decoded payload bits
    symbols: jax.Array     # payload symbols after correction
    detection: Detection   # the header detection (single entry slices)
    EbN0_db: jax.Array
    valid: jax.Array


class Receiver(Block):
    """Streaming frame receiver (parity: Récepteur/RécepteurImpl,
    recepteur.cc:31-785).

    step(state, x) processes one block and returns up to
    ``2 * detector.cfg.max_peaks`` frame slots with validity flags: this
    block's complete detections plus last block's deferred ones.  A frame
    whose payload extends past the block edge is NOT extracted early —
    its detection is carried and extracted next block against the
    ``hist_len`` history, so off-edge frames decode from the full data.
    Each input block must be at least ``frame_len + 2*itp.K`` samples.
    """

    det: Detector
    mf: Fir
    pll: Cpll
    wf: Waveform
    hdr_wf: Optional[Waveform]     # distinct header waveform (fo_entete)
    itp: Interpolator
    fmt: FrameFormat = struct.field(pytree_node=False)
    nsym_header: int = struct.field(pytree_node=False)
    nsym_payload: int = struct.field(pytree_node=False)
    frame_len: int = struct.field(pytree_node=False)
    hist_len: int = struct.field(pytree_node=False)
    mod_delay: float = struct.field(pytree_node=False)
    dt_mod: float = struct.field(pytree_node=False)  # δt_modulateur
    # residual-phase PLL update stride (1 = per-symbol exact loop;
    # G > 1 = one update per G symbols via Cpll.step_grouped — ~G x
    # shorter sequential chain per extracted frame)
    pll_stride: int = struct.field(pytree_node=False, default=1)

    @classmethod
    def create(cls, fmt: FrameFormat,
               det_cfg: DetectorConfig = DetectorConfig(),
               pll_stride: int = 1) -> "Receiver":
        wf = fmt.modulation.wf
        hdr_wf = fmt.header_wf if fmt.header_wf is not None else wf
        if fmt.header_wf is not None and wf.rotating:
            raise ValueError("distinct header waveform + rotating "
                             "payload waveform is unsupported")
        osf = fmt.modulation.osf
        # header reference waveform (shaped), generated at BASEBAND: for an
        # IF signal (fi != 0) the receiver mixes to baseband first
        # (recepteur.cc:236-238 sets fi=0 on the data demod for the same
        # reason), so the detection pattern is always baseband
        hdr_bits = jnp.asarray(fmt.header_bits, jnp.int8)
        mod_bb = dataclasses.replace(fmt.modulation, fi=0.0)
        mod = Modulator.create(mod_bb)
        # jit the factory-time modulation with the modulator passed as a
        # pytree ARGUMENT (one compiled call instead of eager op-by-op
        # dispatch); the header comes back as real/imag planes
        def _hdr(m, hw, b):
            # header symbols come from the HEADER waveform; the shaping
            # filter is the payload modulator's (the emitter's single
            # shared filter, emetteur.cc:80-95)
            st = m.init()
            st, y1 = m.step_symbols(st, hw.make_symbols(b))
            _, y2 = m.flush(st)
            w = jnp.concatenate([y1, y2])
            return jnp.stack([jnp.real(w), jnp.imag(w)])
        planes = np.asarray(jax.jit(_hdr)(mod, hdr_wf, hdr_bits))
        hdr_wave = planes[0] + 1j * planes[1]
        k = wf.info.k
        k_hdr = hdr_wf.info.k
        if len(fmt.header_bits) % k_hdr or fmt.payload_bits % k:
            raise ValueError(
                f"header ({len(fmt.header_bits)}) bits must be a multiple "
                f"of the header waveform's k={k_hdr} and payload "
                f"({fmt.payload_bits}) of the payload waveform's k={k} "
                f"bits/symbol — a partial symbol would silently shift "
                f"every following symbol (pad the sync word: e.g. 66 "
                f"header bits for 8-PSK)")
        nsym_header = len(fmt.header_bits) // k_hdr
        nsym_payload = fmt.payload_bits // k
        d = int(round(mod.delay))
        # non-integer modulator latency: the pattern starts dt_mod samples
        # AFTER the first symbol center (δt_modulateur, recepteur.cc:95,249)
        dt_mod = d - mod.delay
        hdr_ref = hdr_wave[d:d + nsym_header * osf]
        mf = wf.shaping.matched_filter(fmt.modulation.ncoefs, osf)
        frame_len = (nsym_header + nsym_payload) * osf + 2 * int(mf.delay) + osf
        det = Detector.create(np.asarray(hdr_ref), det_cfg)
        pll = Cpll(cfg=CpllConfig(ped="dec", M=wf.info.M, order=2, BL=0.02),
                   wf=wf)
        # fractional-delay interpolator bank (parity: itrp_sinc + regle_delais,
        # recepteur.cc:131-160, itrp.cc:11-57); fcut 0.45 per recepteur.cc:293
        itp = make_interpolator("sinc", ncoefs=15, nphases=256,
                                fcut=0.45 if osf > 1 else 0.5)
        fmt_static = dataclasses.replace(
            fmt, header_wf=None,
            modulation=dataclasses.replace(fmt.modulation, wf=None))
        # history budget: a deferred detection (frame cut by the block
        # edge) is re-extracted next block starting up to
        # frame_len + 2K + int(mf.delay) samples back — keep that much
        # plus the detector's own M-sample lag
        hist_len = frame_len + det.M + 3 * itp.K + int(mf.delay)
        return cls(det=det, mf=mf, pll=pll, wf=wf,
                   hdr_wf=fmt.header_wf, itp=itp, fmt=fmt_static,
                   nsym_header=nsym_header,
                   nsym_payload=nsym_payload, frame_len=frame_len,
                   hist_len=hist_len,
                   mod_delay=mod.delay, dt_mod=dt_mod,
                   pll_stride=pll_stride)

    def _empty_dets(self) -> Detection:
        P = self.det.cfg.max_peaks
        z = jnp.zeros((P,), real_dtype)
        return Detection(position=jnp.zeros((P,), jnp.int32),
                         position_frac=z, score=z, gain=z, theta=z,
                         snr_db=z, valid=jnp.zeros((P,), bool))

    def init(self):
        return dict(
            det=self.det.init(),
            # carried raw samples so frames straddling block edges survive
            hist=jnp.zeros((self.hist_len,), complex_dtype),
            # IF mixer NCO phase in CYCLES, wrapped to [0, 1) every block
            # (an unbounded sample counter in float32 would lose phase
            # accuracy on long streams)
            phi0=jnp.zeros((), real_dtype),
            # detections whose payload had not fully arrived at the block
            # edge: re-extracted against the carried history next block
            pending=self._empty_dets(),
        )

    def _front(self, state, x: jax.Array):
        """Stage 1 (mon 'recepteur/ola'): IF mixdown + header detection +
        block-edge deferral.  Returns (new_state, dets, buf) where buf =
        [hist | x] baseband and dets = [last block's deferred detections |
        this block's complete ones] (2*max_peaks entries).

        Deferral: the detector emits a peak exactly once, in the block
        where the header's correlation index falls — but the frame's
        PAYLOAD may extend past that block's end.  Such detections are
        carried (position shifted by -n) and extracted next block against
        the history, which is sized for it (hist_len)."""
        n = x.shape[-1]
        fi = self.fmt.modulation.fi
        if fi != 0.0:
            # mix to baseband with a phase-continuous NCO (fi != 0 path;
            # the reference pushes fi into its demod config instead,
            # recepteur.cc:236-238 — a front-end mixer is the vectorized
            # equivalent: one vectorized rotation, everything downstream
            # stays baseband).  Phase = phi0 + f*m cycles with phi0 wrapped
            # every block; the per-block increment is reduced mod 1 in
            # float64 on host (f and n are static), so no f32 accumulation.
            f = fi / self.fmt.modulation.fe
            # host-f64-exact wrapped ramp (the prior UNREDUCED f32 ramp
            # scrambled the mixer phase for blocks past ~1e6 samples)
            ph = state["phi0"] + cycles(f, n)
            x = x * jnp.exp(-2j * jnp.pi * ph).astype(complex_dtype)
            phi0 = jnp.mod(state["phi0"] + jnp.asarray((f * n) % 1.0,
                                                       real_dtype), 1.0)
        else:
            phi0 = state["phi0"]
        dstate, (dets, score) = self.det.step(state["det"], x)
        buf = jnp.concatenate([state["hist"], x])
        # partition: a detection is complete when the whole frame (+ the
        # interpolator support) is inside buf; otherwise defer one block
        safe = dets.valid & (dets.position
                             <= n - self.frame_len - 2 * self.itp.K)
        cur = dets.replace(valid=safe)
        pend = dets.replace(position=dets.position - n,
                            valid=dets.valid & ~safe)
        alldets = jax.tree_util.tree_map(
            lambda a, b: jnp.concatenate([a, b]), state["pending"], cur)
        new_state = dict(det=dstate, hist=buf[-self.hist_len:],
                         phi0=phi0, pending=pend)
        return new_state, alldets, buf, score

    def _extract_all(self, buf, dets, debug: bool = False):
        """Stage 2 (mon 'recepteur/demod'): per-detection frame extraction,
        fractional-delay correction, matched filter, decisions.

        ``debug=True`` additionally returns a pytree of per-stage
        intermediate signals per detection (parity: the reference's
        debug_actif figures, recepteur.cc:589-618 buffer/zoom/sub-buffer
        and 726-757 x/x1/y/y1/y2/y3 + constellation)."""
        cfg = self.fmt
        osf = cfg.modulation.osf
        k = self.wf.info.k
        H = self.hist_len
        K = self.itp.K
        # matched-filter delay split into integer + fractional parts: the
        # slice starts e samples BEFORE the pattern (so the causal MF is
        # warmed up by the time the first symbol arrives) and the
        # half-sample residue r (even tap counts) rides the fractional
        # interpolator
        e = int(np.floor(self.mf.delay))
        r = float(self.mf.delay) - e

        def extract(pos, frac, gain, theta):
            # effective fractional timing: detector sub-sample refinement
            # minus the pattern's own fractional start offset, plus the
            # matched filter's fractional delay residue
            eff = frac - self.dt_mod + r
            fshift = jnp.floor(eff)
            tau = eff - fshift                  # in [0, 1)
            # pos is relative to current block; in buf it's at pos + H.
            # slice K//2 early to feed the interpolator's left support,
            # and e early for MF warm-up
            start = pos + H + fshift.astype(jnp.int32) - K // 2 - e
            start = jnp.clip(start, 0, buf.shape[0] - (self.frame_len + K))
            raw = jax.lax.dynamic_slice_in_dim(buf, start,
                                               self.frame_len + K)
            # RF corrections from the header detection
            fr = raw * jnp.exp(-1j * theta).astype(complex_dtype) / \
                jnp.maximum(gain, 1e-6)
            # fractional-delay interpolation: y[n] = buf(pos - e + n + eff)
            # via the windowed-sinc phase LUT (parity: regle_delais +
            # filtre_itrp, recepteur.cc:131-160,672)
            taps = self.itp.taps(tau).astype(real_dtype)
            y = jnp.correlate(fr, taps.astype(complex_dtype), mode="valid")
            y = y[: self.frame_len]
            if self.wf.info.is_fsk:
                # FSK decodes the instantaneous FREQUENCY: quadrature
                # discriminator normalized so the constellation levels
                # come out directly (same scaling as Demodulator step 2;
                # parity: the reference's receiver demod routes FSK
                # through its discriminator too, demod-ndec.cc)
                from .demod import quadrature_discriminator
                om_max = np.pi * self.wf.info.index / osf
                y = (quadrature_discriminator(y)
                     / om_max).astype(complex_dtype)
            # matched filter (warm: y starts e samples before the pattern)
            _, z = self.mf.step(self.mf.init_for(y), y)
            # symbols at header-derived timing: pattern starts at y-index
            # e, first symbol center mf.delay later -> z index 2e (+r via
            # the interpolator)
            sym_idx = 2 * e + osf * jnp.arange(self.nsym_header
                                               + self.nsym_payload)
            syms = z[sym_idx]
            # decision PLL over the whole frame tracks residual phase
            # (meaningless after the FSK discriminator: the signal is a
            # real frequency track, not a rotating constellation)
            hw = self.wf if self.hdr_wf is None else self.hdr_wf
            ref_h = hw.make_symbols(
                jnp.asarray(self.fmt.header_bits, jnp.int8))
            if self.wf.info.is_fsk:
                syms_c = syms
            elif self.hdr_wf is None:
                if self.pll_stride > 1:
                    _, syms_c = self.pll.step_grouped(
                        self.pll.init(), syms, self.pll_stride)
                else:
                    _, syms_c = self.pll.step(self.pll.init(), syms)
            else:
                # fo_entete: the payload PED would mis-decide the header
                # constellation — track the header data-aided (the sync
                # word is known), then decision-directed on the payload
                nsym = self.nsym_header + self.nsym_payload
                refs = jnp.concatenate([
                    ref_h.astype(complex_dtype),
                    jnp.zeros((self.nsym_payload,), complex_dtype)])
                aided = jnp.arange(nsym) < self.nsym_header
                _, syms_c = self.pll.step_aided(self.pll.init(), syms,
                                                refs, aided,
                                                G=self.pll_stride)
            pay = syms_c[self.nsym_header:]
            idx = self.wf.closest(pay)
            bits = symbol_indices_to_bits(idx, k)
            if self.wf.rotating:
                # EVM reference on the UNION constellation: closest()
                # de-rotates internally, so symbols[idx] lives in the
                # de-rotated domain while pay does not — comparing them
                # directly would inflate the EVM 45 deg on odd symbols
                # (caught by the pi/4-QPSK receiver golden's EbN0 gate)
                cpts = self.wf.constellation()
                du = jnp.abs(pay[..., None] - cpts[None, :]) ** 2
                ref_p = cpts[jnp.argmin(du, axis=-1)]
            else:
                ref_p = self.wf.symbols[idx]
            # Eb/N0 from the full-frame error vector: known header symbols
            # plus decision-directed payload (many more samples than the
            # header alone, so the estimate doesn't floor at high SNR);
            # EsN0 -> /k bits per symbol
            ref = jnp.concatenate([ref_h, ref_p])
            evm2 = jnp.mean(jnp.abs(syms_c - ref) ** 2)
            sig = jnp.mean(jnp.abs(ref) ** 2)
            esn0 = sig / jnp.maximum(evm2, 1e-12)
            # bits per symbol averaged over the frame: with a distinct
            # header waveform the header symbols carry k_hdr bits each
            # (dividing by the payload k alone would bias EbN0 by
            # ~10*log10(k/k_eff) dB on fo_entete frames)
            nsym = self.nsym_header + self.nsym_payload
            k_eff = (self.nsym_header * hw.info.k
                     + self.nsym_payload * k) / nsym
            ebn0_db = 10 * jnp.log10(esn0 / k_eff + 1e-12)
            if not debug:
                return bits, pay, ebn0_db
            # per-stage capture, named after the reference's debug plots
            # (recepteur.cc:726-757: x, x1, y(itrp), y1(fa), y3(decim))
            dbg = dict(
                x=raw,                  # extracted frame, uncorrected
                x1=fr,                  # gain/phase corrected
                y=y,                    # after fractional-delay interp
                z=z,                    # after matched filter
                syms=syms,              # symbols at header timing
                syms_c=syms_c,          # after the decision/aided PLL
                pll_phase=jnp.angle(syms * jnp.conj(syms_c)
                                    + jnp.asarray(1e-30, complex_dtype)),
                err=syms_c - ref,       # per-symbol error vs decisions
            )
            return bits, pay, ebn0_db, dbg

        outs = jax.vmap(extract)(
            dets.position, dets.position_frac, dets.gain, dets.theta)
        if debug:
            bits, pays, ebn0s, dbg = outs
        else:
            bits, pays, ebn0s = outs
        frames = FrameRx(bits=bits, symbols=pays, detection=dets,
                         EbN0_db=ebn0s, valid=dets.valid)
        return (frames, dbg) if debug else frames

    def step(self, state, x: jax.Array):
        new_state, dets, buf, _ = self._front(state, x)
        frames = self._extract_all(buf, dets)
        return new_state, frames

    def step_debug(self, state, x: jax.Array):
        """``step`` + named per-stage intermediate signals (parity: the
        reference's debug_actif observability — recepteur.cc:144-150,
        589-618, 726-757 and the demod debug arrays, demod-dec.cc:
        347-371).  Returns (state, frames, debug) where ``debug`` holds
        the block's normalized correlation score and, for the FIRST
        valid detection of the block, every extraction stage (raw /
        corrected / interpolated / matched-filtered / symbols / PLL
        trajectory).  Render with viz.debug.debug_report."""
        new_state, dets, buf, score = self._front(state, x)
        frames, dbg = self._extract_all(buf, dets, debug=True)
        i = jnp.argmax(dets.valid)
        dbg1 = jax.tree_util.tree_map(lambda a: a[i], dbg)
        dbg1["corr_score"] = score
        # no valid detection in the block -> slot 0's captures are the
        # extraction of a clipped buffer-start slice (meaningless);
        # consumers (viz.debug.debug_report) must check this flag
        dbg1["has_detection"] = dets.valid[i]
        return new_state, frames, dbg1

    def step_jit(self, state, x: jax.Array):
        """`step` through a module-level jit cache: host-driven streaming
        loops pay one trace/compile per block SHAPE, then run compiled
        (the receiver is a pytree, so the cache is shared across receiver
        instances of the same structure)."""
        return _STEP_JIT(self, state, x)

    def receive(self, x: jax.Array) -> FrameRx:
        """One-shot receive over a buffer.  Pads with enough zeros past
        the end that every detection is complete within the single step
        (no pending left behind)."""
        from ..block import pad_to_multiple, safe_pad
        extra = max(self.frame_len, 2 * self.det.M) + 2 * self.itp.K
        xp = pad_to_multiple(safe_pad(x, 0, extra, axis=0),
                             self.det.Ne, axis=0)
        _, frames = self.step(self.init(), xp)
        return frames


# module-level jit of Receiver.step with the receiver as a pytree argument
# (closure capture would embed device constants — see Receiver.create note)
_STEP_JIT = jax.jit(lambda rx, state, x: Receiver.step(rx, state, x))
_INIT_JIT = jax.jit(lambda rx: Receiver.init(rx))
# plane <-> complex converters at the device boundary (see config.to_ri)
_PLANES_IN = jax.jit(lambda p: (p[0] + 1j * p[1]).astype(jnp.complex64))
# pack a whole pytree into ONE f32 vector for the device->host hop:
# complex leaves as re/im planes, everything else cast to f32 (exact for
# int8 bits / int32 positions / bools) — one transfer per block instead
# of one per leaf
_PACK = jax.jit(lambda ls: jnp.concatenate(
    [(jnp.stack([jnp.real(l), jnp.imag(l)]).reshape(-1).astype(jnp.float32)
      if jnp.iscomplexobj(l) else
      l.astype(jnp.float32).reshape(-1)) for l in ls]))


def _pull_tree(tree):
    """Move a device pytree to host numpy with one packed f32 transfer,
    restoring leaf shapes/dtypes."""
    leaves, tdef = jax.tree_util.tree_flatten(tree)
    buf = np.asarray(_PACK(tuple(leaves)))
    host, off = [], 0
    for l in leaves:
        shp = tuple(l.shape)
        sz = int(np.prod(shp, dtype=np.int64)) if shp else 1
        if jnp.iscomplexobj(l):
            p = buf[off: off + 2 * sz].reshape((2,) + shp)
            host.append((p[0] + 1j * p[1]).astype(np.complex64))
            off += 2 * sz
        else:
            host.append(buf[off: off + sz].reshape(shp)
                        .astype(np.dtype(l.dtype)))
            off += sz
    return jax.tree_util.tree_unflatten(tdef, host)


class StreamReceiver:
    """Any-push-size streaming front around :class:`Receiver` (parity:
    the reference receiver's internal re-blocking, recepteur.cc:404-650
    via tampon_création, tsd.cc:303-386).

    The jitted per-block step needs static block shapes and the
    detector's OLA granularity (a multiple of ``det.Ne``); this wrapper
    owns that constraint so callers can ``push()`` chunks of ANY size.
    Internally a native ring buffer re-blocks to ``block_len`` and each
    full block runs through the jit-cached ``Receiver.step_jit``.

    Frames are delivered to the callback (host pytrees, one per valid
    slot) and counted; ``flush()`` pads the residue with zeros to emit
    trailing detections."""

    def __init__(self, rx: Receiver, block_len: int = 0, callback=None,
                 monitor: bool = False):
        from ..io.streamio import Rebuffer
        ne = rx.det.Ne
        if block_len <= 0:
            block_len = max(4096, rx.frame_len + 2 * rx.itp.K + ne)
        # round up to detector granularity AND the receiver's minimum
        nmin = rx.frame_len + 2 * rx.itp.K
        block_len = max(block_len, nmin)
        block_len = ((block_len + ne - 1) // ne) * ne
        self.rx = rx
        self.block_len = block_len
        self.callback = callback
        # init under jit: eager ops are unimplemented on some runtimes
        self.state = _INIT_JIT(rx)
        self.frames = []
        self.nframes = 0
        # monitor=True steps through a MonitoredReceiver: the detection
        # front end and the frame extraction run as separate jitted calls
        # with per-stage wall-clock scopes (parity: RécepteurImpl
        # moniteurs(), recepteur.cc:83-110) — slightly slower than the
        # fused step_jit, so off by default
        self._driver = MonitoredReceiver(rx) if monitor else None
        self._rb = Rebuffer(block_len, self._on_block, complex_iq=True)

    def moniteurs(self):
        """Per-stage monitor stats (requires monitor=True)."""
        if self._driver is None:
            return {}
        return self._driver.moniteurs()

    def _on_block(self, blk):
        # all device crossings as re/im planes (config.to_ri); per-slot
        # slicing happens on the host copy, not as eager device ops
        xd = _PLANES_IN(jnp.asarray(
            np.stack([blk.real.astype(np.float32),
                      blk.imag.astype(np.float32)])))
        if self._driver is not None:
            self.state, frames = self._driver.step(self.state, xd)
        else:
            self.state, frames = self.rx.step_jit(self.state, xd)
        # pull the whole FrameRx to host in ONE packed transfer, then
        # slice per valid slot in numpy
        frames_h = _pull_tree(frames)
        valid = frames_h.valid
        for i in np.nonzero(valid)[0]:
            fr = jax.tree_util.tree_map(lambda a, i=i: a[i], frames_h)
            self.nframes += 1
            if self.callback is not None:
                self.callback(fr)
            else:
                self.frames.append(fr)

    def push(self, x):
        """Accept any number of samples; runs zero or more jitted block
        steps."""
        self._rb.push(np.asarray(x))

    def flush(self):
        """Zero-pad so any frame still inside the buffered residue (or
        deferred at a block edge) is extracted."""
        pad = self.block_len + self.rx.frame_len + 2 * self.rx.itp.K
        self._rb.push(np.zeros(pad, np.complex64))

    # ------------------------------------------------- checkpoint/resume
    def checkpoint(self, path: str) -> None:
        """Serialize the FULL mid-stream frame-RX serving state to
        ``path`` (.npz, shared protocol:
        utils.checkpoint.save_stream_state): the receiver's device state
        pytree (detector OLA tail, deferred block-edge detections,
        extraction history buffer), the host ring residue, and the frame
        counter.  Resuming with :meth:`restore` continues bit-identically
        to the uninterrupted run (tests/test_serving.py) — the reference
        cannot checkpoint at all: its receiver state is hidden inside C++
        objects (recepteur.cc; SURVEY §5.4)."""
        from ..utils.checkpoint import save_stream_state
        save_stream_state(path, self.state, self._rb.snapshot(),
                          {"nframes": self.nframes})

    def restore(self, path: str) -> None:
        """Load a :meth:`checkpoint` into this StreamReceiver (same
        Receiver config + block_len).  The state is validated against the
        receiver's state structure (treedef + leaf shapes) and complex
        leaves are re-assembled on device inside jit; the ring residue is
        re-queued so the next push continues exactly where the
        checkpointed stream stopped."""
        from ..io.streamio import Rebuffer
        from ..utils.checkpoint import load_stream_state
        state, residue, ctr = load_stream_state(path, self.state)
        self.state = state
        self._rb = Rebuffer(self.block_len, self._on_block, complex_iq=True)
        if len(residue):
            self._rb.push(residue)
        self.nframes = ctr["nframes"]
        self.frames = []


class MonitoredReceiver:
    """Host-side step driver with per-stage CPU monitors.

    Parity: RécepteurImpl::moniteurs() (recepteur.cc:83-110,
    telecom.hpp:1291) — scopes "recepteur/ola" (detection front end),
    "recepteur/demod" (frame extraction + demod), "recepteur/misc".
    The stages run as separate jitted calls with block_until_ready so the
    wall-clock split is honest; use the plain `Receiver.step` when you
    want the whole receiver fused into one XLA program instead.
    """

    def __init__(self, rx: Receiver):
        from ..utils.monitor import Monitors
        self.rx = rx
        self.monitors = Monitors()
        self._front = jax.jit(type(rx)._front)
        self._extract = jax.jit(type(rx)._extract_all)

    def init(self):
        return self.rx.init()

    def step(self, state, x: jax.Array):
        m = self.monitors["recepteur/ola"]
        m.start()
        new_state, dets, buf, _ = self._front(self.rx, state, x)
        jax.block_until_ready(dets.position)
        m.stop(samples=int(x.shape[-1]))

        m = self.monitors["recepteur/demod"]
        m.start()
        frames = self._extract(self.rx, buf, dets)
        jax.block_until_ready(frames.bits)
        m.stop(samples=int(x.shape[-1]))
        return new_state, frames

    def receive(self, x: jax.Array) -> FrameRx:
        m = self.monitors["recepteur/misc"]
        m.start()
        from ..block import pad_to_multiple, safe_pad
        extra = (max(self.rx.frame_len, 2 * self.rx.det.M)
                 + 2 * self.rx.itp.K)
        xp = pad_to_multiple(safe_pad(x, 0, extra, axis=0),
                             self.rx.det.Ne, axis=0)
        state = self.init()
        m.stop(samples=0)
        _, frames = self.step(state, xp)
        return frames

    def moniteurs(self):
        """Per-stage stats (parity: MoniteursStats, telecom.hpp:1291)."""
        return self.monitors.stats()
