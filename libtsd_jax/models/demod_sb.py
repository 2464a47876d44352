"""Sub-block decision-directed demodulator: ONE gather per S symbols.

The symbol-rate pointer demod (demod_dec2.py), vmapped over channels,
issues two ``dynamic_slice`` interpolation windows per scan step, which
lower to per-channel gathers from device memory: per-step work grows
with the channel count C while the step count stays the same.

This block restructures the loop around a structural fact of integer
oversampling: within a sub-block of S consecutive symbols the read
pointer advances by exactly ``osf`` samples per symbol, so ALL S symbol
centers (and all S Gardner midpoints, for even osf) share ONE fractional
phase tau.  Each scan step therefore does

  * ONE ``dynamic_slice`` of W = (S-1)*osf + K + osf/2 matched-filter
    outputs (the only gather — amortized S-fold),
  * dense static-index framing into (S, K) windows + one tap vector
    ``lut[tau]`` -> S symbols and S midpoints (dense elementwise work
    that scales with C),
  * per-symbol decisions and error terms computed densely, and
  * ONE timing / carrier / AGC loop update per sub-block, with the
    carrier phase ramped inside the sub-block from the loop filter's
    frequency estimate (theta_j = theta + j * mu / S).

Loop dynamics: the loop filters are instantiated at the sub-block update
rate (BL_subblock = S * BL, alpha_subblock = 1-(1-alpha)^S) so the
absolute loop bandwidths match the per-symbol architecture; the timing
correction applies the summed Gardner error once per sub-block.  This is
the standard parallel-receiver decomposition (block-parallel DD loops);
it tracks identically for loop time constants >> S symbols and acquires
slightly slower (corrections are applied S symbols late).

Parity anchor: same loop equations as the reference's DemodGen2
(core/src/telecom/demod-dec.cc:193-625) with RecHorloge's per-sample
interpolation (demod-dec.cc:38-192) replaced by the shared-tau sub-block
formulation.  ``DecisionDemod2`` remains the per-symbol-exact variant.
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
from ..ops.iir_design import lexp_tc_to_coef
from ..ops.resample import Interpolator, make_interpolator
from .carrier_rec import LoopFilter2
from .clock_rec import ted_gardner
from .demod_dec import DecDemodConfig
from .waveform import Waveform, symbol_indices_to_bits

__all__ = ["SBDemodConfig", "DecisionDemodSB"]


@dataclasses.dataclass(frozen=True)
class SBDemodConfig(DecDemodConfig):
    """DecDemodConfig + the sub-block size S (symbols per loop update).

    Pick S well below the loop time constants (tc, 1/BL in symbols);
    the default S=16 with tc=32/BL=0.005 keeps acquisition stable while
    amortizing the per-channel gather 16x.
    """
    S: int = 16
    # sub-block loops integrate S symbols per update: slower per-symbol
    # constants than the demod_dec2 defaults (tc=10, BL=0.01) keep the
    # per-update gain in the stable region
    tc: float = 32.0
    BL: float = 0.005
    # matched-filter matmul tier (ops/filter_rt.Fir precision).  The
    # loops' EVM floor (~0.08) would tolerate any tier; speed, not
    # accuracy, sets this.
    mf_precision: str = "highest"


def _cspline_taps(tau: jax.Array, nph: int) -> jax.Array:
    """Catmull-Rom taps (cspline_coefs, ops/resample.py) evaluated in
    closed form at the LUT-quantized tau — identical values to the LUT
    path, with NO per-channel gather (tau may be any shape; returns
    (..., 4))."""
    t = jnp.round(jnp.clip(tau, 0.0, 1.0) * nph) / nph
    h0 = (1 + 2 * t) * (t - 1) ** 2
    h1 = t * (t - 1) ** 2
    h2 = t * t * (3 - 2 * t)
    h3 = t * t * (t - 1)
    return jnp.stack([-h1 / 2, h0 - h3 / 2, h2 + h1 / 2, h3 / 2],
                     axis=-1).astype(real_dtype)


def _linear_taps(tau: jax.Array, nph: int) -> jax.Array:
    t = jnp.round(jnp.clip(tau, 0.0, 1.0) * nph) / nph
    return jnp.stack([1 - t, t], axis=-1).astype(real_dtype)


def _sinc_taps(tau: jax.Array, nph: int, nc: int = 15,
               fcut: float = 0.5) -> jax.Array:
    """Windowed-sinc taps (make_interpolator('sinc') defaults: 15 taps,
    fc=0.5, tau-shifted Hann) in closed form at the LUT-quantized tau —
    same values as the LUT path to f32 rounding, no per-channel gather
    (parity: sinc_interp_coefs / itrp.cc:24-39)."""
    t = jnp.round(jnp.clip(tau, 0.0, 1.0) * nph) / nph
    i = jnp.arange(nc, dtype=real_dtype)
    k = i[None, :] - nc // 2 - t[..., None]
    px = jnp.pi * (2 * fcut * k)
    s = jnp.where(jnp.abs(px) < 1e-6, 1.0 - px * px / 6.0,
                  jnp.sin(px) / jnp.where(px == 0, 1.0, px))
    h = 2 * fcut * s
    tw = (jnp.linspace(-(nc // 2), (nc - 1) // 2, nc)[None, :]
          - t[..., None]) * (2 * jnp.pi / nc)
    h = h * (0.5 + 0.5 * jnp.cos(tw))          # a + 2b cos, a=.5 b=.25
    ssum = jnp.sum(h, axis=-1, keepdims=True)
    return (h / jnp.where(jnp.abs(ssum) > 1e-12, ssum, 1.0)
            ).astype(real_dtype)


def _lagrange_taps(tau: jax.Array, nph: int, d: int = 3) -> jax.Array:
    """Lagrange taps (make_interpolator('lagrange') default degree 3) in
    closed form (parity: lagrange_coefs / itrp.cc:98-140)."""
    t = jnp.round(jnp.clip(tau, 0.0, 1.0) * nph) / nph + (d - 1.0) / 2
    rows = []
    for i in range(d + 1):
        hh = jnp.ones_like(t)
        for j in range(d + 1):
            if i != j:
                hh = hh * (t - j) / (i - j)
        rows.append(hh)
    return jnp.stack(rows, axis=-1).astype(real_dtype)


_POLY_TAPS = {"cspline": _cspline_taps, "linear": _linear_taps,
              "sinc": _sinc_taps, "lagrange": _lagrange_taps}


class DecisionDemodSB(Block):
    """step(state, x) -> (state, (bits, symbols, valid, bit_valid));
    output length = (len(x) // (osf*S)) * S symbols (static).

    Two execution paths with identical loop math:

    * x (n,): the reference path — per-step ``dynamic_slice`` window.
    * x (C, n): the batched serving path — ZERO per-channel gathers.
      Under vmap the dynamic_slice lowers to an element-rate gather from
      device memory.  Here the block is pre-cut into STATIC
      overlapping frames anchored at the nominal pointer grid
      (t*S*osf), and the per-channel integer offset o = ip - t*S*osf is
      applied by mixing the K interpolator taps into a one-hot vector v
      of length ML+MH+K (v[o+k] = taps[k]) — each symbol is then a dense
      dot frame[j*osf : j*osf+Fv] . v.  All window selection becomes
      elementwise math + small matmuls that scale with C.
      Backward margin ML = S*osf matches the carried-tail depth of the
      1-D path (one full sub-block of bubble lag); forward margin
      MH = 2*osf covers the initial osf/2 offset plus intra-block loop
      corrections; offsets outside [0, ML+MH] are clamped and the
      sub-block flagged invalid (same bounded-drift stance as the tail:
      sustained clock-rate mismatch needs an upstream rate adapter).
    """

    itrp: Interpolator
    mf: Fir
    wf: Waveform
    cfg: SBDemodConfig = struct.field(pytree_node=False)

    @classmethod
    def create(cls, wf: Waveform, cfg: SBDemodConfig) -> "DecisionDemodSB":
        if cfg.osf % 2:
            raise ValueError("DecisionDemodSB requires even osf (the "
                             "Gardner midpoint must share the symbols' "
                             "fractional phase); use DecisionDemod2")
        mf = wf.shaping.matched_filter(0, cfg.osf)
        mf = mf.replace(precision=cfg.mf_precision)
        return cls(itrp=make_interpolator(cfg.itrp), mf=mf, wf=wf, cfg=cfg)

    @property
    def _timing_gain(self) -> float:
        return self.cfg.osf * lexp_tc_to_coef(self.cfg.tc)

    @property
    def _agc_alpha_sb(self) -> float:
        # S per-symbol updates folded into one: 1-(1-a)^S
        return 1.0 - (1.0 - lexp_tc_to_coef(self.cfg.agc_tc)) ** self.cfg.S

    @property
    def _lf(self) -> LoopFilter2:
        # loop bandwidth is per UPDATE; updates run S-fold slower
        return LoopFilter2(self.cfg.BL * self.cfg.S, self.cfg.eta)

    @property
    def T(self) -> int:
        """Carried matched-filter tail: after a not-ready bubble the
        pointer re-enters the next block as low as -(S-1)*osf, and the
        midpoint windows reach K + osf/2 further back."""
        cfg = self.cfg
        return self.itrp.K + cfg.osf // 2 + cfg.S * cfg.osf

    def init(self):
        return dict(
            mf=self.mf.init(),
            lf=self._lf.init(),
            theta=jnp.zeros((), real_dtype),
            gain=jnp.ones((), real_dtype),
            ptr=jnp.asarray(self.cfg.osf / 2.0, real_dtype),
            yprev_ri=jnp.zeros((2,), real_dtype),
            tail=jnp.zeros((self.T,), complex_dtype),
        )

    def init_for(self, x: jax.Array):
        """Batched state for a (..., n) input."""
        b = x.shape[:-1]
        lf0 = self._lf.init()
        return dict(
            mf=self.mf.init_for(x),
            lf=jax.tree_util.tree_map(
                lambda a: jnp.broadcast_to(a, b + a.shape), lf0),
            theta=jnp.zeros(b, real_dtype),
            gain=jnp.ones(b, real_dtype),
            ptr=jnp.full(b, self.cfg.osf / 2.0, real_dtype),
            yprev_ri=jnp.zeros(b + (2,), real_dtype),
            tail=jnp.zeros(b + (self.T,), complex_dtype),
        )

    def step(self, state, x: jax.Array):
        if x.ndim > 2:
            # honor the documented (..., n) contract: flatten the leading
            # batch dims to one channel axis, run batched, unflatten
            b = x.shape[:-1]
            C = int(np.prod(b))
            nb = len(b)
            sf = jax.tree_util.tree_map(
                lambda a: a.reshape((C,) + a.shape[nb:]), state)
            sf, out = self._step_batched(sf, x.reshape(C, x.shape[-1]))
            unflat = lambda a: a.reshape(b + a.shape[1:])
            return (jax.tree_util.tree_map(unflat, sf),
                    jax.tree_util.tree_map(unflat, out))
        if x.ndim == 2:
            return self._step_batched(state, x)
        return self._step_1d(state, x)

    def _step_batched(self, state, x: jax.Array):
        cfg = self.cfg
        osf, S = cfg.osf, cfg.S
        h = osf // 2
        K = self.itrp.K
        nph = self.itrp.nphases
        lf = self._lf
        symbols = self.wf.symbols
        tgain = self._timing_gain
        aga = self._agc_alpha_sb
        C = x.shape[0]
        n = x.shape[-1]
        nsb = n // (osf * S)
        T = self.T
        taps_fn = _POLY_TAPS[cfg.itrp]

        mf_state, z = self.mf.step(state["mf"], x)
        if cfg.agc_active:
            rms_ref = jnp.sqrt(jnp.mean(jnp.abs(symbols) ** 2))
            p = jnp.mean(jnp.abs(z) ** 2, axis=-1, keepdims=True)
            z = z * (rms_ref / jnp.sqrt(p + 1e-20))
        zp = jnp.concatenate([state["tail"], z,
                              jnp.zeros((C, K + osf), z.dtype)], axis=-1)

        ML = S * osf            # backward margin = carried-tail depth
        MH = 2 * osf            # forward margin
        Fv = ML + MH + K        # selection-vector length
        F = Fv + (S - 1) * osf + h   # frame length
        # static frames anchored at the nominal grid: frame t covers zp
        # local coordinates u with zp index fs(t) + u, where window of
        # sym j at offset o starts at u = o + j*osf + h (mid j at
        # u = o + j*osf)
        fs0 = T - ML - (K - 1) - h
        assert fs0 >= 0, (T, ML, K, h)
        # frame t covers zp[..., fs0 + t*S*osf : ... + F].  The frames are
        # materialized up front (~2.2x the signal) and streamed as scan
        # xs rather than sliced from zp at a traced start inside the
        # body.
        frames = jnp.stack(
            [jax.lax.slice_in_dim(zp, fs0 + t * S * osf,
                                  fs0 + t * S * osf + F, axis=-1)
             for t in range(nsb)])                       # (nsb, C, F)
        nominal = jnp.arange(nsb, dtype=real_dtype) * (S * osf)
        u_sel = jnp.arange(Fv)                           # (Fv,)
        k_sel = jnp.arange(K)
        jsym = jnp.arange(S, dtype=real_dtype)
        # static slab index: slab[c, j, u] = frame[c, j*osf + u]
        slab_idx = np.arange(S)[:, None] * osf + np.arange(Fv + h)[None, :]
        slab_idx = jnp.asarray(slab_idx)                 # (S, Fv+h)

        def body(st, xt):
            frame, nom = xt                              # (C, F), scalar
            p = st["ptr"]                                # (C,)
            ready = (p + (S - 1) * osf) < n
            pc = jnp.where(ready, p, nom + osf / 2.0)
            ip = jnp.floor(pc)
            tau = pc - ip
            o_raw = ip - nom + ML                        # (C,)
            o = jnp.clip(o_raw, 0, ML + MH).astype(jnp.int32)
            inrange = (o_raw >= 0) & (o_raw <= ML + MH)
            taps = taps_fn(tau, nph)                     # (C, K)
            # one-hot mix: v[c, u] = taps[c, k] at u == o_c + k
            hot = (u_sel[None, None, :]
                   == (o[:, None, None] + k_sel[None, :, None]))
            v = jnp.sum(taps[:, :, None] * hot, axis=1)  # (C, Fv)
            # slab[c, j, u] = frame[c, j*osf + u] via a static index-array
            # take, which XLA fuses with the einsums below.
            slab = frame[:, slab_idx]                    # (C, S, Fv+h)
            sr, si = jnp.real(slab), jnp.imag(slab)
            ymid_r = jnp.einsum("cju,cu->cj", sr[:, :, :Fv], v)
            ymid_i = jnp.einsum("cju,cu->cj", si[:, :, :Fv], v)
            ysym_r = jnp.einsum("cju,cu->cj", sr[:, :, h:h + Fv], v)
            ysym_i = jnp.einsum("cju,cu->cj", si[:, :, h:h + Fv], v)
            y_raw = (ysym_r + 1j * ysym_i).astype(complex_dtype)
            ymid_raw = (ymid_r + 1j * ymid_i).astype(complex_dtype)
            # carrier phase ramped from the per-update frequency estimate
            mu = st["lf"][1]                             # (C,)
            theta_j = st["theta"][:, None] + jsym[None, :] * (mu[:, None] / S)
            rot = jnp.exp(-1j * theta_j).astype(complex_dtype)
            g = st["gain"][:, None]
            y = y_raw * rot * g                          # (C, S)
            ymid = ymid_raw * rot * g
            d2 = jnp.abs(y[..., None] - symbols) ** 2    # (C, S, M)
            s_idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
            ye = symbols[s_idx]
            yprev = (st["yprev_ri"][:, 0] + 1j * st["yprev_ri"][:, 1]
                     ).astype(complex_dtype)
            yprev_v = jnp.concatenate([yprev[:, None], y[:, :-1]], axis=1)
            e_t = ted_gardner(yprev_v, ymid, y)          # (C, S)
            dec = jnp.clip(tgain * jnp.sum(e_t, axis=1),
                           -osf / 2.0, osf / 2.0)
            e_ph = jnp.where(jnp.abs(y) > 0,
                             jnp.angle(y * jnp.conj(ye)), 0.0)
            lf_state, theta = lf.step(st["lf"], jnp.mean(e_ph, axis=1))
            if not cfg.carrier_active:
                lf_state, theta = st["lf"], st["theta"]
            gain = st["gain"]
            if cfg.agc_active:
                eg = jnp.abs(y) / jnp.maximum(jnp.abs(ye), 1e-9)
                gain = (1 - aga) * gain + aga * jnp.mean(
                    1.0 / jnp.maximum(eg, 1e-9), axis=1)
            upd = ready & inrange
            ptr_adv = p + S * osf - (dec * inrange if cfg.clock_active
                                     else 0.0)
            # recovery: a pointer outside the frame margins can never
            # re-enter on its own (o_raw is invariant under the nominal
            # advance, so the channel would stay invalid FOREVER);
            # re-anchor it to the next sub-block's nominal center so the
            # loops re-acquire, like a cold start
            ptr_adv = jnp.where(inrange, ptr_adv,
                                nom + S * osf + osf / 2.0)
            new = dict(
                lf=jax.tree_util.tree_map(
                    lambda a, b: jnp.where(upd, a, b), lf_state, st["lf"]),
                theta=jnp.where(upd, theta, st["theta"]),
                gain=jnp.where(upd, gain, st["gain"]),
                ptr=jnp.where(ready, ptr_adv, p),
                yprev_ri=jnp.where(
                    upd[:, None],
                    jnp.stack([jnp.real(y[:, -1]), jnp.imag(y[:, -1])],
                              axis=-1),
                    st["yprev_ri"]),
            )
            ok = (ready & inrange)[:, None]
            return new, (jnp.where(ok, y, 0.0 * y),
                         jnp.where(ok, s_idx, 0),
                         jnp.broadcast_to(ok, (C, S)))

        scan_state = {kk: state[kk] for kk in
                      ("lf", "theta", "gain", "ptr", "yprev_ri")}
        carry, (syms, sidx, valid) = jax.lax.scan(
            body, scan_state, (frames, nominal))
        # (nsb, C, S) -> (C, nsb*S)
        syms = jnp.moveaxis(syms, 0, 1).reshape(C, nsb * S)
        sidx = jnp.moveaxis(sidx, 0, 1).reshape(C, nsb * S)
        valid = jnp.moveaxis(valid, 0, 1).reshape(C, nsb * S)
        new_state = dict(carry, mf=mf_state, ptr=carry["ptr"] - n,
                         tail=zp[:, n: n + T])
        k = self.wf.info.k
        bits = symbol_indices_to_bits(sidx.reshape(-1), k).reshape(C, -1)
        bvalid = jnp.repeat(valid, k, axis=-1)
        return new_state, (bits, syms, valid, bvalid)


    def _step_1d(self, state, x: jax.Array):
        cfg = self.cfg
        osf, S = cfg.osf, cfg.S
        h = osf // 2
        K = self.itrp.K
        lut = self.itrp.lut
        nph = self.itrp.nphases
        lf = self._lf
        symbols = self.wf.symbols
        tgain = self._timing_gain
        aga = self._agc_alpha_sb
        n = x.shape[-1]
        nsb = n // (osf * S)
        T = self.T

        mf_state, z = self.mf.step(state["mf"], x)
        if cfg.agc_active:
            rms_ref = jnp.sqrt(jnp.mean(jnp.abs(symbols) ** 2))
            z = z * (rms_ref / jnp.sqrt(jnp.mean(jnp.abs(z) ** 2) + 1e-20))
        # [carried tail | block | guard pad]; z[t] sits at index T + t
        zp = jnp.concatenate([state["tail"], z, jnp.zeros(K + osf, z.dtype)])

        # one window covers every frame in the sub-block:
        #   mid j  = w[j*osf     : j*osf + K]
        #   sym j  = w[j*osf + h : j*osf + h + K]
        W = (S - 1) * osf + K + h
        j = np.arange(S)[:, None] * osf
        k = np.arange(K)[None, :]
        idx_mid = jnp.asarray(j + k)            # (S, K) static indices
        idx_sym = jnp.asarray(j + k + h)
        jsym = jnp.arange(S, dtype=real_dtype)

        def body(st, t):
            p = st["ptr"]
            # the whole sub-block must be inside the arrived samples;
            # otherwise wait for the next block (S-symbol bubble).
            # ALSO guard the other direction: sustained NEGATIVE drift
            # (RX symbol clock faster than fe/osf) walks the pointer
            # below the carried tail, where dynamic_slice would CLAMP
            # and silently interpolate stale samples forever — re-anchor
            # to the nominal grid and flag the sub-block invalid, like
            # the batched path's out-of-range handling
            nom = t.astype(real_dtype) * (S * osf)
            # absolute bound: the carried tail holds S*osf samples of
            # history, so the interpolation slice is exact for
            # p > -(S*osf) and CLAMPS (silently) below it
            inlow = p > -(S * osf) * 1.0
            ready = ((p + (S - 1) * osf) < n) & inlow
            pc = jnp.where(ready, p, jnp.where(inlow, 0.0,
                                               nom + osf / 2.0))
            ip = jnp.floor(pc).astype(jnp.int32)
            tau = pc - ip.astype(real_dtype)
            w = jax.lax.dynamic_slice(zp, (T + ip + 1 - K - h,), (W,))
            taps = lut[jnp.clip(jnp.round(tau * nph).astype(jnp.int32),
                                0, nph)].astype(real_dtype)
            y_raw = jnp.sum(w[idx_sym] * taps, axis=-1)    # (S,)
            ymid_raw = jnp.sum(w[idx_mid] * taps, axis=-1)
            # carrier phase ramped from the loop filter's per-update
            # frequency estimate mu (radians / S symbols)
            mu = st["lf"][1]
            theta_j = st["theta"] + jsym * (mu / S)
            rot = jnp.exp(-1j * theta_j).astype(complex_dtype)
            g = st["gain"]
            y = y_raw * rot * g
            ymid = ymid_raw * rot * g
            # decisions (dense (S, M) distances)
            d2 = jnp.abs(y[:, None] - symbols[None, :]) ** 2
            s_idx = jnp.argmin(d2, axis=-1).astype(jnp.int32)
            ye = symbols[s_idx]
            # Gardner over the sub-block (y_{-1} carried across steps)
            yprev = (st["yprev_ri"][0] + 1j * st["yprev_ri"][1]
                     ).astype(complex_dtype)
            yprev_v = jnp.concatenate([yprev[None], y[:-1]])
            e_t = ted_gardner(yprev_v, ymid, y)
            dec = jnp.clip(tgain * jnp.sum(e_t), -osf / 2.0, osf / 2.0)
            # carrier loop: one update on the mean DD phase error
            e_ph = jnp.where(jnp.abs(y) > 0,
                             jnp.angle(y * jnp.conj(ye)), 0.0)
            lf_state, theta = lf.step(st["lf"], jnp.mean(e_ph))
            if not cfg.carrier_active:
                lf_state, theta = st["lf"], st["theta"]
            # AGC: folded S-symbol update on the mean gain error
            gain = st["gain"]
            if cfg.agc_active:
                eg = jnp.abs(y) / jnp.maximum(jnp.abs(ye), 1e-9)
                gain = (1 - aga) * gain \
                    + aga * jnp.mean(1.0 / jnp.maximum(eg, 1e-9))
            new = dict(
                lf=jax.tree_util.tree_map(
                    lambda a, b: jnp.where(ready, a, b), lf_state,
                    st["lf"]),
                theta=jnp.where(ready, theta, st["theta"]),
                gain=jnp.where(ready, gain, st["gain"]),
                ptr=jnp.where(
                    ready,
                    p + S * osf - (dec if cfg.clock_active else 0.0),
                    # waiting: hold; fell-behind: continue from the
                    # re-anchored nominal pointer
                    jnp.where(inlow, p, pc + S * osf)),
                yprev_ri=jnp.where(
                    ready, jnp.stack([jnp.real(y[-1]), jnp.imag(y[-1])]),
                    st["yprev_ri"]),
            )
            rd = jnp.broadcast_to(ready, (S,))
            return new, (jnp.where(rd, y, 0.0 * y),
                         jnp.where(rd, s_idx, 0), rd)

        scan_state = {kk: state[kk] for kk in
                      ("lf", "theta", "gain", "ptr", "yprev_ri")}
        carry, (syms, sidx, valid) = jax.lax.scan(
            body, scan_state, jnp.arange(nsb))
        syms = syms.reshape(nsb * S)
        sidx = sidx.reshape(nsb * S)
        valid = valid.reshape(nsb * S)
        new_state = dict(carry, mf=mf_state, ptr=carry["ptr"] - n,
                         tail=zp[n: n + T])
        bits = symbol_indices_to_bits(sidx, self.wf.info.k)
        bvalid = jnp.repeat(valid, self.wf.info.k)
        return new_state, (bits, syms, valid, bvalid)
