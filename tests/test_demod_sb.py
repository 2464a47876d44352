"""Sub-block decision-directed demod (models/demod_sb.py): convergence,
1-D vs batched path equivalence, streaming continuity.

Parity anchor: same loop equations as DemodGen2
(core/src/telecom/demod-dec.cc) at sub-block update rate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libtsd_jax.models import ber as BER
from libtsd_jax.models import channel as CH
from libtsd_jax.models import waveform as WF
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.models.demod_sb import DecisionDemodSB, SBDemodConfig
from libtsd_jax.models.modulator import ModConfig, Modulator
from libtsd_jax.ops.fft import delay_signal


def _qpsk_signal(nsym=3000, snr=15.0):
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(40), 2 * nsym)
    x, _ = mod.modulate(bits)
    x = delay_signal(x, 1.7)
    x = x * jnp.exp(2j * jnp.pi * 2e-4 *
                    jnp.arange(x.shape[0])).astype(jnp.complex64)
    x = CH.awgn(jax.random.PRNGKey(41), x, snr, osf=4, k_bits=2)
    n = (x.shape[0] // 64) * 64
    return wf, bits, x[:n]


@pytest.mark.parametrize("S", [8, 16, 32])
def test_subblock_qpsk_converges(S):
    """Combined timing + frequency offset + noise: zero steady-state
    errors at every sub-block size."""
    wf, bits, x = _qpsk_signal()
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=S))
    _, (rb, syms, mask, bmask) = dd.step(dd.init(), x)
    rbn = np.asarray(rb)[np.asarray(bmask)]
    ber, errs, lag = BER.cmp_bits_psk(bits[2 * 800:],
                                      jnp.asarray(rbn[2 * 800:]), 2,
                                      max_lag=64)
    assert errs == 0, (S, ber, errs)


def test_subblock_batched_matches_1d():
    """The gather-free batched path runs the SAME loop math as the 1-D
    dynamic_slice path: per-symbol outputs agree to float32 noise."""
    wf, bits, x = _qpsk_signal(nsym=1500)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16))
    _, (b1, s1, m1, _) = dd.step(dd.init(), x)
    xb = jnp.stack([x, delay_signal(x, 0.9)])
    _, (b2, s2, m2, _) = dd.step(dd.init_for(xb), xb)
    m1n, m2n = np.asarray(m1), np.asarray(m2)
    both = m1n & m2n[0]
    d = np.abs(np.asarray(s1)[both] - np.asarray(s2)[0][both])
    assert d.max() < 1e-4 and d.mean() < 1e-5, (d.max(), d.mean())
    # second channel (different delay) also converges
    rbn = np.asarray(b2[1])[np.asarray(m2[1].repeat(2))]
    ber, errs, _ = BER.cmp_bits_psk(bits[2 * 800:],
                                    jnp.asarray(rbn[2 * 800:]), 2,
                                    max_lag=64)
    assert errs == 0, (ber, errs)


def test_subblock_streaming_matches_oneshot():
    """Block-boundary continuity of the batched path (carried MF tail,
    pointer re-basing, loop state)."""
    wf, bits, x = _qpsk_signal(nsym=1200)
    xb = x[None]
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16))
    _, (b1, s1, m1, _) = dd.step(dd.init_for(xb), xb)
    half = (x.shape[0] // 128) * 64
    st = dd.init_for(xb)
    st, (ba, sa, ma, _) = dd.step(st, xb[:, :half])
    st, (bb, sb, mb, _) = dd.step(st, xb[:, half:])
    one = np.asarray(s1)[0][np.asarray(m1)[0]]
    two = np.concatenate([np.asarray(sa)[0][np.asarray(ma)[0]],
                          np.asarray(sb)[0][np.asarray(mb)[0]]])
    ncmp = min(len(one), len(two))
    assert ncmp >= len(one) - 16    # at most one sub-block deferred
    d = np.abs(one[:ncmp] - two[:ncmp])
    # small residual = float32 pointer re-basing through the feedback
    # loop (same bound as the DecisionDemod2 streaming test)
    assert np.max(d) < 0.06 and np.mean(d) < 5e-3, (d.max(), d.mean())


def test_cmp_bits_rot_resolves_qam_rotation():
    """cmp_bits_rot undoes a 90-degree constellation lock that index
    rotation (cmp_bits_psk) cannot, on Gray-mapped QAM-16."""
    from libtsd_jax.models.waveform import bits_to_symbol_indices
    wf = WF.wf_qam(16, WF.PulseShape.rcs(0.25))
    bits = randbits(jax.random.PRNGKey(7), 4 * 500)
    idx = bits_to_symbol_indices(bits, 4)
    syms = wf.symbols[idx] * jnp.exp(1j * jnp.pi / 2)
    ber, errs, lag = BER.cmp_bits_rot(bits, np.asarray(syms), wf)
    assert errs == 0 and lag == 0, (ber, errs, lag)


def test_subblock_odd_osf_rejected():
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    with pytest.raises(ValueError):
        DecisionDemodSB.create(wf, SBDemodConfig(osf=3, S=16))


def test_subblock_pointer_lockout_recovers():
    """A pointer driven outside the frame margins must re-anchor to the
    nominal grid and re-acquire — without the recovery, o_raw is
    invariant under the nominal advance and the channel stays invalid
    FOREVER (review finding, round 3)."""
    wf, bits, x = _qpsk_signal(nsym=2000)
    xb = x[None]
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16))
    st = dd.init_for(xb)
    # corrupt the pointer far past the forward margin (MH = 2*osf)
    st = dict(st, ptr=st["ptr"] + 40.0)
    st, (rb, syms, mask, bmask) = dd.step(st, xb)
    m = np.asarray(mask)[0]
    assert m.any(), "channel never recovered from an out-of-range pointer"
    # the tail must be converged symbols again (not just marked valid)
    tail = np.asarray(syms)[0][m]
    tail = tail[-400:]
    d2 = np.min(np.abs(tail[:, None] - np.asarray(wf.symbols)) ** 2, axis=1)
    evm = np.sqrt(d2.mean() / np.mean(np.abs(np.asarray(wf.symbols))**2))
    assert evm < 0.25, evm


def test_subblock_ndim3_batch():
    """The documented (..., n) contract: a (B, C, n) input runs through
    the batched path via leading-dim flattening."""
    wf, bits, x = _qpsk_signal(nsym=800)
    xb = jnp.stack([x, delay_signal(x, 0.9)]).reshape(2, 1, -1)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16))
    st, (rb, syms, mask, bmask) = dd.step(dd.init_for(xb), xb)
    assert syms.shape[:2] == (2, 1)
    _, (r1, s1, m1, _) = dd.step(dd.init_for(x[None]), x[None])
    both = np.asarray(mask)[0, 0] & np.asarray(m1)[0]
    d = np.abs(np.asarray(syms)[0, 0][both] - np.asarray(s1)[0][both])
    assert d.max() < 1e-5


def test_subblock_sinc_interpolator_batched():
    """The windowed-sinc interpolator (highest-quality) now has
    closed-form batched taps — the batched path must accept it and
    converge (round-3 raised NotImplementedError)."""
    wf, bits, x = _qpsk_signal(nsym=1500)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  itrp="sinc"))
    xb = jnp.stack([x, delay_signal(x, 0.9)])
    _, (rb, syms, mask, bmask) = dd.step(dd.init_for(xb), xb)
    rbn = np.asarray(rb[0])[np.asarray(bmask[0])]
    ber, errs, _ = BER.cmp_bits_psk(bits[2 * 800:],
                                    jnp.asarray(rbn[2 * 800:]), 2,
                                    max_lag=64)
    assert errs == 0, (ber, errs)


def _qam16_signal(nsym=800, snr=18.0):
    wf = WF.wf_qam(16, WF.PulseShape.rcs(0.25))
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(50), 4 * nsym)
    x, _ = mod.modulate(bits)
    x = delay_signal(x, 1.3)
    x = CH.awgn(jax.random.PRNGKey(51), x, snr, osf=4, k_bits=4)
    n = (x.shape[0] // 64) * 64
    return wf, bits, x[:n]


@pytest.mark.parametrize("C", [0, 4])
def test_subblock_qam16_decisions(C):
    """QAM-16 at 18 dB: zero steady-state decision errors, on the 1-D
    path (C=0) and batched over channels (rotation resolved on the
    symbols, as the blind carrier loop may lock at any quarter turn)."""
    wf, bits, x = _qam16_signal(nsym=1600)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16))
    xin = x if C == 0 else jnp.broadcast_to(x, (C, x.shape[0]))
    _, (b, s, m, bm) = dd.step(dd.init_for(xin), xin)
    s, m = np.asarray(s), np.asarray(m)
    rows = [(s, m)] if C == 0 else [(s[c], m[c]) for c in range(C)]
    for sc, mc in rows:
        sy = sc[mc]
        _, errs, _ = BER.cmp_bits_rot(bits[4 * 600:], sy[600:], wf,
                                      max_lag=64)
        assert errs == 0, errs


@pytest.mark.parametrize("split", [1024, 2048, 3072])
def test_subblock_batched_streaming_continuity(split):
    """Batched path: two blocks split at any sub-block multiple equal
    one block (MF tail, pointer rebase and loop state carried)."""
    wf, bits, x = _qpsk_signal(nsym=1200)
    n = (x.shape[0] // 2048) * 2048
    xb = jnp.stack([x[:n], delay_signal(x[:n], 0.4)])
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16))
    _, (b1, s1, m1, _) = dd.step(dd.init_for(xb), xb)
    st = dd.init_for(xb)
    st, (ba, sa, ma, _) = dd.step(st, xb[:, :split])
    st, (bb, sb, mb, _) = dd.step(st, xb[:, split:])
    for c in range(2):
        one = np.asarray(s1[c])[np.asarray(m1[c])]
        two = np.concatenate([np.asarray(sa[c])[np.asarray(ma[c])],
                              np.asarray(sb[c])[np.asarray(mb[c])]])
        ncmp = min(len(one), len(two))
        assert ncmp >= len(one) - 16    # at most one sub-block deferred
        d = np.abs(one[:ncmp] - two[:ncmp])
        # float32 pointer re-basing through the feedback loop (see
        # test_subblock_streaming_matches_oneshot); a split 1/4 of the way
        # in leaves 3/4 of the run behind the re-based pointer
        assert np.max(d) < 0.06 and np.mean(d) < 1e-2, (d.max(), d.mean())


@pytest.mark.parametrize("batched", [False, True])
def test_subblock_honors_agc_off(batched):
    """agc_active=False leaves the raw MF amplitude untouched."""
    wf, bits, x = _qpsk_signal(nsym=600)
    xin = 3.0 * x[:2048]                        # deliberate 3x gain
    if batched:
        xin = jnp.stack([xin] * 4)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16,
                                                  agc_active=False))
    _, (b, s, m, _) = dd.step(dd.init_for(xin), xin)
    sy = np.asarray(s)[np.asarray(m)]
    rms = np.sqrt(np.mean(np.abs(sy) ** 2))
    assert 2.0 < rms < 4.5, rms


@pytest.mark.parametrize("kind,K", [("cspline", 4), ("linear", 2),
                                    ("lagrange", 4), ("sinc", 15)])
def test_tap_builders_match_lut(kind, K):
    """The closed-form fractional-delay taps of the sub-block demod
    (models/demod_sb._POLY_TAPS) equal ops/resample.py's NumPy LUT
    builders at the LUT-quantized tau."""
    from libtsd_jax.models import demod_sb as MSB
    from libtsd_jax.ops import resample as RS
    nph = 256
    lut_fn = {"cspline": lambda t: RS.cspline_coefs(t),
              "linear": lambda t: RS.linear_coefs(t),
              "lagrange": lambda t: RS.lagrange_coefs(3, t),
              "sinc": lambda t: RS.sinc_interp_coefs(15, 0.5, t)}[kind]
    taus = np.linspace(0.0, 1.0, 29).astype(np.float32)
    got = np.asarray(MSB._POLY_TAPS[kind](jnp.asarray(taus), nph))
    assert got.shape == (len(taus), K)
    for t, row in zip(taus, got):
        tq = round(float(t) * nph) / nph
        ref = np.asarray(lut_fn(tq), np.float32)
        assert np.max(np.abs(row - ref)) < 1e-6, (kind, t)


def test_1d_pointer_underrun_recovers():
    """A pointer driven below the carried-tail depth (sustained negative
    drift) must re-anchor to the nominal grid instead of silently
    interpolating clamped stale samples forever."""
    wf, bits, x = _qpsk_signal(nsym=600)
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16))
    st = dd.init()
    # poison the pointer far below the tail depth (T = K + 2 + 64)
    st["ptr"] = jnp.asarray(-1000.0, jnp.float32)
    st, (b, s, m, _) = dd.step(st, x[:2048])
    # the re-anchored pointer must be back in a sane range...
    p = float(st["ptr"])
    assert -64.0 <= p <= 2048.0, p
    # ...and a followup block must decode normally again
    st, (b2, s2, m2, _) = dd.step(st, x[2048:4096])
    assert float(jnp.mean(m2.astype(jnp.float32))) > 0.9
