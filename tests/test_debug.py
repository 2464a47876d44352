"""Per-stage debug capture (parity: the reference's debug_actif
figures — recepteur.cc:144-150,589-618,726-757, demod-dec.cc:347-371,
rendered through the stdo HTML report, stdo.cc:38-130)."""
import os

import numpy as np
import jax
import jax.numpy as jnp

from libtsd_jax.models.detector import DetectorConfig
from libtsd_jax.models.frame import FrameFormat, Receiver
from libtsd_jax.models.modulator import ModConfig
from libtsd_jax.models.waveform import PulseShape, wf_qpsk

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def _lcg_bits(seed, n):
    s = seed
    out = []
    for _ in range(n):
        s = (s * 1103515245 + 12345) & 0xFFFFFFFF
        out.append((s >> 16) & 1)
    return np.asarray(out, np.uint8)


def _rx():
    hdr = _lcg_bits(0xACE1, 64)
    fmt = FrameFormat(
        modulation=ModConfig(wf=wf_qpsk(PulseShape.rcs(0.25)),
                             fe=4.0, fsymb=1.0),
        header_bits=tuple(int(b) for b in hdr), payload_bits=512)
    return Receiver.create(fmt, DetectorConfig(threshold=0.6))


def test_receiver_step_debug_stages():
    """step_debug returns the same frames as step PLUS every extraction
    stage of the first valid detection, coherent with each other."""
    from libtsd_jax.block import pad_to_multiple, safe_pad
    rx = _rx()
    x = jnp.asarray(np.load(os.path.join(GOLD, "g8_rx1_x.npy")))
    extra = max(rx.frame_len, 2 * rx.det.M) + 2 * rx.itp.K
    xp = pad_to_multiple(safe_pad(x, 0, extra, axis=0), rx.det.Ne, axis=0)
    st, frames, dbg = rx.step_debug(rx.init(), xp)
    _, frames2 = rx.step(rx.init(), xp)
    assert np.array_equal(np.asarray(frames.bits), np.asarray(frames2.bits))
    for key in ("x", "x1", "y", "z", "syms", "syms_c", "pll_phase",
                "err", "corr_score"):
        assert key in dbg, key
    # the captured stages belong to the FIRST valid detection
    i = int(np.argmax(np.asarray(frames.valid)))
    np.testing.assert_allclose(
        np.asarray(dbg["syms_c"])[rx.nsym_header:],
        np.asarray(frames.symbols)[i], rtol=1e-5, atol=1e-6)
    # x1 = x corrected by the detected gain/phase
    g = np.asarray(frames.detection.gain)[i]
    th = np.asarray(frames.detection.theta)[i]
    np.testing.assert_allclose(
        np.asarray(dbg["x1"]),
        np.asarray(dbg["x"]) * np.exp(-1j * th) / max(g, 1e-6),
        rtol=1e-4, atol=1e-5)
    # stage shapes: frame-length time series, symbol-rate trajectories
    assert np.asarray(dbg["y"]).shape[-1] == rx.frame_len
    nsym = rx.nsym_header + rx.nsym_payload
    assert np.asarray(dbg["pll_phase"]).shape[-1] == nsym
    # residual per-symbol error is small on the noise-free golden
    assert float(np.abs(np.asarray(dbg["err"])).mean()) < 0.1


def test_demodulator_debug_stages():
    from libtsd_jax.models.demod import DemodConfig, Demodulator
    x = jnp.asarray(np.load(os.path.join(GOLD, "g8_d_x.npy")))
    dm = Demodulator.create(DemodConfig(wf=wf_qpsk(PulseShape.rcs(0.25)),
                                        fe=4.0, fsymb=1.0))
    st, (bits, syms, mask, bmask), dbg = dm.step(dm.init(), x, debug=True)
    _, (bits2, _, _, _) = dm.step(dm.init(), x)
    assert np.array_equal(np.asarray(bits), np.asarray(bits2))
    for key in ("post_transpo", "post_mf", "clockrec_syms",
                "clockrec_mask", "agc_syms", "pll_syms", "pll_phase"):
        assert key in dbg, key
    assert np.asarray(dbg["post_mf"]).shape == x.shape
    np.testing.assert_allclose(np.asarray(dbg["pll_syms"]),
                               np.asarray(syms), rtol=1e-6)


def test_fm_broadcast_debug_stages():
    from libtsd_jax.models.analog import (fm_broadcast_debug,
                                          fm_broadcast_demodulate,
                                          fm_broadcast_multiplex)
    from libtsd_jax.ops.signal import cycles
    fe = 1.024e6
    n = 1 << 17
    al = 0.3 * jnp.sin(2 * jnp.pi * cycles(440.0 / fe, n))
    ar = 0.3 * jnp.sin(2 * jnp.pi * cycles(1000.0 / fe, n))
    x = fm_broadcast_multiplex(al, ar, fe)
    L, R, dbg = fm_broadcast_debug(x, fe)
    L2, R2 = fm_broadcast_demodulate(x, fe)
    np.testing.assert_allclose(np.asarray(L), np.asarray(L2), atol=1e-6)
    for key in ("mpx", "pilot", "sub38", "lpr", "lmr"):
        assert key in dbg, key
    # the recovered pilot is unit-magnitude analytic
    p = np.asarray(dbg["pilot"])[2048:-2048]
    assert np.abs(np.abs(p) - 1.0).max() < 1e-3


def test_debug_report_renders_html(tmp_path):
    from libtsd_jax.viz.debug import debug_report
    rng = np.random.default_rng(0)
    sig = dict(
        stage_real=rng.standard_normal(256).astype(np.float32),
        stage_syms=(rng.standard_normal(64)
                    + 1j * rng.standard_normal(64)).astype(np.complex64),
        mask=np.ones(32, bool),
    )
    path = debug_report("unit", sig, str(tmp_path / "rep"))
    assert os.path.exists(path)
    html = open(path).read()
    assert "stage_real" in html and "stage_syms" in html
    # constellation figure emitted for the symbols stage
    assert "constellation" in html
