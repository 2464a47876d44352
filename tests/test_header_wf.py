"""Distinct header waveform (fo_entete) — robust-header frames.

Parity: TrameFormat::fo_entete (telecom.hpp:1214), emitter path
emetteur.cc:80-95 (one shared shaping filter, symbol mapper swapped),
receiver header handling recepteur.cc:186-193,229-231,470-477.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.models import waveform as WF
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.models.detector import DetectorConfig
from libtsd_jax.models.frame import FrameFormat, Receiver, Transmitter
from libtsd_jax.models.modulator import ModConfig
from libtsd_jax.ops.fft import delay_signal


def _fmt(pay_wf, hdr_wf, npay=512):
    hdr = np.asarray(randbits(jax.random.PRNGKey(7), 64))
    return FrameFormat(
        modulation=ModConfig(wf=pay_wf, fe=4.0, fsymb=1.0),
        header_bits=tuple(int(b) for b in hdr),
        payload_bits=npay, header_wf=hdr_wf)


@pytest.mark.parametrize("payname", ["qam16", "psk8"])
def test_bpsk_header_loopback(payname):
    """BPSK sync header in front of a dense payload constellation:
    detect, correct and decode with zero errors under gain/phase/frac
    delay + light noise."""
    ps = WF.PulseShape.rcs(0.25)
    pay_wf = (WF.wf_qam(16, ps) if payname == "qam16"
              else WF.wf_psk(8, ps))
    npay = 512 if payname == "qam16" else 513
    fmt = _fmt(pay_wf, WF.wf_bpsk(ps), npay)
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(1), npay)
    frame = np.asarray(tx.transmit(payload))
    x = np.zeros(6144, np.complex64)
    x[700:700 + len(frame)] += (0.9 * np.exp(1j * 0.35) * frame
                                ).astype(np.complex64)
    x = np.asarray(delay_signal(jnp.asarray(x), 0.3))
    rng = np.random.default_rng(5)
    x = x + 0.01 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x))).astype(np.complex64)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    fr = rx.receive(jnp.asarray(x))
    v = np.asarray(fr.valid)
    assert v.any(), "no detection"
    i = int(np.argmax(v))
    errs = int((np.asarray(fr.bits[i]) != np.asarray(payload)).sum())
    assert errs == 0, errs


def test_header_wf_frame_structure():
    """A 64-bit BPSK header occupies 64 symbols (vs 16 with the QAM-16
    payload waveform), and the frame equals header symbols + payload
    symbols pushed through ONE shared shaping filter with no state reset
    in between (the emitter's def_forme_onde semantics)."""
    ps = WF.PulseShape.rcs(0.25)
    pay_wf = WF.wf_qam(16, ps)
    fmt_h = _fmt(pay_wf, WF.wf_bpsk(ps))
    payload = randbits(jax.random.PRNGKey(2), 512)
    w_h = np.asarray(Transmitter.create(fmt_h).transmit(payload))
    from libtsd_jax.models.modulator import Modulator
    mod = Modulator.create(fmt_h.modulation)
    hdr_syms = WF.wf_bpsk(ps).make_symbols(
        jnp.asarray(fmt_h.header_bits, jnp.int8))
    pay_syms = pay_wf.make_symbols(jnp.asarray(np.asarray(payload),
                                               jnp.int8))
    st = mod.init()
    st, y1 = mod.step_symbols(st, jnp.concatenate([hdr_syms, pay_syms]))
    _, y2 = mod.flush(st)
    ref = np.asarray(jnp.concatenate([y1, y2]))
    assert np.allclose(w_h, ref, atol=1e-6)


def test_rotating_payload_rejected():
    ps = WF.PulseShape.rcs(0.25)
    fmt = _fmt(WF.wf_pi4_qpsk(ps), WF.wf_bpsk(ps), 512)
    with pytest.raises(ValueError):
        Transmitter.create(fmt)
    with pytest.raises(ValueError):
        Receiver.create(fmt)
