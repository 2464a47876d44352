"""Receiver configuration matrix (parity: test_recepteur,
core/tests/test-telecom.cc:810-929 — the reference sweeps waveform x
shaping x OSF x integer/fractional delay and requires every frame to
decode).  Matrix: the reference's full 8-waveform list (bpsk, qpsk,
pi4-qpsk, 8-psk with a k-aligned sync word, 2-FSK, 4-FSK index 1.0,
QAM-4, QAM-16) plus an NRZ-shaping row, x fractional/integer delay at
OSF 4, plus an OSF 2 spot-check; gain 1.5, carrier phase 0.7 rad,
light noise.  FSK decodes through the receiver's discriminator branch
(frame.py), like the reference's demod routing.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.models import waveform as WF
from libtsd_jax.models import ber as BER
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.models.detector import DetectorConfig
from libtsd_jax.models.frame import FrameFormat, Receiver, Transmitter
from libtsd_jax.models.modulator import ModConfig
from libtsd_jax.ops.fft import delay_signal

# tier-2: long statistical sweep — excluded from the <3-min default loop
pytestmark = pytest.mark.slow

WFS = {
    "bpsk": lambda: WF.wf_bpsk(WF.PulseShape.rcs(0.5)),
    "qpsk": lambda: WF.wf_qpsk(WF.PulseShape.rcs(0.5)),
    "pi4qpsk": lambda: WF.wf_pi4_qpsk(WF.PulseShape.rcs(0.5)),
    "psk8": lambda: WF.wf_psk(8, WF.PulseShape.rcs(0.5)),
    "qam4": lambda: WF.wf_qam(4, WF.PulseShape.rcs(0.5)),
    "qam16": lambda: WF.wf_qam(16, WF.PulseShape.rcs(0.5)),
    "fsk2": lambda: WF.wf_fsk(2, index=1.0, shaping=WF.PulseShape.nrz()),
    "fsk4": lambda: WF.wf_fsk(4, index=1.0, shaping=WF.PulseShape.nrz()),
    "qpsk-nrz": lambda: WF.wf_qpsk(WF.PulseShape.nrz()),
}


def _run(wf, osf, frac):
    k = wf.info.k
    nh = 66 if k == 3 else 64          # sync word k-aligned (8-PSK: 22 sym)
    npay = (128 // k) * k or k
    mc = ModConfig(wf=wf, fe=float(osf), fsymb=1.0)
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), nh))
    fmt = FrameFormat(modulation=mc,
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=npay)
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(1), npay)
    frame = np.asarray(tx.transmit(payload))
    n = 4096
    x = np.zeros(n, np.complex64)
    x[700:700 + len(frame)] += (1.5 * np.exp(1j * 0.7) * frame
                                ).astype(np.complex64)
    if frac:
        x = np.asarray(delay_signal(jnp.asarray(x), 0.4))
    rng = np.random.default_rng(3)
    x = x + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                    ).astype(np.complex64)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    fr = rx.receive(jnp.asarray(x))
    v = np.asarray(fr.valid)
    assert v.any(), "no detection"
    i = int(np.argmax(v))
    _, errs, _ = BER.cmp_bits(np.asarray(payload),
                              np.asarray(fr.bits[i]), 8)
    assert errs == 0, errs


@pytest.mark.parametrize("name", sorted(WFS))
@pytest.mark.parametrize("frac", [False, True])
def test_receiver_matrix_osf4(name, frac):
    _run(WFS[name](), 4, frac)


@pytest.mark.parametrize("frac", [False, True])
def test_receiver_matrix_osf2(frac):
    _run(WFS["qpsk"](), 2, frac)


def test_unaligned_header_rejected():
    """64 header bits with k=3 would silently shift every symbol; the
    receiver must reject the format instead."""
    wf = WF.wf_psk(8, WF.PulseShape.rcs(0.5))
    mc = ModConfig(wf=wf, fe=4.0, fsymb=1.0)
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=mc,
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=129)
    with pytest.raises(ValueError):
        Receiver.create(fmt, DetectorConfig(threshold=0.5))


@pytest.mark.parametrize("frac", [False, True])
def test_receiver_matrix_stride8_pll(frac):
    """The serving configuration (stride-8 grouped PLL) through the
    statistical matrix row: identical gates to the default stride."""
    wf = WFS["qpsk"]()
    k = wf.info.k
    mc = ModConfig(wf=wf, fe=4.0, fsymb=1.0)
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=mc,
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=128)
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(1), 128)
    frame = np.asarray(tx.transmit(payload))
    n = 4096
    x = np.zeros(n, np.complex64)
    x[700:700 + len(frame)] += (1.5 * np.exp(1j * 0.7) * frame
                                ).astype(np.complex64)
    if frac:
        x = np.asarray(delay_signal(jnp.asarray(x), 0.4))
    rng = np.random.default_rng(3)
    x = x + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                    ).astype(np.complex64)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5),
                         pll_stride=8)
    fr = rx.receive(jnp.asarray(x))
    v = np.asarray(fr.valid)
    assert v.any(), "no detection"
    i = int(np.argmax(v))
    _, errs, _ = BER.cmp_bits(np.asarray(payload),
                              np.asarray(fr.bits[i]), 8)
    assert errs == 0, errs
