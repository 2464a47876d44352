"""Per-stage debug observability demo: run the flagship receivers with
debug capture enabled and render each stage into an HTML report.

Parity: the reference's debug_actif workflow — intermediate-signal
figures collected into a per-run index.html by the stdo sink
(recepteur.cc:144-150, demod-dec.cc:347-371, stdo.cc:38-130).

Reports land in ./build/report/{frame_rx,demod,fm_stereo}/index.html.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

import jax.numpy as jnp  # noqa: E402

from libtsd_jax.block import pad_to_multiple, safe_pad  # noqa: E402
from libtsd_jax.models.detector import DetectorConfig  # noqa: E402
from libtsd_jax.models.frame import (FrameFormat, Receiver,  # noqa: E402
                                     Transmitter)
from libtsd_jax.models.modulator import ModConfig  # noqa: E402
from libtsd_jax.models.waveform import PulseShape, wf_qpsk  # noqa: E402
from libtsd_jax.ops.fft import delay_signal  # noqa: E402
from libtsd_jax.viz.debug import debug_report  # noqa: E402

OUT = os.path.join(os.path.dirname(__file__), "..", "build", "report")


def frame_rx_report():
    rng = np.random.RandomState(0)
    hdr = tuple(rng.randint(0, 2, 64).tolist())
    fmt = FrameFormat(
        modulation=ModConfig(wf=wf_qpsk(PulseShape.rcs(0.25)),
                             fe=4.0, fsymb=1.0),
        header_bits=hdr, payload_bits=512)
    tx = Transmitter.create(fmt)
    pay = jnp.asarray(rng.randint(0, 2, 512).astype(np.int8))
    frame = np.asarray(tx.transmit(pay))
    x = np.zeros(6144, np.complex64)
    x[900:900 + len(frame)] = 0.8 * np.exp(1j * 0.4) * frame
    x = np.array(delay_signal(jnp.asarray(x), 0.3))
    x += 0.02 * (rng.standard_normal(len(x))
                 + 1j * rng.standard_normal(len(x))).astype(np.complex64)

    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    extra = max(rx.frame_len, 2 * rx.det.M) + 2 * rx.itp.K
    xp = pad_to_multiple(safe_pad(jnp.asarray(x), 0, extra, axis=0),
                         rx.det.Ne, axis=0)
    _, frames, dbg = rx.step_debug(rx.init(), xp)
    dbg = {k: np.asarray(v) for k, v in dbg.items()}
    path = debug_report("frame receiver (QPSK, gain/phase/frac-delay)",
                        dbg, os.path.join(OUT, "frame_rx"))
    nval = int(np.asarray(frames.valid).sum())
    print(f"frame_rx: {nval} frame(s) decoded -> {path}")


def demod_report():
    from libtsd_jax.models.demod import DemodConfig, Demodulator
    from libtsd_jax.models.modulator import Modulator
    rng = np.random.RandomState(1)
    wf = wf_qpsk(PulseShape.rcs(0.25))
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0))
    bits = jnp.asarray(rng.randint(0, 2, 2048).astype(np.int8))
    w, _ = jax.jit(lambda m, b: m.modulate(b))(mod, bits)
    y = w * 1.3 * np.exp(1j * 0.25)
    dm = Demodulator.create(DemodConfig(wf=wf, fe=4.0, fsymb=1.0))
    _, _, dbg = dm.step(dm.init(), y, debug=True)
    dbg = {k: np.asarray(v) for k, v in dbg.items()}
    path = debug_report("non-decision demodulator (QPSK)", dbg,
                        os.path.join(OUT, "demod"))
    print(f"demod: -> {path}")


def fm_report():
    from libtsd_jax.models.analog import (fm_broadcast_debug,
                                          fm_broadcast_multiplex)
    from libtsd_jax.ops.signal import cycles
    fe = 250e3
    n = 1 << 15
    al = 0.8 * jnp.sin(2 * jnp.pi * cycles(1000.0 / fe, n))
    ar = 0.6 * jnp.sin(2 * jnp.pi * cycles(2500.0 / fe, n))
    x = fm_broadcast_multiplex(al, ar, fe)
    L, R, dbg = fm_broadcast_debug(x, fe)
    dbg = {k: np.asarray(v) for k, v in dbg.items()}
    dbg["audio_L"] = np.asarray(L)
    dbg["audio_R"] = np.asarray(R)
    path = debug_report("broadcast FM stereo receiver", dbg,
                        os.path.join(OUT, "fm_stereo"))
    print(f"fm_stereo: -> {path}")


if __name__ == "__main__":
    from libtsd_jax.platform import enable_compile_cache
    enable_compile_cache()
    frame_rx_report()
    demod_report()
    fm_report()
