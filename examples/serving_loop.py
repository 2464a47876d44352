#!/usr/bin/env python
"""Production serving loop: SDR capture -> frames, with monitors and a
mid-stream checkpoint/resume.

The full serving data path end-to-end:

    IqFileReader (native prefetch)  ->  cs16_to_cf32
        ->  StreamRunner(frame Receiver)       # async double-buffered jit
        ->  FrameRx sink (decoded payloads)

plus the two operational features the reference lacks:

* **per-stage monitors** — `StreamReceiver(monitor=True)` steps through
  the MonitoredReceiver driver (detection front end / frame extraction as
  separately timed jitted stages; parity: RécepteurImpl::moniteurs(),
  recepteur.cc:83-110);
* **mid-stream checkpoint/resume** — the run is interrupted at an
  arbitrary sample offset, the FULL frame-RX serving state (detector OLA
  tail, deferred block-edge detections, extraction history, ring residue,
  frame counter) is saved to .npz, restored into a FRESH runner, and the
  continuation is verified BIT-identical to the uninterrupted run.  The
  reference cannot do this: its receiver state is hidden inside C++
  objects (SURVEY §5.4).

Run:
    python examples/serving_loop.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from libtsd_jax.io import IqFileReader, StreamRunner, cs16_to_cf32
from libtsd_jax.models import ber as BER
from libtsd_jax.models import waveform as WF
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.models.detector import DetectorConfig
from libtsd_jax.models.frame import (FrameFormat, Receiver, StreamReceiver,
                                     Transmitter)
from libtsd_jax.models.modulator import ModConfig

NFRAMES = 12
PAYLOAD = 256


def synthesize_capture(fmt, path):
    """NFRAMES QPSK frames at irregular offsets, 1.6x gain, 0.8 rad
    carrier phase, light AWGN — written as an interleaved cs16 capture."""
    tx = Transmitter.create(fmt)
    rng = np.random.default_rng(11)

    # synthesize on the device under one jit, moving the complex frames
    # out as re/im planes
    @jax.jit
    def gen(t):
        ps = jnp.stack([randbits(jax.random.PRNGKey(500 + i), PAYLOAD)
                        for i in range(NFRAMES)])
        fr = jax.vmap(t.transmit)(ps)
        return ps, jnp.stack([jnp.real(fr), jnp.imag(fr)])

    ps, fr_ri = jax.device_get(gen(tx))
    payloads = list(ps)
    frames = list(fr_ri[0] + 1j * fr_ri[1])
    flen = frames[0].shape[0]
    gaps = rng.integers(900, 2600, NFRAMES)
    n = int(np.sum(gaps) + NFRAMES * flen + 4000)
    x = np.zeros(n, np.complex64)
    pos = 0
    for g, fr in zip(gaps, frames):
        pos += int(g)
        x[pos:pos + flen] += (1.6 * np.exp(1j * 0.8) * fr
                              ).astype(np.complex64)
        pos += flen
    x += (0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    raw = np.empty((n, 2), np.int16)
    raw[:, 0] = np.clip(x.real * 8192, -32768, 32767)
    raw[:, 1] = np.clip(x.imag * 8192, -32768, 32767)
    raw.tofile(path)
    return payloads, n


def valid_frames(blocks):
    out = []
    for fr in blocks:
        v = np.asarray(fr.valid)
        for i in np.nonzero(v)[0]:
            out.append(jax.tree.map(lambda a, i=i: np.asarray(a[i]), fr))
    return out


def main():
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    mc = ModConfig(wf=wf, fe=4.0, fsymb=1.0)
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=mc,
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=PAYLOAD)
    path = os.path.join(tempfile.gettempdir(), "serving_capture.cs16")
    payloads, n = synthesize_capture(fmt, path)
    print(f"capture: {path} ({n} IQ samples, {NFRAMES} frames)")

    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    ne = rx.det.Ne
    bl = ((max(4096, rx.frame_len + 2 * rx.itp.K) + ne - 1) // ne) * ne
    tail = np.zeros(bl * 2, np.complex64)

    # ---- 1. the serving loop: file -> runner -> frames ----------------
    got = []
    runner = StreamRunner(rx, block_len=bl, sink=got.append, depth=2)
    with IqFileReader(path, "cs16", block_iq=1 << 14) as rd:
        runner.run(cs16_to_cf32(b) for b in rd)
    runner.push(tail)          # flush trailing/deferred detections
    runner.drain()
    ref = valid_frames(got)
    nerr = sum(int(BER.cmp_bits(np.asarray(p), f.bits, 4)[1])
               for p, f in zip(payloads, ref))
    st = runner.monitor.stats
    print(f"serving loop: {len(ref)}/{NFRAMES} frames, {nerr} bit errors, "
          f"{st.samples / max(st.total_s, 1e-9) / 1e6:.2f} Msamp/s "
          f"(incl. host IO + conversion)")

    # ---- 2. mid-stream checkpoint/resume, bit-identical ---------------
    raw = np.fromfile(path, np.int16).reshape(-1, 2)
    x = cs16_to_cf32(raw)
    cut = len(x) // 2 + 321                 # arbitrary, not block-aligned
    out_a = []
    r1 = StreamRunner(rx, block_len=bl, sink=out_a.append)
    r1.push(x[:cut])
    ck = os.path.join(tempfile.gettempdir(), "serving_ckpt.npz")
    r1.checkpoint(ck)
    print(f"checkpointed at sample {cut} -> {ck} "
          f"({os.path.getsize(ck)} bytes)")

    out_b = []
    r2 = StreamRunner(rx, block_len=bl, sink=out_b.append)   # fresh runner
    r2.restore(ck)
    r2.push(x[cut:])
    r2.push(tail)
    r2.drain()
    res = valid_frames(out_a) + valid_frames(out_b)
    assert len(res) == len(ref), (len(res), len(ref))
    for a, b in zip(ref, res):
        for la, lb in zip(jax.tree.flatten(a)[0], jax.tree.flatten(b)[0]):
            assert np.array_equal(la, lb)
    print(f"resume: {len(res)} frames, BIT-identical to the "
          f"uninterrupted run ✓")

    # ---- 3. per-stage monitors (recepteur.cc moniteurs parity) --------
    # StreamReceiver crosses the device boundary as re/im planes and
    # pulls each block's FrameRx in one packed f32 transfer, so it runs
    # on every runtime including the remote one (no complex64 or small
    # transfers).
    srx = StreamReceiver(rx, monitor=True)
    srx.push(x)
    srx.flush()
    print(f"per-stage monitors ({srx.nframes} frames):")
    for name, s in sorted(srx.moniteurs().items()):
        print(f"  {name:<18} {s.count:>4} calls  {s.total_s:8.4f} s  "
              f"{s.samples_per_s / 1e6:8.2f} Msamp/s")


if __name__ == "__main__":
    from libtsd_jax.platform import enable_compile_cache
    enable_compile_cache()
    main()
