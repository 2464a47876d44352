"""End-to-end serving loop: IqFileReader -> StreamRunner/StreamReceiver ->
frame Receiver, with per-stage monitors and mid-stream checkpoint/resume.

Validates bit-identical continuation through the
FULL frame-RX state (detector OLA tail, deferred block-edge detections,
extraction history), not just filter states.  Parity context: the
reference's serving loop is recepteur.cc:404-650 driven by tampon_création
(tsd.cc:303-386) with per-stage moniteurs (recepteur.cc:83-110); it has no
checkpointing at all (SURVEY §5.4 improvement slot).
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.io import IqFileReader, StreamRunner, cs16_to_cf32
from libtsd_jax.io.streamio import RingBuffer
from libtsd_jax.models import waveform as WF
from libtsd_jax.models import ber as BER
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.models.modulator import ModConfig
from libtsd_jax.models.detector import DetectorConfig
from libtsd_jax.models.frame import (FrameFormat, Receiver, StreamReceiver,
                                     Transmitter)

NFRAMES = 6
PAYLOAD = 256


@pytest.fixture(scope="module")
def serving_setup(tmp_path_factory):
    """A cs16 capture of NFRAMES QPSK frames at irregular offsets with
    gain/phase impairment + light noise, plus the matching Receiver."""
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    mc = ModConfig(wf=wf, fe=4.0, fsymb=1.0)
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=mc,
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=PAYLOAD)
    tx = Transmitter.create(fmt)
    rng = np.random.default_rng(7)
    payloads = [randbits(jax.random.PRNGKey(100 + i), PAYLOAD)
                for i in range(NFRAMES)]
    frames = [np.asarray(tx.transmit(p)) for p in payloads]
    flen = frames[0].shape[0]
    # irregular gaps, not aligned to any block size
    gaps = rng.integers(900, 2300, NFRAMES)
    n = int(np.sum(gaps) + NFRAMES * flen + 3000)
    x = np.zeros(n, np.complex64)
    pos = 0
    for g, fr in zip(gaps, frames):
        pos += int(g)
        x[pos:pos + flen] += (1.6 * np.exp(1j * 0.8) * fr).astype(
            np.complex64)
        pos += flen
    x += (0.02 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    # write as interleaved cs16 (SDR capture format)
    raw = np.empty((n, 2), np.int16)
    scale = 8192.0
    raw[:, 0] = np.clip(x.real * scale, -32768, 32767)
    raw[:, 1] = np.clip(x.imag * scale, -32768, 32767)
    path = str(tmp_path_factory.mktemp("serving") / "capture.cs16")
    raw.tofile(path)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    return path, rx, payloads, n


def _valid_frames(frames_list):
    """Flatten per-block FrameRx pytrees into per-frame host pytrees."""
    out = []
    for fr in frames_list:
        v = np.asarray(fr.valid)
        for i in np.nonzero(v)[0]:
            out.append(jax.tree.map(lambda a, i=i: np.asarray(a[i]), fr))
    return out


def _block_len_for(rx):
    ne = rx.det.Ne
    nmin = rx.frame_len + 2 * rx.itp.K
    bl = max(4096, nmin)
    return ((bl + ne - 1) // ne) * ne


def test_ring_snapshot_preserves_content():
    rb = RingBuffer(1 << 12, complex_iq=True)
    x = (np.arange(100) + 1j * np.arange(100)[::-1]).astype(np.complex64)
    rb.push(x)
    snap = rb.snapshot()
    assert np.array_equal(snap, x)
    # non-destructive: content still poppable in order afterwards
    assert np.array_equal(rb.pop_block(100), x)


def test_serving_loop_stream_runner(serving_setup):
    """IqFileReader -> StreamRunner(Receiver) end-to-end: every frame
    decoded with zero bit errors; runner monitor recorded the stream."""
    path, rx, payloads, n = serving_setup
    bl = _block_len_for(rx)
    got = []
    runner = StreamRunner(rx, block_len=bl, sink=got.append,
                          complex_in=True, depth=2)
    with IqFileReader(path, "cs16", block_iq=10000) as rd:
        runner.run(cs16_to_cf32(b) for b in rd)
    # flush: zero-pad so trailing/deferred detections are emitted
    runner.push(np.zeros(bl + runner.residual, np.complex64))
    runner.drain()
    frames = _valid_frames(got)
    assert len(frames) == NFRAMES, len(frames)
    for fr, p in zip(frames, payloads):
        _, errs, _ = BER.cmp_bits(np.asarray(p), fr["bits"]
                                  if isinstance(fr, dict) else fr.bits, 4)
        assert errs == 0
    # run() recorded the streamed blocks (the post-run flush pad is not
    # counted — it happens outside the monitored scope)
    st = runner.monitor.stats
    assert st.samples >= n - bl and st.total_s > 0


def test_checkpoint_resume_bit_identical_stream_runner(serving_setup):
    """Mid-stream checkpoint/restore through StreamRunner: the resumed
    run's frames are BIT-identical to the uninterrupted run (bits,
    symbols, detections, Eb/N0 words)."""
    path, rx, payloads, n = serving_setup
    bl = _block_len_for(rx)
    raw = np.fromfile(path, np.int16).reshape(-1, 2)
    x = cs16_to_cf32(raw)
    tail_pad = np.zeros(bl * 2, np.complex64)

    # uninterrupted reference run
    ref_out = []
    r0 = StreamRunner(rx, block_len=bl, sink=ref_out.append)
    r0.push(x)
    r0.push(tail_pad)
    r0.drain()
    ref = _valid_frames(ref_out)
    assert len(ref) == NFRAMES

    # interrupted at an arbitrary, non-block-aligned point
    cut = (len(x) * 2) // 5 + 137
    out_a = []
    r1 = StreamRunner(rx, block_len=bl, sink=out_a.append)
    r1.push(x[:cut])
    ck = os.path.join(os.path.dirname(path), "serving_ckpt.npz")
    r1.checkpoint(ck)

    # resume in a FRESH runner (new process equivalent)
    out_b = []
    r2 = StreamRunner(rx, block_len=bl, sink=out_b.append)
    r2.restore(ck)
    r2.push(x[cut:])
    r2.push(tail_pad)
    r2.drain()

    res = _valid_frames(out_a) + _valid_frames(out_b)
    assert len(res) == len(ref)
    for a, b in zip(ref, res):
        ja, jb = jax.tree.flatten(a)[0], jax.tree.flatten(b)[0]
        for la, lb in zip(ja, jb):
            assert la.dtype == lb.dtype
            assert np.array_equal(la, lb), (la, lb)  # bitwise


def test_checkpoint_structure_mismatch_rejected(serving_setup, tmp_path):
    """A checkpoint restored into a differently configured receiver must
    be rejected structurally, not silently mis-assigned."""
    path, rx, payloads, n = serving_setup
    bl = _block_len_for(rx)
    r1 = StreamRunner(rx, block_len=bl, sink=lambda y: None)
    raw = np.fromfile(path, np.int16).reshape(-1, 2)
    r1.push(cs16_to_cf32(raw)[:2 * bl])
    ck = str(tmp_path / "ck.npz")
    r1.checkpoint(ck)
    # a receiver with a different frame format has differently shaped
    # state buffers (hist/extraction windows) — restore must reject it
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    mc = ModConfig(wf=wf, fe=4.0, fsymb=1.0)
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt2 = FrameFormat(modulation=mc,
                       header_bits=tuple(int(b) for b in hdr),
                       payload_bits=64)
    rx2 = Receiver.create(fmt2, DetectorConfig(threshold=0.5))
    other = StreamRunner(rx2, block_len=bl, sink=lambda y: None)
    with pytest.raises((ValueError, AssertionError)):
        other.restore(ck)


def test_stream_receiver_checkpoint_and_monitors(serving_setup, tmp_path):
    """Same cut through StreamReceiver (the any-push-size serving
    wrapper) with per-stage monitors on: frames bit-identical across the
    checkpoint, and the ola/demod stage monitors saw every block."""
    path, rx, payloads, n = serving_setup
    raw = np.fromfile(path, np.int16).reshape(-1, 2)
    x = cs16_to_cf32(raw)

    # monitored reference run: the per-stage driver runs front/extract as
    # two separate jits, whose fusions round differently from the fused
    # step_jit — bit-identity is asserted like-for-like
    ref_rx = StreamReceiver(rx, monitor=True)
    ref_rx.push(x)
    ref_rx.flush()
    assert ref_rx.nframes == NFRAMES

    srx = StreamReceiver(rx, monitor=True)
    cut = len(x) // 3 + 41
    srx.push(x[:cut])
    ck = str(tmp_path / "srx_ckpt.npz")
    srx.checkpoint(ck)
    frames_a = list(srx.frames)

    srx2 = StreamReceiver(rx, monitor=True)
    srx2.restore(ck)
    srx2.push(x[cut:])
    srx2.flush()
    res = frames_a + srx2.frames
    ref = ref_rx.frames
    assert len(res) == len(ref) == NFRAMES
    assert srx2.nframes == NFRAMES     # counter carried across the resume
    for a, b in zip(ref, res):
        for la, lb in zip(jax.tree.flatten(a)[0], jax.tree.flatten(b)[0]):
            assert np.array_equal(np.asarray(la), np.asarray(lb))
    # per-stage monitors (parity: recepteur.cc moniteurs): both stages
    # ran and counted the pushed samples
    stats = srx2.moniteurs()
    assert "recepteur/ola" in stats and "recepteur/demod" in stats
    assert stats["recepteur/ola"].samples > 0
    assert stats["recepteur/demod"].samples > 0


def test_restore_abandons_previous_stream(serving_setup, tmp_path):
    """restore() into a runner that already streamed must clear collected
    and in-flight outputs of the abandoned stream."""
    path, rx, payloads, n = serving_setup
    bl = _block_len_for(rx)
    raw = np.fromfile(path, np.int16).reshape(-1, 2)
    x = cs16_to_cf32(raw)
    r1 = StreamRunner(rx, block_len=bl)          # sink=None: collects
    r1.push(x[:3 * bl])
    ck = str(tmp_path / "ck.npz")
    r1.checkpoint(ck)
    # reuse the SAME runner for an unrelated stream, then abandon it
    r1.push(x[:2 * bl])
    r1.restore(ck)
    r1.push(x[3 * bl:])
    r1.push(np.zeros(2 * bl, np.complex64))
    r1.drain()
    got = r1._out
    res = _valid_frames(got)
    # reference: fresh runner, same cut
    r2 = StreamRunner(rx, block_len=bl)
    r2.restore(ck)
    r2.push(x[3 * bl:])
    r2.push(np.zeros(2 * bl, np.complex64))
    r2.drain()
    ref = _valid_frames(r2._out)
    assert len(res) == len(ref)
    for a, b in zip(ref, res):
        for la, lb in zip(jax.tree.flatten(a)[0], jax.tree.flatten(b)[0]):
            assert np.array_equal(la, lb)


def test_periodogram_cqt_rejects_complex():
    from libtsd_jax.ops import psd as PSD
    x = jnp.ones(4096, jnp.complex64)
    with pytest.raises(ValueError):
        PSD.periodogram_cqt(x, fs=8000.0, fmin=100.0, fmax=2000.0)


def test_stream_receiver_checkpoint_stride8_pll(tmp_path):
    """Checkpoint/restore of the serving configuration (stride-8 grouped
    residual PLL): the resumed stream decodes identically to the
    uninterrupted one."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from libtsd_jax.models import waveform as WF
    from libtsd_jax.models.bitstream import randbits
    from libtsd_jax.models.detector import DetectorConfig
    from libtsd_jax.models.frame import (FrameFormat, Receiver,
                                         StreamReceiver, Transmitter)
    from libtsd_jax.models.modulator import ModConfig
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=128)
    tx = Transmitter.create(fmt)
    rng = np.random.default_rng(0)
    frames_tx = [np.asarray(tx.transmit(randbits(jax.random.PRNGKey(s),
                                                 128))) for s in range(4)]
    sig = []
    for f in frames_tx:
        sig += [np.zeros(900, np.complex64), f.astype(np.complex64)]
    sig.append(np.zeros(4096, np.complex64))
    x = np.concatenate(sig)

    def make():
        rx = Receiver.create(fmt, DetectorConfig(threshold=0.5),
                             pll_stride=8)
        return StreamReceiver(rx)

    # uninterrupted
    a = make()
    a.push(x)
    a.flush()
    ref = [(np.asarray(f.bits), int(f.detection.position))
           for f in a.frames]
    assert len(ref) == 4

    # interrupted mid-stream + resumed from the checkpoint
    b = make()
    cut = len(x) // 2
    b.push(x[:cut])
    ck = str(tmp_path / "fused.npz")
    b.checkpoint(ck)
    c = make()
    c.restore(ck)
    c.push(x[cut:])
    c.flush()
    got = [(np.asarray(f.bits), int(f.detection.position))
           for f in (b.frames + c.frames)]
    assert len(got) == 4
    for (rb, _), (gb, _) in zip(ref, got):
        assert np.array_equal(rb, gb)
