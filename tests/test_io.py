"""Native streaming IO engine tests (ring buffer, re-blocker, converters)."""
import numpy as np
import pytest

from libtsd_jax.io import (RingBuffer, Rebuffer, cs16_to_cf32, cu8_to_cf32,
                           deinterleave, interleave, native_available)


def test_native_builds():
    # the native library must build in this environment (g++ is baked in)
    assert native_available()


def test_ring_buffer_complex():
    rb = RingBuffer(1024, complex_iq=True)
    x = (np.arange(100) + 1j * np.arange(100)).astype(np.complex64)
    assert rb.push(x) == 100
    assert rb.available == 100
    blk = rb.pop_block(60)
    assert np.array_equal(blk, x[:60])
    assert rb.pop_block(60) is None  # only 40 left
    assert rb.push(x) == 100
    blk2 = rb.pop_block(140)
    assert np.array_equal(blk2, np.concatenate([x[60:], x]))


def test_ring_buffer_wraparound():
    rb = RingBuffer(128, complex_iq=False)
    total_in = []
    total_out = []
    rng = np.random.default_rng(0)
    for i in range(50):
        x = rng.standard_normal(rng.integers(1, 40)).astype(np.float32)
        acc = rb.push(x)
        total_in.append(x[:acc])
        while True:
            b = rb.pop_block(16)
            if b is None:
                break
            total_out.append(b)
    got = np.concatenate(total_out)
    want = np.concatenate(total_in)[: len(got)]
    assert np.array_equal(got, want)


def test_ring_buffer_full():
    rb = RingBuffer(32, complex_iq=False)
    x = np.ones(64, np.float32)
    assert rb.push(x) == 32  # clipped to capacity
    assert rb.available == 32


def test_rebuffer_callback():
    """Parity semantics with tampon_création: arbitrary pushes -> fixed-N
    callbacks."""
    blocks = []
    rb = Rebuffer(50, lambda b: blocks.append(b), complex_iq=False)
    rng = np.random.default_rng(1)
    data = rng.standard_normal(500).astype(np.float32)
    i = 0
    while i < 500:
        n = int(rng.integers(1, 97))
        rb.push(data[i:i + n])
        i += n
    got = np.concatenate(blocks)
    assert all(len(b) == 50 for b in blocks)
    assert np.array_equal(got, data[: len(got)])
    assert len(got) >= 450


def test_cs16_converter():
    raw = np.array([0, 16384, -32768, 32767], np.int16)  # 2 IQ samples
    z = cs16_to_cf32(raw)
    assert z.dtype == np.complex64
    assert abs(z[0] - (0 + 0.5j)) < 1e-6
    assert abs(z[1] - (-1.0 + 32767 / 32768 * 1j)) < 1e-6


def test_cu8_converter():
    raw = np.array([127, 128, 0, 255], np.uint8)
    z = cu8_to_cf32(raw)
    assert abs(z[0].real - (-0.5 / 127.5)) < 1e-6
    assert abs(z[1].real - (-1.0)) < 1e-6
    assert abs(z[1].imag - 1.0) < 1e-6


def test_interleave_roundtrip():
    rng = np.random.default_rng(2)
    z = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
         ).astype(np.complex64)
    planes = deinterleave(z)
    assert planes.shape == (2, 1000)
    z2 = interleave(planes)
    assert np.array_equal(z, z2)


@pytest.mark.skipif(not native_available(), reason="native lib unavailable")
def test_native_faster_than_numpy_on_big_convert():
    import time
    n = 1 << 22
    raw = np.random.default_rng(3).integers(-32768, 32767, 2 * n
                                            ).astype(np.int16)
    t0 = time.perf_counter()
    z1 = cs16_to_cf32(raw)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    f = raw.astype(np.float32) / 32768.0
    z2 = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
    t_numpy = time.perf_counter() - t0
    assert np.allclose(z1, z2)
    # native should not be slower (usually 2-6x faster)
    assert t_native < t_numpy * 1.5, (t_native, t_numpy)


def test_iq_file_reader_roundtrip(tmp_path):
    """Prefetching IQ reader delivers the file exactly, in order, with the
    final partial block truncated (the framework's data loader)."""
    from libtsd_jax.io.streamio import IqFileReader
    rng = np.random.default_rng(3)
    # 100k IQ pairs: NOT a multiple of the block size -> partial tail
    d = rng.integers(-2000, 2000, size=(100000, 2)).astype(np.int16)
    p = str(tmp_path / "cap.iq")
    d.tofile(p)
    with IqFileReader(p, "cs16", block_iq=1 << 14, nbuf=3) as rd:
        blocks = list(rd)
    assert len(blocks) == 7                      # 6 full + 1 partial
    got = np.concatenate(blocks)
    assert np.array_equal(got, d)
    assert blocks[-1].shape[0] == 100000 - 6 * (1 << 14)


def test_iq_file_reader_int8_feeds_chain_dtype(tmp_path):
    """cs8 captures stay int8 end-to-end (the chain kernel's int8 tier
    ingest dtype)."""
    from libtsd_jax.io.streamio import IqFileReader
    rng = np.random.default_rng(4)
    d = rng.integers(-127, 127, size=(4096, 2)).astype(np.int8)
    p = str(tmp_path / "cap8.iq")
    d.tofile(p)
    with IqFileReader(p, "cs8", block_iq=1024) as rd:
        blocks = list(rd)
    got = np.concatenate(blocks)
    assert got.dtype == np.int8
    assert np.array_equal(got, d)


def test_iq_file_reader_python_fallback(tmp_path, monkeypatch):
    """The pure-python path (no native lib) returns identical blocks."""
    import libtsd_jax.io.streamio as sio
    rng = np.random.default_rng(5)
    d = rng.standard_normal((5000, 2)).astype(np.float32)
    p = str(tmp_path / "cap32.iq")
    d.tofile(p)
    monkeypatch.setattr(sio, "_load", lambda: None)
    with sio.IqFileReader(p, "cf32", block_iq=2048) as rd:
        assert rd._lib is None                    # fallback engaged
        blocks = list(rd)
    got = np.concatenate(blocks)
    assert np.array_equal(got, d)


def test_stream_runner_matches_oneshot_real():
    """StreamRunner(block) over chunked pushes == one-shot filtering, with
    the remainder held in the ring buffer (never silently dropped)."""
    import jax.numpy as jnp
    from libtsd_jax.io import StreamRunner
    from libtsd_jax.ops import fir_design as FD
    from libtsd_jax.ops.filter_rt import Fir, fir_filter

    rng = np.random.default_rng(0)
    h = FD.fir_lowpass(65, 0.2)
    x = rng.standard_normal(1000).astype(np.float32)
    runner = StreamRunner(Fir.create(h), block_len=256, complex_in=False)
    # push in awkward chunk sizes
    out = runner.run([x[:100], x[100:137], x[137:900], x[900:]])
    assert out.shape == (768,)           # 3 full blocks dispatched
    assert runner.residual == 1000 - 768
    ref = np.asarray(fir_filter(h, x[:768]))
    assert np.max(np.abs(out - ref)) < 1e-4
    # the monitor records one wall-clock interval per run() (per-block
    # timers under async dispatch measured only dispatch latency);
    # samples still counts the dispatched work
    assert runner.monitor.stats.count == 1
    assert runner.monitor.stats.samples == 768


def test_stream_runner_complex_sink():
    import jax.numpy as jnp
    from libtsd_jax.io import StreamRunner
    from libtsd_jax.ops.filter_rt import OlaFft, fir_filter

    rng = np.random.default_rng(1)
    h = rng.standard_normal(33)
    blk = OlaFft.create(h, Ne=128)
    x = (rng.standard_normal(4 * blk.Ne)
         + 1j * rng.standard_normal(4 * blk.Ne)).astype(np.complex64)
    got = []
    runner = StreamRunner(blk, block_len=2 * blk.Ne, sink=got.append)
    runner.run([x])
    runner.drain()
    y = np.concatenate(got)
    assert y.dtype.kind == "c"
    ref = np.asarray(fir_filter(h, x))
    assert np.max(np.abs(y - ref[: len(y)])) < 1e-4


def test_rebuffer_oversize_push_no_drop():
    """Regression: a push larger than the remaining ring space used to be
    silently truncated; now the push loops (draining frees space) and
    every sample reaches the callback/residual."""
    got = []
    rb = Rebuffer(N=40, callback=got.append, complex_iq=False, capacity=100)
    x = np.arange(150, dtype=np.float32)
    rb.push(x)
    total = np.concatenate(got) if got else np.zeros(0)
    assert len(total) + rb.rb.available == 150
    assert np.array_equal(total, x[: len(total)])


def test_stream_runner_oversize_chunks(tmp_path):
    """StreamRunner fed chunks larger than the ring keeps every sample."""
    import jax.numpy as jnp
    from libtsd_jax.io.runner import StreamRunner
    from libtsd_jax.ops.filter_rt import Fir
    h = np.zeros(5, np.float64); h[0] = 1.0       # identity FIR
    blk = Fir.create(h)
    runner = StreamRunner(blk, block_len=128, complex_in=False)
    # tiny ring so chunks exceed capacity
    runner._rb = RingBuffer(256, complex_iq=False)
    x = np.random.default_rng(0).standard_normal(5000).astype(np.float32)
    runner.push(x)
    runner.drain()
    out = np.concatenate(runner._out, axis=-1)
    nfull = (5000 // 128) * 128
    assert out.shape[-1] == nfull
    assert np.allclose(out, x[:nfull], atol=1e-5)


def test_ringbuffer_wraparound_exactness():
    """The two-span memcpy rewrite must be exact across many wrap points
    (odd push/pop sizes against a small capacity)."""
    from libtsd_jax.io.streamio import RingBuffer
    rng = np.random.default_rng(3)
    rb = RingBuffer(257, complex_iq=True)
    fed, got = [], []
    k = 0
    for it in range(200):
        n = int(rng.integers(1, 97))
        x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
             ).astype(np.complex64)
        acc = rb.push(x)
        fed.append(x[:acc])
        while True:
            blk = rb.pop_block(61)
            if blk is None:
                break
            got.append(blk)
    tail = rb.pop_block(rb.available) if rb.available else None
    if tail is not None:
        got.append(tail)
    a = np.concatenate(fed)
    b = np.concatenate(got)
    assert np.array_equal(a, b)


def test_ringbuffer_alloc_failure_raises():
    from libtsd_jax.io.streamio import RingBuffer, native_available
    if not native_available():
        pytest.skip("native lib unavailable")
    with pytest.raises(MemoryError):
        RingBuffer(1 << 60, complex_iq=True)


def test_iqreader_closed_raises(tmp_path):
    from libtsd_jax.io.streamio import IqFileReader
    p = tmp_path / "cap.cs16"
    p.write_bytes(np.arange(64, dtype=np.int16).tobytes())
    rd = IqFileReader(str(p), "cs16", block_iq=8)
    rd.close()
    with pytest.raises(ValueError, match="closed"):
        rd.next_block()


def test_stream_runner_flush_processes_tail():
    """A finite stream with a non-block-multiple length: flush() pads and
    processes the tail instead of silently dropping it."""
    import jax.numpy as jnp
    from libtsd_jax.io.runner import StreamRunner
    from libtsd_jax.ops import fir_design as FD
    from libtsd_jax.ops.filter_rt import Fir
    h = FD.fir_lowpass(31, 0.2)
    blk = Fir.create(np.asarray(h, np.complex128))
    n = 4096 + 1000                     # 1000-sample tail
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
         ).astype(np.complex64)
    r = StreamRunner(blk, 4096)
    r.push(x)
    assert r.residual == 1000
    nvalid = r.flush()
    assert nvalid == 1000 and r.residual == 0
    out = np.concatenate(r._out, axis=-1)
    # reference: one-shot filter over the zero-padded signal
    xp = np.concatenate([x, np.zeros(4096 - 1000, np.complex64)])
    _, ref = blk.step(blk.init_for(jnp.asarray(xp)), jnp.asarray(xp))
    assert np.allclose(out, np.asarray(ref), atol=1e-5)


def test_stream_runner_depth_validation():
    from libtsd_jax.io.runner import StreamRunner
    from libtsd_jax.ops.filter_rt import Fir
    from libtsd_jax.ops import fir_design as FD
    blk = Fir.create(np.asarray(FD.fir_lowpass(7, 0.2), np.complex128))
    with pytest.raises(ValueError, match="depth"):
        StreamRunner(blk, 1024, depth=0)


def test_ring_buffer_domain_validation():
    """REGRESSION: real 1-D floats into a complex_iq ring were silently
    paired into bogus I/Q; complex into a real ring was mangled."""
    import numpy as np
    import pytest as _pytest
    from libtsd_jax.io.streamio import RingBuffer
    rb = RingBuffer(1024, complex_iq=True)
    with _pytest.raises(ValueError):
        rb.push(np.zeros(64, np.float32))
    rb.push(np.zeros(64, np.complex64))          # fine
    rbr = RingBuffer(1024, complex_iq=False)
    with _pytest.raises(ValueError):
        rbr.push(np.zeros(64, np.complex64))
    rbr.push(np.zeros(64, np.float32))           # fine


def test_iq_reader_partial_pair_tail(tmp_path):
    """REGRESSION: a file tail holding only a partial I/Q pair returned
    an empty (0, 2) block instead of the documented None sentinel."""
    import numpy as np
    from libtsd_jax.io.streamio import IqFileReader
    p = str(tmp_path / "t.cs16")
    data = np.arange(64, dtype=np.int16).tobytes() + bytes([1])  # +1 byte
    open(p, "wb").write(data)
    r = IqFileReader(p, "cs16", block_iq=16)
    blocks = list(r)
    assert all(len(b) > 0 for b in blocks)
    assert sum(len(b) for b in blocks) == 32


def test_datetime_microsecond_arithmetic():
    """REGRESSION: DateTime +/- Duration routed through the float64
    Julian day (~47 us resolution near modern dates), silently dropping
    small durations."""
    from libtsd_jax.utils.timedate import (Calendar, DateTime, Duration,
                                           TimeOfDay, datetime_add,
                                           datetime_diff)
    dt = DateTime(Calendar(2026, 8, 21), TimeOfDay(12, 0, 0.0))
    d2 = datetime_add(dt, Duration.microseconds(20))
    assert datetime_diff(d2, dt).tics == 20
    d3 = datetime_add(dt, Duration.days(2) + Duration.seconds(3.5))
    assert datetime_diff(d3, dt).tics == 2 * 86400 * 10**6 + 3_500_000
    assert d3.cal.day == 23


def test_checkpoint_dtype_mismatch_rejected(tmp_path):
    import numpy as np
    import jax.numpy as jnp
    import pytest as _pytest
    from libtsd_jax.utils.checkpoint import (save_stream_state,
                                             load_stream_state)
    st = {"a": jnp.zeros((4,), jnp.complex64)}
    p = str(tmp_path / "c.npz")
    save_stream_state(p, st, np.zeros(0, np.complex64), {"n": 0})
    like = {"a": jnp.zeros((4,), jnp.float32)}   # complex -> real drift
    with _pytest.raises(ValueError):
        load_stream_state(p, like)
