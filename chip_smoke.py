#!/usr/bin/env python
"""On-card smoke run of libtsd_jax: the library's entry points on the GPU
at deployment sizes, each checked against a plain reference.

    python chip_smoke.py          # one GPU: phases 1-6
    python chip_smoke.py --four   # four GPUs: phase 7, the mesh only

Phases (one GPU):
  1. device       — JAX sees a GPU; prints it, and the card's name and
                    power limit.
  2. goldens      — BASELINE configs 1-5 against the libtsd-binary goldens
                    (tests/golden/cfg*), jitted on the card, with the
                    tolerances of tests/test_golden_ref.py.
  3. metric chain — the ``gpu``-marked tests (tests/test_gpu.py), then the
                    256-tap FIR + 4096-point periodogram, C = 256 x 4 Mi
                    samples per call, int16 (two state-chained calls),
                    int8 and float32 ingest; the fused kernel against the
                    plain XLA version on every channel and a float64
                    NumPy/SciPy chain on 4 channels (1e-2 of the peak).
  4. served streams — the frame Receiver and the FM receiver through
                    io.StreamRunner in blocks of 1 Mi samples.
  5. batched receivers — QAM-16 receive over C = 1024 channels, the FM
                    receiver over C = 256 channels.
  6. timings      — device-chained times of the plain XLA paths, and of the
                    kernel, at the shapes above.

Phase 7 (``--four``) runs each sharded path on a 4-card mesh, once as
chan=4,time=1 and once as chan=1,time=4, against the same call on one
card.

Any failed phase ends the run with a nonzero exit.  The last line is the
JSON result; it is printed only when every phase passed.
"""
import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np

from libtsd_jax.utils.testing import (fir_periodogram_ref as chain_ref,
                                     fm_receiver_ref, rel_to_peak)

NFFT = 4096
# deployment sizes (channels x samples per call or step)
SIZE = dict(
    chain=(256, 1 << 22),          # metric chain: 256 x 4 Mi
    block=1 << 20,                 # served-stream block: 1 Mi samples
    qam_c=1024,                    # batched QAM-16 channels
    fm=(256, 1 << 18),             # batched FM receiver
    demod=((256, 1024, 4096), 16384),
    det=(64, 131072),
    filt=(256, 1 << 18),
    four_chain=(64, 1 << 22),
    four_stream=1 << 20,
)


def log(msg):
    print(msg, flush=True)


def phase(name):
    def wrap(fn):
        def run(*a, **k):
            log(f"== phase {name}")
            t0 = time.perf_counter()
            out = fn(*a, **k)
            log(f"== phase {name}: ok ({time.perf_counter() - t0:.1f} s)")
            return out
        return run
    return wrap


def check(cond, what):
    if not cond:
        raise AssertionError(what)
    log(f"   ok  {what}")


def fm_signal(cfg, C, n, seed):
    """C FM stations at cfg.channel_freq, distinct audio tones."""
    from libtsd_jax.models.analog import fm_modulate
    import jax.numpy as jnp
    t = np.arange(n)
    aud = np.stack([0.6 * np.sin(2 * np.pi * (0.001 + 0.0005 * (c % 8)) * t)
                    for c in range(C)]).astype(np.float32)
    base = np.asarray(fm_modulate(jnp.asarray(aud),
                                  deviation=cfg.deviation / cfg.decim))
    lo = np.exp(2j * np.pi * np.mod(cfg.channel_freq * t, 1.0))
    rng = np.random.default_rng(seed)
    noise = 0.01 * (rng.standard_normal((C, n))
                    + 1j * rng.standard_normal((C, n)))
    return (base * lo + noise).astype(np.complex64)


def time_chained(step, state, x, iters=10, reps=3):
    """ms per step of a state-chained run: ``iters`` steps inside one jit,
    one sync at the end, best of ``reps`` after a warm-up run."""
    import jax
    import jax.numpy as jnp

    def first_inexact(y):
        for leaf in jax.tree.leaves(y):
            if jnp.issubdtype(leaf.dtype, jnp.inexact):
                return leaf
        raise ValueError("step output has no float leaf")

    @jax.jit
    def run(state, x):
        def body(i, c):
            st, acc = c
            st, y = step(st, x)
            v = first_inexact(y)
            return st, acc + jnp.sum(jnp.abs(v)).astype(jnp.float32)
        return jax.lax.fori_loop(0, iters, body,
                                 (state, jnp.zeros((), jnp.float32)))

    jax.block_until_ready(run(state, x))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(state, x))
        best = min(best, time.perf_counter() - t0)
    return best / iters * 1e3


# ---------------------------------------------------------------- phases

@phase("1 device")
def phase_device(want):
    import jax
    from libtsd_jax.platform import enable_compile_cache, gpu_card
    devs = jax.devices()
    log(f"   jax.devices() = {devs}")
    dev = devs[0]
    log(f"   platform={dev.platform} device_kind={dev.device_kind} "
        f"count={len(devs)}")
    check(dev.platform == "gpu", "JAX's default device is a GPU")
    check(len(devs) >= want, f"at least {want} GPU(s)")
    card = gpu_card()
    log(f"   card: {card}")
    log(f"   compile cache: {enable_compile_cache()}")
    return dev, card


@phase("2 goldens (BASELINE cfg1-5)")
def phase_goldens():
    import jax
    import jax.numpy as jnp
    gold = os.path.join(REPO, "tests", "golden")
    g = lambda n: np.load(os.path.join(gold, n + ".npy"))

    # cfg1: windowed FIR design, signal generators, filtering
    from libtsd_jax.ops.fir_design import fir_design_windowed
    from libtsd_jax.ops.filter_rt import filter_signal
    from libtsd_jax.ops.signal import sigchirp, sigcos
    h = np.asarray(fir_design_windowed(31, "lp", 0.25, "hn"))
    check(np.abs(h - g("cfg1_h")).max() < 2e-4, "cfg1 FIR design")
    x = np.asarray(jax.jit(lambda: sigcos(0.01, 500) + 0.1 * sigchirp(
        0.05, 0.45, 500))())
    check(np.abs(x - g("cfg1_x")).max() < 1e-4, "cfg1 signal generators")
    h1 = g("cfg1_h")
    y = np.asarray(jax.jit(lambda v: filter_signal(h1, v))(
        jnp.asarray(g("cfg1_x"))))
    err = np.abs(y[:500] - g("cfg1_y")).max()
    check(err < 2e-6, f"cfg1 filtering (max err {err:.2e} < 2e-6)")

    # cfg2: orthonormal FFT, correlogram, Welch
    from libtsd_jax.ops.fft import fft
    from libtsd_jax.ops.psd import psd_welch
    from libtsd_jax.ops.window import window
    X = np.asarray(jax.jit(fft)(jnp.asarray(g("cfg2_x"))))
    err = np.abs(X - g("cfg2_X")).max()
    check(err < 2e-6, f"cfg2 FFT (max err {err:.2e} < 2e-6)")
    w = np.asarray(window("hann", 4096, sym=False))
    Y = np.asarray(jax.jit(fft)(jnp.asarray(g("cfg2_x") * w)))
    S = 10 * np.log10(np.abs(Y[:2048]) ** 2 + 1e-300)
    d = np.abs(S - g("cfg2_psd"))
    check(np.percentile(d, 99) < 0.2 and d.max() < 1.0,
          f"cfg2 correlogram (p99 {np.percentile(d, 99):.3f} dB, "
          f"max {d.max():.3f} dB)")

    def welch(v):
        out = psd_welch(v.astype(jnp.complex64), 512, "hann")
        return out[1] if isinstance(out, tuple) else out
    S = np.asarray(jax.jit(welch)(jnp.asarray(g("cfg2_x"))))
    err = np.abs(S - g("cfg2_welch")).max()
    check(err < 0.05, f"cfg2 Welch (max err {err:.3f} dB < 0.05)")

    # cfg3: 48 k -> 44.1 k resampler
    from libtsd_jax.ops.resample import resample
    y = np.asarray(jax.jit(lambda v: resample(v, 44100 / 48000))(
        jnp.asarray(g("cfg3_x"))))
    y_ref = g("cfg3_y")
    check(y.shape == y_ref.shape, f"cfg3 length {y.shape}")
    err = np.abs(y[50:-50] - y_ref[50:-50]).max()
    check(err < 5e-3, f"cfg3 resampler (max err {err:.2e} < 5e-3)")

    # cfg4: FM discriminator
    from libtsd_jax.models.demod import quadrature_discriminator
    y = np.asarray(jax.jit(lambda v: quadrature_discriminator(
        v, jnp.zeros((1,), jnp.complex64)))(jnp.asarray(g("cfg4_x"))))
    err = np.abs(y[1:] - g("cfg4_y")[1:]).max()
    check(err < 1e-6, f"cfg4 discriminator (max err {err:.2e} < 1e-6)")

    # cfg5: QAM-16 TX, and RX of the reference's TX
    from libtsd_jax.models import ber as BER
    from libtsd_jax.models.modulator import ModConfig, Modulator
    from libtsd_jax.models.receivers import Qam16Modem
    from libtsd_jax.models.waveform import PulseShape, wf_qam
    bits = jnp.asarray(g("cfg5_bits").astype(np.uint8))
    x_ref = g("cfg5_x")
    mod = Modulator.create(ModConfig(wf=wf_qam(16, PulseShape.rcs(0.25)),
                                     fe=4.0, fsymb=1.0))
    xt = np.asarray(jax.jit(lambda b: mod.modulate(b)[0])(bits))
    n = len(x_ref)
    c = np.abs(np.correlate(xt[:n], x_ref, "full"))
    lag = int(c.argmax()) - (n - 1)
    xa = np.roll(xt[:n], -lag)
    err = np.abs(xa[30:n - 30] - x_ref[30:n - 30]).max()
    check(abs(lag) <= 8 and err < 1e-5 * np.abs(x_ref).max(),
          f"cfg5 QAM-16 TX (lag {lag}, max err {err:.2e})")
    m = Qam16Modem.create()
    b, syms, mask, e = jax.jit(m.receive)(jnp.asarray(x_ref))
    rbn = np.asarray(b).reshape(-1, 4)[np.asarray(mask)].reshape(-1)
    _, errs, _ = BER.cmp_bits_psk(jnp.asarray(g("cfg5_bits")[4 * 1024:]),
                                  jnp.asarray(rbn[4 * 1024:]), 4,
                                  max_lag=64)
    check(int(errs) == 0 and float(e) < 0.09,
          f"cfg5 QAM-16 RX of the reference TX ({int(errs)} bit errors, "
          f"EVM {float(e):.4f} < 0.09)")


@phase("3a on-card tests (tests/test_gpu.py)")
def phase_gpu_tests():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "test_gpu", os.path.join(REPO, "tests", "test_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = sorted(n for n in dir(mod) if n.startswith("test_"))
    check(len(names) > 0, f"{len(names)} on-card tests found")
    for n in names:
        fn = getattr(mod, n)
        for args in getattr(fn, "chip_cases", [()]):
            fn(None, *args)
            log(f"   ok  {n}{list(args) if args else ''}")


@phase("3b metric chain (256-tap FIR + 4096-pt periodogram)")
def phase_chain(timings):
    import jax
    import jax.numpy as jnp
    from libtsd_jax.ops import fir_design as FD
    from libtsd_jax.ops.chain import (fir_periodogram4096,
                                      fir_periodogram4096_plain)
    C, N = SIZE["chain"]
    h = jnp.asarray(FD.fir_lowpass(256, 0.2), jnp.float32)
    chain = jax.jit(fir_periodogram4096)
    plain = jax.jit(fir_periodogram4096_plain)

    def gen(key, dtype):
        n = jnp.arange(N, dtype=jnp.float32)
        tone = jnp.cos(2 * jnp.pi * jnp.mod(0.05 * n, 1.0))
        if dtype == jnp.int16:
            v = jax.random.randint(key, (C, N), -2048, 2048) + 3000 * tone
        elif dtype == jnp.int8:
            v = jax.random.randint(key, (C, N), -40, 40) + 80 * tone
        else:
            v = jax.random.normal(key, (C, N)) + 2 * tone
        return jnp.round(v).astype(dtype) if dtype != jnp.float32 else v
    gen = jax.jit(gen, static_argnums=1)

    keys = jax.random.split(jax.random.PRNGKey(7), 4)
    x1 = gen(keys[0], jnp.int16)
    x2 = gen(keys[1], jnp.int16)
    hist = x1[:, -255:]
    p1 = chain(x1, h)
    p2 = chain(x2, h, hist)
    for name, out in (("int16 call 1", p1), ("int16 call 2 (state)", p2)):
        o = np.asarray(out)
        check(o.shape == (C, NFFT) and np.isfinite(o).all(),
              f"{name}: shape {o.shape}, finite")
    e = rel_to_peak(p2, plain(x2, h, hist))
    check(e < 1e-2, f"int16 kernel vs plain, all {C} channels "
          f"({e:.2e} of peak < 1e-2)")
    xs1, xs2 = np.asarray(x1[:4]), np.asarray(x2[:4])
    e1 = rel_to_peak(np.asarray(p1)[:4], chain_ref(xs1, h))
    e2 = rel_to_peak(np.asarray(p2)[:4], chain_ref(xs2, h, xs1[:, -255:]))
    check(max(e1, e2) < 1e-2, f"int16 vs float64 chain, 4 channels "
          f"({e1:.2e}, {e2:.2e} of peak < 1e-2)")
    for dt in (jnp.int8, jnp.float32):
        x = gen(keys[2], dt)
        p = np.asarray(chain(x, h))
        check(np.isfinite(p).all(), f"{jnp.dtype(dt).name}: finite")
        e = rel_to_peak(p[:4], chain_ref(np.asarray(x[:4]), h))
        ep = rel_to_peak(p, plain(x, h))
        check(e < 1e-2 and ep < 1e-2,
              f"{jnp.dtype(dt).name} vs float64 ({e:.2e}) and plain "
              f"({ep:.2e}) < 1e-2 of peak")
        del x

    # timings (phase 6 prints them): plain vs kernel, state-chained
    step_k = lambda hh, x: (hh + 0 * hh, fir_periodogram4096(x, hh))
    step_p = lambda hh, x: (hh + 0 * hh, fir_periodogram4096_plain(x, hh))
    shp = f"C={C} x {N}"
    timings[f"chain int16, {shp}: kernel"] = time_chained(
        step_k, h, x1, iters=10)
    timings[f"chain int16, {shp}: plain XLA"] = time_chained(
        step_p, h, x1, iters=5)
    x8 = gen(keys[2], jnp.int8)
    timings[f"chain int8, {shp}: kernel"] = time_chained(
        step_k, h, x8, iters=10)
    timings[f"chain int8, {shp}: plain XLA"] = time_chained(
        step_p, h, x8, iters=5)
    del x8
    x32 = gen(keys[3], jnp.float32)
    timings[f"chain f32, {shp}: kernel"] = time_chained(
        step_k, h, x32, iters=10)
    timings[f"chain f32, {shp}: plain XLA"] = time_chained(
        step_p, h, x32, iters=5)

    # the plain periodogram and FFT alone
    def pgram(s, x):
        X = jnp.fft.rfft(x.reshape(C, -1, NFFT), axis=-1)
        return s, jnp.sum(X.real * X.real + X.imag * X.imag, axis=1)
    timings[f"periodogram (rfft + |X|^2), f32 {shp}: plain XLA"] = \
        time_chained(pgram, jnp.zeros(()), x32, iters=5)
    from libtsd_jax.ops.fft import fft
    xc = (x32[:C // 4] + 0j).astype(jnp.complex64).reshape(-1, NFFT)
    timings[f"ops.fft.fft 4096-pt x {xc.shape[0]} rows (complex64)"] = \
        time_chained(lambda s, v: (s, fft(v)), jnp.zeros(()), xc, iters=5)
    del x1, x2, x32, xc


@phase("4 served streams (io.StreamRunner, 1 Mi-sample blocks)")
def phase_served():
    import jax
    import jax.numpy as jnp
    from libtsd_jax.io import StreamRunner
    from libtsd_jax.io.streamio import native_available
    log(f"   native ring buffer built on this host: {native_available()}")

    # --- frame Receiver on the rx1 golden signal (3 QPSK frames), once
    # per block, as in examples/serving_loop.py
    from libtsd_jax.models.detector import DetectorConfig
    from libtsd_jax.models.frame import FrameFormat, Receiver
    from libtsd_jax.models.modulator import ModConfig
    from libtsd_jax.models.waveform import PulseShape, wf_qpsk
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_golden_ref8 import HDR, g, lcg_bits
    fmt = FrameFormat(modulation=ModConfig(wf=wf_qpsk(PulseShape.rcs(0.25)),
                                           fe=4.0, fsymb=1.0),
                      header_bits=tuple(int(b) for b in HDR),
                      payload_bits=512)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.6))
    ne = rx.det.Ne
    bl = -(-SIZE["block"] // ne) * ne
    sig = g("g8_rx1_x").astype(np.complex64)
    nblk = 3
    x = np.zeros(nblk * bl + 2 * bl, np.complex64)
    for b in range(nblk):
        off = b * bl + 1000 + 37 * b
        x[off:off + len(sig)] = sig
    got = []
    runner = StreamRunner(rx, block_len=bl, sink=got.append, depth=2)
    t0 = time.perf_counter()
    runner.push(x)
    runner.drain()
    dt = time.perf_counter() - t0
    frames = []
    for fr in got:
        v = np.asarray(fr.valid)
        frames += [np.asarray(fr.bits)[i] for i in np.nonzero(v)[0]]
    want = [lcg_bits(s, 512) for s in (1001, 1002, 1003)] * nblk
    check(len(frames) == len(want),
          f"frame Receiver: {len(frames)} frames in {len(got)} blocks of "
          f"{bl} samples (want {len(want)})")
    check(all(np.array_equal(a, b) for a, b in zip(frames, want)),
          "frame Receiver: every frame bit-exact vs the golden payloads")
    log(f"   frame Receiver wall time incl. compile: {dt:.2f} s")

    # --- FM receiver (BASELINE config 4) on one stream
    from libtsd_jax.models.receivers import FmReceiver, FmReceiverConfig
    cfg = FmReceiverConfig(channel_freq=0.22, decim=4, deemph_fc=0.05)
    fm = FmReceiver.create(cfg)
    n = 4 * SIZE["block"]
    xf = fm_signal(cfg, 1, n, seed=3)[0]
    outs = []
    StreamRunner(fm, block_len=SIZE["block"], sink=outs.append).run([xf])
    y = np.concatenate(outs)
    ref = fm_receiver_ref(fm, xf)
    e = float(np.abs(y - ref).max())
    check(y.shape == ref.shape and e < 2e-3,
          f"FM receiver via StreamRunner, 4 blocks: max err {e:.2e} vs "
          f"the float64 chain (< 2e-3)")
    e_cpu = None
    with jax.default_device(jax.devices("cpu")[0]):
        _, y_cpu = jax.jit(fm.step)(fm.init_for(jnp.asarray(xf)),
                                    jnp.asarray(xf))
        e_cpu = float(np.abs(y - np.asarray(y_cpu)).max())
    check(e_cpu < 2e-3, f"FM receiver: GPU vs the same chain composed on "
          f"the CPU, max err {e_cpu:.2e} < 2e-3")


@phase("5 batched receivers")
def phase_batched(timings):
    import jax
    import jax.numpy as jnp
    from libtsd_jax.models import ber as BER
    from libtsd_jax.models.receivers import Qam16Modem
    import __graft_entry__ as GE

    # QAM-16: the __graft_entry__.entry step batched over channels
    step, (modem, bits) = GE.entry()
    C = SIZE["qam_c"]
    nsym = bits.shape[0] // 4

    @jax.jit
    def batched(modem, bits, key):
        x = modem.transmit(bits)
        noise = 0.01 * (jax.random.normal(key, (C, x.shape[0]))
                        + 1j * jax.random.normal(jax.random.fold_in(key, 1),
                                                 (C, x.shape[0])))
        xs = x[None] + noise.astype(jnp.complex64)
        return jax.vmap(lambda v: modem.receive(v))(xs)

    rb, syms, mask, ev = batched(modem, bits, jax.random.PRNGKey(3))
    ev = np.asarray(ev)
    check(ev.shape == (C,) and float(ev.max()) < 0.09,
          f"QAM-16 x {C} channels: tail EVM max {ev.max():.4f} < 0.09")
    rb, mask = np.asarray(rb).reshape(C, -1, 4), np.asarray(mask)
    nerr = 0
    for c in range(C):
        rbn = rb[c][mask[c]].reshape(-1)
        _, e, _ = BER.cmp_bits_psk(bits[4 * 128:], jnp.asarray(rbn[4 * 128:]),
                                   4, max_lag=64)
        nerr += int(e)
    check(nerr == 0, f"QAM-16: 0 bit errors past warm-up on all {C} "
          f"channels ({nsym} symbols each)")

    # FM receiver over C = 256 channels
    from libtsd_jax.models.receivers import FmReceiver, FmReceiverConfig
    cfg = FmReceiverConfig(channel_freq=0.22, decim=4, deemph_fc=0.05)
    fm = FmReceiver.create(cfg)
    C2, n = SIZE["fm"]
    xf = fm_signal(cfg, C2, n, seed=5)
    xj = jnp.asarray(xf)
    st = jax.jit(fm.init_for)(xj)
    _, y = jax.jit(fm.step)(st, xj)
    y = np.asarray(y)
    check(y.shape == (C2, n // 4) and np.isfinite(y).all(),
          f"FM x {C2}: shape {y.shape}, finite")
    rows = [0, C2 - 1]
    e = float(np.abs(y[rows] - fm_receiver_ref(fm, xf[rows])).max())
    check(e < 2e-3, f"FM x {C2}: channels {rows} vs the float64 chain, "
          f"max err {e:.2e} < 2e-3")
    timings[f"FmReceiver step, C={C2} x {n} complex64"] = time_chained(
        fm.step, st, xj, iters=10)
    del xj, xf


@phase("6 timings of the plain XLA paths and the kernel")
def phase_timings(timings, card):
    import jax
    import jax.numpy as jnp
    from libtsd_jax.models import waveform as WF
    from libtsd_jax.models.demod_sb import DecisionDemodSB, SBDemodConfig
    from libtsd_jax.models.detector import Detector, DetectorConfig
    from libtsd_jax.ops import filter_rt as FR
    from libtsd_jax.ops import fir_design as FD
    from scipy import signal as sps
    key = jax.random.PRNGKey(11)

    def cnoise(shape):
        a, b = jax.random.normal(key, (2,) + shape)
        return (a + 1j * b).astype(jnp.complex64)
    cnoise = jax.jit(cnoise, static_argnums=0)

    # sub-block QAM demod, XLA scan
    wf = WF.wf_qam(16, WF.PulseShape.rcs(0.25))
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=4, S=16))
    Cs, nd = SIZE["demod"]
    for C in Cs:
        x = cnoise((C, nd))
        timings[f"DecisionDemodSB step (XLA scan), C={C} x {nd}"] = \
            time_chained(dd.step, jax.jit(dd.init_for)(x), x, iters=5)
    # detector front end, XLA OLA correlation
    pat = np.exp(2j * np.pi * np.random.default_rng(0).random(256))
    det = Detector.create(pat, DetectorConfig(threshold=0.6))
    Cd, nd = SIZE["det"]
    nd = -(-nd // det.Ne) * det.Ne
    x = cnoise((Cd, nd))
    st = jax.vmap(lambda _: det.init())(jnp.arange(Cd))
    timings[f"Detector step (OLA), vmap C={Cd} x {nd}"] = time_chained(
        jax.vmap(det.step), st, x, iters=5)
    # overlap-add FFT filter
    ola = FR.OlaFft.create(FD.fir_lowpass(129, 0.2))
    Cf, nf = SIZE["filt"]
    no = -(-nf // ola.Ne) * ola.Ne
    x = cnoise((Cf, no))
    timings[f"OlaFft 129 taps, C={Cf} x {no} complex64"] = \
        time_chained(ola.step, jax.jit(ola.init_for)(x), x, iters=5)
    # Toeplitz FIR and frame-parallel IIR
    xr = jax.random.normal(key, (Cf, nf))
    fir = FR.Fir.create(FD.fir_lowpass(256, 0.2))
    timings[f"Fir 256 taps (Toeplitz), C={Cf} x {nf} f32"] = time_chained(
        fir.step, jax.jit(fir.init_for)(xr), xr, iters=5)
    sos = FR.sos_frame_chain(sps.butter(4, 0.1, output="sos"))
    timings[f"sos_frame_chain 4th order, C={Cf} x {nf} f32"] = \
        time_chained(sos.step, jax.jit(sos.init_for)(xr), xr, iters=5)
    log(f"   timings on {card} (ms per step, device-chained, best of 3):")
    for k, v in timings.items():
        log(f"   time  {k}: {v:.3f} ms")


@phase("7 four-card mesh (chan x time)")
def phase_four():
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from libtsd_jax.models.receivers import FmReceiver, FmReceiverConfig
    from libtsd_jax.ops import filter_rt as FR
    from libtsd_jax.ops import fir_design as FD
    from libtsd_jax.ops.chain import fir_periodogram4096
    from libtsd_jax.parallel import (make_mesh, sharded_chain,
                                     sharded_fir_periodogram4096,
                                     sharded_fm_receiver)
    one = jax.devices()[0]
    on_one = lambda a: jax.device_put(a, one)
    key = jax.random.PRNGKey(2)

    # inputs made once, on card 0
    C, N = SIZE["four_chain"]
    ns = SIZE["four_stream"]
    h = jnp.asarray(FD.fir_lowpass(256, 0.2), jnp.float32)
    xk = on_one(jax.jit(lambda k: jax.random.randint(
        k, (C, N), -2048, 2048).astype(jnp.int16))(key))
    spec1 = np.asarray(jax.jit(fir_periodogram4096)(xk, h))
    h1, h2 = FD.fir_lowpass(33, 0.2), FD.fir_lowpass(17, 0.3)
    b1, b2 = FR.Fir.create(h1), FR.Fir.create(h2)
    xc = on_one(jax.random.normal(key, (16, ns)))
    chain1 = np.asarray(jax.jit(lambda v: b2.apply(b1.apply(v)))(xc))
    cfg = FmReceiverConfig(channel_freq=0.22, decim=4, deemph_fc=0.05)
    fm = FmReceiver.create(cfg)
    xf = on_one(jnp.asarray(fm_signal(cfg, 8, ns, seed=9)))
    fm1 = np.asarray(jax.jit(lambda v: fm.step(fm.init_for(v), v)[1])(xf))
    frx = frame_rx_case()
    fr1 = frx["run"](on_one(frx["x"]))

    for chan, tm in ((4, 1), (1, 4)):
        mesh = make_mesh(chan=chan, time=tm)
        sh = NamedSharding(mesh, P("chan", "time"))
        tag = f"chan={chan},time={tm}"
        spec = np.asarray(jax.jit(lambda v, hh: sharded_fir_periodogram4096(
            mesh, v, hh))(jax.device_put(xk, sh), h))
        # each time shard adds its first frame from the plain version
        # (float32) where one card used the kernel (bfloat16 DFT stages),
        # so the two differ by the kernel's precision on those frames
        e = rel_to_peak(spec, spec1)
        check(e < 1e-3, f"{tag} sharded_fir_periodogram4096, C={C} x {N} "
              f"int16 vs one card ({e:.2e} of peak < 1e-3)")
        y = np.asarray(jax.jit(lambda v: sharded_chain(
            mesh, [(b1, 32), (b2, 16)], v))(jax.device_put(xc, sh)))
        e = float(np.abs(y - chain1).max())
        check(e < 1e-4, f"{tag} halo.sharded_chain (33+17 taps) vs one "
              f"card, max err {e:.2e}")
        a = np.asarray(jax.jit(lambda v: sharded_fm_receiver(mesh, fm, v))(
            jax.device_put(xf, sh)))
        e = float(np.abs(a - fm1).max())
        check(e < 2e-3, f"{tag} sharded_fm_receiver vs one card, max err "
              f"{e:.2e}")
        # channels over every card of the mesh, whichever axis has them
        xs = jax.device_put(frx["x"], NamedSharding(
            mesh, P(("chan", "time"), None)))
        bits, valid = frx["run"](xs)
        same = (np.array_equal(np.asarray(valid), np.asarray(fr1[1]))
                and np.array_equal(np.asarray(bits), np.asarray(fr1[0])))
        check(same and frx["decoded"](bits, valid),
              f"{tag} sharded frame receiver: bits and valid equal one "
              f"card, payloads decoded")


def frame_rx_case():
    """The frame receiver vmapped over channels (tests/test_parallel.py
    test_sharded_frame_receiver_matches_unsharded), 8 channels."""
    import jax
    import jax.numpy as jnp
    from libtsd_jax.block import pad_to_multiple, safe_pad
    from libtsd_jax.models import waveform as WF
    from libtsd_jax.models.bitstream import randbits
    from libtsd_jax.models.detector import DetectorConfig
    from libtsd_jax.models.frame import FrameFormat, Receiver, Transmitter
    from libtsd_jax.models.modulator import ModConfig
    C = 8
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=128)
    tx = Transmitter.create(fmt)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    pays = np.stack([np.asarray(randbits(jax.random.PRNGKey(100 + c), 128))
                     for c in range(C)])
    frames = np.asarray(jax.jit(jax.vmap(tx.transmit))(jnp.asarray(pays)))
    n = 1 << 16
    rng = np.random.default_rng(0)
    x = 0.01 * (rng.standard_normal((C, n))
                + 1j * rng.standard_normal((C, n))).astype(np.complex64)
    for c in range(C):
        o = 700 + 50 * c
        x[c, o:o + frames.shape[1]] += 0.9 * np.exp(1j * 0.3) * frames[c]
    extra = max(rx.frame_len, 2 * rx.det.M) + 2 * rx.itp.K

    @jax.jit
    def run(v):
        def one(s):
            xp = pad_to_multiple(safe_pad(s, 0, extra, axis=0),
                                 rx.det.Ne, axis=0)
            _, fr = rx.step(rx.init(), xp)
            return fr.bits, fr.valid
        return jax.vmap(one)(v)

    def decoded(bits, valid):
        bits, valid = np.asarray(bits), np.asarray(valid)
        return all(np.array_equal(bits[c, int(np.argmax(valid[c]))],
                                  pays[c]) for c in range(C))

    return dict(x=jnp.asarray(x), run=run, decoded=decoded)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh phase")
    a = ap.parse_args()
    dev, card = phase_device(4 if a.four else 1)
    if a.four:
        phase_four()
    else:
        timings = {}
        phase_goldens()
        phase_gpu_tests()
        phase_chain(timings)
        phase_served()
        phase_batched(timings)
        phase_timings(timings, card)
    import jax
    count = len(jax.devices())
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)


if __name__ == "__main__":
    main()
