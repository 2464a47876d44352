"""Multi-chip sharding tests on the virtual 8-device CPU mesh (conftest
forces JAX_PLATFORMS=cpu with xla_force_host_platform_device_count=8)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.ops import filter_rt as FR
from libtsd_jax.ops import fir_design as FD
from libtsd_jax.parallel import make_mesh, channel_sharding, sharded_fir, sharded_chain
from libtsd_jax.utils.testing import check_max_error, fir_periodogram_ref

rng = np.random.default_rng(11)


def test_mesh_shapes():
    m = make_mesh(chan=2, time=4)
    assert m.shape == {"chan": 2, "time": 4}
    m2 = make_mesh(time=2)
    assert m2.shape == {"chan": 4, "time": 2}


def test_sharded_fir_matches_unsharded():
    mesh = make_mesh(chan=2, time=4)
    h = FD.fir_lowpass(65, 0.1)
    fir = FR.Fir.create(h)
    C, N = 4, 1024
    x = jnp.asarray(rng.standard_normal((C, N)), jnp.float32)
    xs = jax.device_put(x, channel_sharding(mesh))
    y_sharded = sharded_fir(mesh, fir, xs, state_len=64)
    y_ref = FR.fir_filter(h, x)
    check_max_error(np.asarray(y_sharded), np.asarray(y_ref), 1e-4)


def test_sharded_fir_time_only():
    mesh = make_mesh(chan=1, time=8)
    h = FD.fir_lowpass(33, 0.2)
    fir = FR.Fir.create(h)
    x = jnp.asarray(rng.standard_normal((2, 2048)), jnp.float32)
    xs = jax.device_put(x, channel_sharding(mesh))
    y = sharded_fir(mesh, fir, xs, state_len=32)
    y_ref = FR.fir_filter(h, x)
    check_max_error(np.asarray(y), np.asarray(y_ref), 1e-4)


def test_sharded_chain_two_stages():
    mesh = make_mesh(chan=2, time=4)
    h1 = FD.fir_lowpass(33, 0.2)
    h2 = FD.fir_lowpass(17, 0.3)
    b1, b2 = FR.Fir.create(h1), FR.Fir.create(h2)
    x = jnp.asarray(rng.standard_normal((2, 1024)), jnp.float32)
    xs = jax.device_put(x, channel_sharding(mesh))
    y = sharded_chain(mesh, [(b1, 32), (b2, 16)], xs)
    y_ref = FR.fir_filter(h2, FR.fir_filter(h1, x))
    check_max_error(np.asarray(y), np.asarray(y_ref), 1e-4)


def test_sharded_jit_compiles():
    mesh = make_mesh(chan=4, time=2)
    h = FD.fir_lowpass(33, 0.15)
    fir = FR.Fir.create(h)

    @jax.jit
    def step(v):
        return sharded_fir(mesh, fir, v, state_len=32)

    x = jax.device_put(
        jnp.asarray(rng.standard_normal((8, 512)), jnp.float32),
        channel_sharding(mesh))
    y = step(x)
    assert y.shape == (8, 512)
    # output sharding preserved
    assert y.sharding.spec == channel_sharding(mesh).spec


@pytest.mark.parametrize("chan,time", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_sharded_chain_periodogram_matches_unsharded(chan, time):
    """The metric chain under shard_map over ("chan","time"), with the
    ppermute FIR halo and the psum of partial spectra, equals the
    one-device chain and the float64 oracle."""
    from libtsd_jax.ops.chain import fir_periodogram4096
    from libtsd_jax.parallel import sharded_fir_periodogram4096

    mesh = make_mesh(chan=chan, time=time)
    h = jnp.asarray(FD.fir_lowpass(200, 0.15), jnp.float32)
    C, N = 8, time * 2 * 4096
    x = jnp.asarray(rng.standard_normal((C, N)), jnp.float32)
    xs = jax.device_put(x, channel_sharding(mesh))
    acc_sh = np.asarray(sharded_fir_periodogram4096(mesh, xs, h))
    acc_1 = np.asarray(fir_periodogram4096(x, h))
    # identical math modulo fp32 re-association of the per-shard sums
    assert np.max(np.abs(acc_sh - acc_1)) / acc_1.max() < 1e-5
    ref = fir_periodogram_ref(np.asarray(x), h)
    assert np.max(np.abs(acc_sh - ref)) / ref.max() < 1e-4


def test_sharded_chain_periodogram_int16_ingest():
    """int16 ADC samples through the sharded chain (the halo carries
    them as the chain's history)."""
    from libtsd_jax.parallel import sharded_fir_periodogram4096

    mesh = make_mesh(chan=4, time=2)
    h = jnp.asarray(FD.fir_lowpass(256, 0.2), jnp.float32)
    C, N = 4, 2 * 2 * 4096
    x = rng.integers(-2048, 2048, (C, N)).astype(np.int16)
    xs = jax.device_put(jnp.asarray(x), channel_sharding(mesh))
    acc = np.asarray(sharded_fir_periodogram4096(mesh, xs, h))
    ref = fir_periodogram_ref(x, h)
    assert np.max(np.abs(acc - ref)) / ref.max() < 1e-4


def test_baseline_config3_sharded_resampler_chain():
    """BASELINE config 3: 256-tap FIR + rational 48k->44.1k resampler
    (147/160 fractional-interpolator bank) on 64 channels sharded over the
    mesh — sharded output must equal the unsharded computation."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from libtsd_jax.ops import resample as RS

    mesh = make_mesh(chan=8, time=1)
    h = FD.fir_lowpass(256, 0.2)
    fir = FR.Fir.create(h)
    rs = RS.RationalResampler.create(44100 / 48000)
    assert (rs.p, rs.q) == (147, 160)
    C, N = 64, 1600
    x = jnp.asarray(rng.standard_normal((C, N)), jnp.float32)
    xs = jax.device_put(x, channel_sharding(mesh))

    def per_shard(v):
        _, y = fir.step(fir.init_for(v), v)
        _, z = rs.step(rs.init_for(y), y)
        return z

    f = jax.jit(shard_map(per_shard, mesh=mesh,
                          in_specs=P("chan", None),
                          out_specs=P("chan", None)))
    z = np.asarray(f(xs))
    assert z.shape == (C, N * 147 // 160)
    z_ref = np.asarray(per_shard(x))
    check_max_error(z, z_ref, 1e-5)


# ------------------------------------------- time-sharded recursive filters

def test_iir_time_sharded_matches_unsharded():
    """Cross-shard affine state composition: an order-2
    Butterworth IirFrame over a time-sharded signal equals the unsharded
    frame-parallel run to float32 reassociation noise."""
    from libtsd_jax.ops.iir_design import design_iir
    mesh = make_mesh(chan=2, time=4)
    b, a = design_iir(2, "lp", "butt", 0.1).to_ba()
    blk = FR.IirFrame.create(b, a)
    C, N = 2, 4096
    x = jnp.asarray(rng.standard_normal((C, N)), jnp.float32)
    xs = jax.device_put(x, channel_sharding(mesh))
    y = sharded_chain(mesh, [(blk, 0)], xs)
    y_ref = FR.iir_filter(b, a, x)
    check_max_error(np.asarray(y), np.asarray(y_ref), 1e-4)


def test_iir_time_sharded_time_only_order1():
    """Order-1 de-emphasis (design_lexp) as IirFrame, time-sharded 8 ways
    — the FM chain's feedback stage (BASELINE config 4)."""
    from libtsd_jax.ops.iir_design import design_lexp
    mesh = make_mesh(chan=2, time=4)
    b, a = design_lexp(0.05)
    blk = FR.IirFrame.create(b, a)
    x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
    xs = jax.device_put(x, channel_sharding(mesh))
    y = sharded_chain(mesh, [(blk, 0)], xs)
    y_ref = FR.iir_filter(b, a, x)
    check_max_error(np.asarray(y), np.asarray(y_ref), 1e-4)


def test_sharded_chain_fir_then_iir():
    """Mixed chain: sample-halo FIR stage feeding a recursive IIR stage
    under ONE shard_map — the end-to-end time-sharded cascade shape of
    the FM receiver."""
    from libtsd_jax.ops.iir_design import design_iir
    mesh = make_mesh(chan=2, time=4)
    h = FD.fir_lowpass(33, 0.2)
    fir = FR.Fir.create(h)
    b, a = design_iir(2, "lp", "butt", 0.08).to_ba()
    iir = FR.IirFrame.create(b, a)
    x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
    xs = jax.device_put(x, channel_sharding(mesh))
    y = sharded_chain(mesh, [(fir, 32), (iir, 0)], xs)
    y_ref = FR.iir_filter(b, a, FR.fir_filter(h, x))
    check_max_error(np.asarray(y), np.asarray(y_ref), 1e-4)


def test_sos_chain_time_sharded():
    """A Chain of IirFrames (sos_frame_chain: order-4 elliptic as two
    biquads) routes each section through the state composition."""
    from libtsd_jax.ops.iir_design import design_iir, zpk_to_sos
    mesh = make_mesh(chan=2, time=4)
    zpk = design_iir(4, "lp", "ellip", 0.1, 0.5, 40.0)
    sos, k = zpk_to_sos(zpk)
    chain = FR.sos_frame_chain(sos, k)
    x = jnp.asarray(rng.standard_normal((2, 4096)), jnp.float32)
    xs = jax.device_put(x, channel_sharding(mesh))
    y = sharded_chain(mesh, [(chain, 0)], xs)
    st = chain.init_for(x)
    _, y_ref = chain.step(st, x)
    check_max_error(np.asarray(y), np.asarray(y_ref), 1e-4)


def test_sharded_fm_receiver_matches_unsharded():
    """BASELINE config 4 under the (chan, time) mesh END-TO-END, feedback
    stage included: NCO mix (global-offset reconstruction) + halo'd
    polyphase FIR/decimate + 1-sample-halo discriminator + cross-shard
    de-emphasis state composition == the unsharded FmReceiver."""
    from libtsd_jax.models.receivers import FmReceiver, FmReceiverConfig
    from libtsd_jax.parallel import sharded_fm_receiver
    from libtsd_jax.models.analog import fm_modulate

    mesh = make_mesh(chan=2, time=4)
    cfg = FmReceiverConfig(channel_freq=0.22, decim=4, deemph_fc=0.05)
    fm = FmReceiver.create(cfg)
    C, N = 2, 8192   # n_local/decim = 256 -> frame-multiple per shard
    audio_in = np.stack([
        0.7 * np.sin(2 * np.pi * 0.004 * np.arange(N)),
        0.5 * np.sin(2 * np.pi * 0.007 * np.arange(N))])
    base = fm_modulate(jnp.asarray(audio_in, jnp.float32), cfg.deviation)
    k = jnp.arange(N, dtype=jnp.float32)
    x = (base * jnp.exp(2j * jnp.pi * jnp.mod(cfg.channel_freq * k, 1.0))
         ).astype(jnp.complex64)
    xs = jax.device_put(x, channel_sharding(mesh))
    y = sharded_fm_receiver(mesh, fm, xs)
    _, y_ref = fm.step(fm.init_for(x), x)
    d = np.abs(np.asarray(y) - np.asarray(y_ref))
    assert d.max() < 2e-3, d.max()
    # the audio itself is meaningful (not comparing zeros)
    assert np.abs(np.asarray(y_ref)).max() > 0.1


def test_sharded_chain_rejects_raw_recursive_blocks():
    """A recursive block whose state is NOT an input-sample tail must be
    rejected loudly (an order-1 Iir's state even has the right shape for
    a 1-sample halo, so the fallback would be silently wrong)."""
    from libtsd_jax.ops import iir_design as ID
    from libtsd_jax.parallel import sharded_chain
    mesh = make_mesh(chan=4, time=2)
    b, a = ID.design_lexp(0.1)
    iir = FR.Iir.create(b, a)
    x = jnp.zeros((8, 256), jnp.float32)
    with pytest.raises(TypeError, match="recursion"):
        sharded_chain(mesh, [(iir, 1)], x)


def test_make_mesh_validation():
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(time=3)            # 8 virtual devices
    with pytest.raises(ValueError, match="does not fit"):
        make_mesh(time=16)
    m = make_mesh(chan=2, time=3)    # explicit subset is allowed
    assert m.shape == {"chan": 2, "time": 3}


def test_fm_receiver_sharded_matches_unsharded_long():
    """Parity at a length where a raw f32 f*k ramp would have quantized
    to ~2^-10-cycle steps (the sharded and unsharded NCOs must both use
    the host-f64-exact wrapped ramp)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from libtsd_jax.models.receivers import FmReceiver, FmReceiverConfig
    from libtsd_jax.parallel import sharded_fm_receiver
    cfg = FmReceiverConfig(channel_freq=0.22, decim=4, deviation=0.05)
    fm = FmReceiver.create(cfg)
    mesh = make_mesh(chan=2, time=4)
    C, N = 4, 1 << 18                # 262144 samples; f*k ~ 5.8e4
    key = jax.random.PRNGKey(9)
    kk = np.arange(N, dtype=np.float64)
    mchirp = np.cumsum(0.03 * np.sin(2 * np.pi * 0.001 * kk))
    ph = 2 * np.pi * (np.mod(0.22 * kk, 1.0) + 0.05 * mchirp)
    x = jnp.tile(jnp.asarray(np.exp(1j * ph),
                             jnp.complex64)[None, :], (C, 1))
    xs = jax.device_put(x, NamedSharding(mesh, P("chan", "time")))
    y_sh = np.asarray(sharded_fm_receiver(mesh, fm, xs))
    _, y_un = fm.step(fm.init_for(x), x)
    y_un = np.asarray(y_un)
    # ignore the filter warm-up at the start
    d = np.abs(y_sh[:, 16:] - y_un[:, 16:])
    assert d.max() < 1e-4, d.max()


def test_sharded_frame_receiver_matches_unsharded():
    """The FULL frame receiver (detector + extraction + PLL) vmapped
    over a chan-sharded mesh: per-channel decodes identical to the
    unsharded run (channels are the SDR data-parallel axis)."""
    import numpy as np
    from libtsd_jax.models import waveform as WF
    from libtsd_jax.models.bitstream import randbits
    from libtsd_jax.models.detector import DetectorConfig
    from libtsd_jax.models.frame import FrameFormat, Receiver, Transmitter
    from libtsd_jax.models.modulator import ModConfig
    from libtsd_jax.parallel import make_mesh, P, NamedSharding

    mesh = make_mesh(chan=4, time=1)
    C = 4
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=128)
    tx = Transmitter.create(fmt)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    pays = jnp.stack([randbits(jax.random.PRNGKey(100 + c), 128)
                      for c in range(C)])
    frames = jax.vmap(tx.transmit)(pays)
    n = 6144
    rng = np.random.default_rng(0)
    x = 0.01 * (rng.standard_normal((C, n))
                + 1j * rng.standard_normal((C, n))).astype(np.complex64)
    for c in range(C):
        x[c, 700 + 50 * c: 700 + 50 * c + frames.shape[1]] += \
            0.9 * np.exp(1j * 0.3) * np.asarray(frames[c])
    from libtsd_jax.block import pad_to_multiple, safe_pad
    extra = max(rx.frame_len, 2 * rx.det.M) + 2 * rx.itp.K

    @jax.jit
    def run(r, v):
        def one(s):
            xp = pad_to_multiple(safe_pad(s, 0, extra, axis=0),
                                 r.det.Ne, axis=0)
            _, fr = r.step(r.init(), xp)
            return fr.bits, fr.valid
        return jax.vmap(one)(v)

    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("chan",
                                                              None)))
    bits_s, valid_s = run(rx, xs)
    bits_u, valid_u = run(rx, jnp.asarray(x))
    assert np.array_equal(np.asarray(valid_s), np.asarray(valid_u))
    assert np.array_equal(np.asarray(bits_s), np.asarray(bits_u))
    for c in range(C):
        i = int(np.argmax(np.asarray(valid_u)[c]))
        assert np.array_equal(np.asarray(bits_u)[c, i],
                              np.asarray(pays)[c]), c
