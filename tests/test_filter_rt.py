"""Streaming filter runtime tests: Toeplitz-matmul FIR vs np.convolve,
IIR/SOS vs scipy.lfilter/sosfilt, streaming == one-shot equivalence."""
import numpy as np
import jax.numpy as jnp
import pytest
import scipy.signal as sps

from libtsd_jax.block import stream
from libtsd_jax.ops import filter_rt as FR
from libtsd_jax.ops import fir_design as FD
from libtsd_jax.ops import iir_design as ID
from libtsd_jax.utils.testing import check_max_error

rng = np.random.default_rng(42)


@pytest.mark.parametrize("K,n", [(7, 100), (31, 500), (256, 2048), (129, 300)])
def test_fir_matches_convolve(K, n):
    h = rng.standard_normal(K)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(FR.fir_filter(h, x))
    expected = np.convolve(x, h)[:n]
    check_max_error(y, expected, 2e-3 * np.abs(expected).max())


def test_fir_complex_signal():
    h = rng.standard_normal(64)
    x = (rng.standard_normal(512) + 1j * rng.standard_normal(512)).astype(np.complex64)
    y = np.asarray(FR.fir_filter(h, x))
    expected = np.convolve(x, h)[:512]
    check_max_error(y, expected, 5e-3)


def test_fir_complex_taps():
    h = rng.standard_normal(33) + 1j * rng.standard_normal(33)
    x = (rng.standard_normal(256) + 1j * rng.standard_normal(256)).astype(np.complex64)
    y = np.asarray(FR.fir_filter(h, x))
    expected = np.convolve(x, h)[:256]
    check_max_error(y, expected, 1e-2)


def test_fir_batched():
    h = rng.standard_normal(31)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    y = np.asarray(FR.fir_filter(h, x))
    for c in range(4):
        expected = np.convolve(x[c], h)[:300]
        check_max_error(y[c], expected, 2e-3)


def test_fir_streaming_equals_oneshot():
    h = rng.standard_normal(65)
    x = rng.standard_normal(1024).astype(np.float32)
    blk = FR.Fir.create(h)
    _, y_stream = stream(blk, jnp.asarray(x), 128)
    y_oneshot = np.asarray(FR.fir_filter(h, x))
    check_max_error(np.asarray(y_stream), y_oneshot, 1e-4)


def test_delay_line():
    blk = FR.DelayLine(d=5)
    x = jnp.arange(1.0, 21.0)
    _, y = stream(blk, x, 10)
    y = np.asarray(y)
    assert np.allclose(y[5:], np.arange(1.0, 16.0))
    assert np.allclose(y[:5], 0)


def test_decimator_streaming():
    blk = FR.Decimator(R=4)
    x = jnp.arange(64.0)
    _, y = stream(blk, x, 16)
    assert np.allclose(np.asarray(y), np.arange(0, 64, 4))


@pytest.mark.parametrize("K,R", [(16, 2), (33, 4), (64, 8)])
def test_fir_decim(K, R):
    h = rng.standard_normal(K)
    x = rng.standard_normal(512).astype(np.float32)
    blk = FR.FirDecim.create(h, R)
    _, y = blk.step(blk.init_for(jnp.asarray(x)), jnp.asarray(x))
    full = np.convolve(x, h)[:512]
    expected = full[::R]
    check_max_error(np.asarray(y), expected, 2e-3)


def test_fir_decim_streaming():
    h = rng.standard_normal(33)
    R = 4
    x = rng.standard_normal(1024).astype(np.float32)
    blk = FR.FirDecim.create(h, R)
    _, ys = stream(blk, jnp.asarray(x), 64)
    full = np.convolve(x, h)[:1024][::R]
    check_max_error(np.asarray(ys), full, 2e-3)


def test_moving_average():
    K = 8
    blk = FR.MovingAverage(K=K)
    x = rng.standard_normal(256).astype(np.float32)
    _, y = blk.step(blk.init_for(jnp.asarray(x)), jnp.asarray(x))
    expected = np.convolve(x, np.ones(K) / K)[:256]
    check_max_error(np.asarray(y), expected, 1e-4)


def test_exp_smoother():
    g = 0.1
    blk = FR.ExpSmoother.create(g)
    x = rng.standard_normal(200).astype(np.float32)
    _, y = blk.step(blk.init(), jnp.asarray(x))
    expected = sps.lfilter([g], [1, -(1 - g)], x)
    check_max_error(np.asarray(y), expected, 1e-4)


def test_exp_smoother_streaming():
    g = 0.03
    blk = FR.ExpSmoother.create(g)
    x = rng.standard_normal(512).astype(np.float32)
    _, ys = stream(blk, jnp.asarray(x), 64)
    expected = sps.lfilter([g], [1, -(1 - g)], x)
    check_max_error(np.asarray(ys), expected, 1e-4)


def test_dc_blocker():
    blk = FR.DcBlocker.create(0.01)
    n = 2048
    x = (np.sin(2 * np.pi * 0.1 * np.arange(n)) + 3.0).astype(np.float32)
    _, y = stream(blk, jnp.asarray(x), 256)
    y = np.asarray(y)
    # steady-state mean ~ 0, AC preserved
    assert abs(y[1024:].mean()) < 0.05
    assert abs(np.std(y[1024:]) - np.sqrt(0.5)) < 0.05


def test_iir_matches_lfilter():
    b, a = ID.design_biquad(ID.BiquadSpec("lp", 0.1, 0.9))
    x = rng.standard_normal(300).astype(np.float32)
    blk = FR.Iir.create(b, a)
    _, y = blk.step(blk.init_for(jnp.asarray(x)), jnp.asarray(x))
    expected = sps.lfilter(b, a, x)
    check_max_error(np.asarray(y), expected, 1e-3)


def test_iir_first_order_fast_path():
    b, a = ID.design_lexp(0.03)
    x = rng.standard_normal(512).astype(np.float32)
    blk = FR.Iir.create(b, a)
    _, y = blk.step(blk.init_for(jnp.asarray(x)), jnp.asarray(x))
    expected = sps.lfilter(b, a, x)
    check_max_error(np.asarray(y), expected, 1e-3)
    # streaming
    _, ys = stream(blk, jnp.asarray(x), 64)
    check_max_error(np.asarray(ys), expected, 1e-3)


def test_iir_streaming():
    h = ID.design_iir(4, "lp", "butt", 0.1)
    b, a = h.to_ba()
    x = rng.standard_normal(1024).astype(np.float32)
    blk = FR.Iir.create(b, a)
    _, ys = stream(blk, jnp.asarray(x), 128)
    expected = sps.lfilter(b, a, x)
    check_max_error(np.asarray(ys), expected, 2e-3)


def test_iir_frame_matches_lfilter():
    """Frame-parallel IIR (block state-space over 128-sample frames:
    Toeplitz matmul + log-depth k-dim state scan) equals lfilter."""
    b, a = sps.butter(4, 0.2)
    x = rng.standard_normal(1024).astype(np.float32)
    ref = sps.lfilter(b, a, x.astype(np.float64))
    y = np.asarray(FR.iir_filter(b, a, jnp.asarray(x)))
    check_max_error(y, ref, 1e-4)
    # ragged length (internal pad) + batch axes
    y2 = np.asarray(FR.iir_filter(b, a, jnp.asarray(x[:1000])))
    check_max_error(y2, ref[:1000], 1e-4)
    xb = rng.standard_normal((3, 256)).astype(np.float32)
    yb = np.asarray(FR.iir_filter(b, a, jnp.asarray(xb)))
    check_max_error(yb, sps.lfilter(b, a, xb.astype(np.float64), axis=-1),
                    1e-3)


def test_iir_frame_streaming_and_complex():
    b, a = sps.cheby2(3, 40, 0.3)
    blk = FR.IirFrame.create(b, a)
    x = rng.standard_normal(1024).astype(np.float32)
    ref = sps.lfilter(b, a, x.astype(np.float64))
    # two steps == one shot == lfilter (state carried across frames)
    s1, y1 = blk.step(blk.init_for(jnp.asarray(x)), jnp.asarray(x[:512]))
    _, y2 = blk.step(s1, jnp.asarray(x[512:]))
    check_max_error(np.concatenate([np.asarray(y1), np.asarray(y2)]),
                    ref, 1e-4)
    xc = (x[:512] + 1j * x[512:]).astype(np.complex64)
    _, yc = blk.step(blk.init_for(jnp.asarray(xc)), jnp.asarray(xc))
    check_max_error(np.asarray(yc), sps.lfilter(b, a, xc.astype(np.complex128)),
                    1e-4)


def test_iir_frame_high_order_routes_sos():
    """order > 4 one-shot routes through sos_frame_chain (an expanded
    high-order TF is ill-conditioned in fp32 — measured 6e-2 direct vs
    1e-5 as SOS for this filter)."""
    b, a = sps.ellip(6, 0.5, 60, 0.15)
    x = rng.standard_normal(1000).astype(np.float32)
    ref = sps.lfilter(b, a, x.astype(np.float64))
    y = np.asarray(FR.iir_filter(b, a, jnp.asarray(x)))
    check_max_error(y, ref, 1e-4)


def test_filtfilt_and_filter_signal_iir():
    """filtrer/filtfilt accept IIR designs too (Design with an FRat,
    filtrage.hpp:1684-1782) — routed through the frame-parallel runtime."""
    b, a = sps.butter(4, 0.2)
    x = rng.standard_normal(700).astype(np.float32)
    y = np.asarray(FR.filter_signal((b, a), jnp.asarray(x)))
    check_max_error(y, sps.lfilter(b, a, x.astype(np.float64)), 1e-4)
    yz = np.asarray(FR.filtfilt((b, a), jnp.asarray(x)))
    # oracle = explicit forward/backward lfilter with zero initial state
    # (the reference's filtfilt semantics; scipy's filtfilt differs — it
    # edge-matches initial conditions)
    fwd = sps.lfilter(b, a, x.astype(np.float64))
    ref_zp = sps.lfilter(b, a, fwd[::-1])[::-1]
    check_max_error(yz, ref_zp, 1e-3)
    # ZPK design object
    h = ID.design_iir(4, "lp", "butt", 0.2)
    y2 = np.asarray(FR.filter_signal(h, jnp.asarray(x)))
    bb, aa = h.to_ba()
    check_max_error(y2, sps.lfilter(bb, aa, x.astype(np.float64)), 1e-4)


def test_iir_frame_degenerate_numerators():
    """Leading-zero numerator = pure delay factor (commuted to an output
    shift); short numerator; all-zero numerator."""
    x = rng.standard_normal(600).astype(np.float32)
    _, a6 = sps.butter(6, 0.2)
    for b in (np.array([0.0, 0.0, 1.0, 0.5]), np.array([1.0, 0.3])):
        ref = sps.lfilter(b, a6, x.astype(np.float64))
        y = np.asarray(FR.iir_filter(b, a6, jnp.asarray(x)))
        check_max_error(y, ref, 1e-4)
    assert not np.any(np.asarray(FR.iir_filter(np.zeros(3), a6,
                                               jnp.asarray(x))))


def test_sos_frame_chain_matches_sosfilt():
    sos = sps.cheby1(8, 1, 0.05, output="sos")
    x = rng.standard_normal(1024).astype(np.float32)
    ch = FR.sos_frame_chain(sos)
    _, y = ch.step(ch.init(), jnp.asarray(x))
    check_max_error(np.asarray(y), sps.sosfilt(sos, x.astype(np.float64)),
                    1e-4)
    # batched input: Chain.init_for delegates to members
    xb = rng.standard_normal((3, 256)).astype(np.float32)
    _, yb = ch.step(ch.init_for(jnp.asarray(xb)), jnp.asarray(xb))
    check_max_error(np.asarray(yb),
                    sps.sosfilt(sos, xb.astype(np.float64), axis=-1), 1e-4)


def test_iir_filter_order0_and_validation():
    x = rng.standard_normal(256).astype(np.float32)
    y = np.asarray(FR.iir_filter([2.0], [1.0], jnp.asarray(x)))
    check_max_error(y, 2.0 * x, 1e-6)
    # pure delay numerator over unit denominator
    y2 = np.asarray(FR.iir_filter([0.0, 1.5], [1.0], jnp.asarray(x)))
    check_max_error(y2[1:], 1.5 * x[:-1], 1e-6)
    assert y2[0] == 0.0
    import pytest
    with pytest.raises(ValueError):
        FR.IirFrame.create([2.0], [1.0])


def test_sos_matches_sosfilt():
    h = ID.design_iir(6, "lp", "ellip", 0.15, rp=0.5, rs=50)
    sos, k = ID.zpk_to_sos(h)
    x = rng.standard_normal(500).astype(np.float32)
    blk = FR.Sos.create(sos, k)
    _, y = blk.step(blk.init_for(jnp.asarray(x)), jnp.asarray(x))
    sos_s = sos.copy()
    sos_s[0, :3] *= k
    expected = sps.sosfilt(sos_s, x)
    check_max_error(np.asarray(y), expected, 2e-3)


def test_sos_streaming():
    h = ID.design_iir(5, "hp", "butt", 0.05)
    sos, k = ID.zpk_to_sos(h)
    x = rng.standard_normal(1024).astype(np.float32)
    blk = FR.Sos.create(sos, k)
    _, ys = stream(blk, jnp.asarray(x), 128)
    sos_s = sos.copy()
    sos_s[0, :3] *= k
    expected = sps.sosfilt(sos_s, x)
    check_max_error(np.asarray(ys), expected, 2e-3)


@pytest.mark.parametrize("M,n", [(31, 1000), (256, 4096)])
def test_ola_fft_matches_direct(M, n):
    h = rng.standard_normal(M)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(FR.filter_signal(h, x, mode="fft"))
    expected = np.convolve(x, h)[:n]
    check_max_error(y, expected, 5e-3)


def test_ola_fft_complex():
    h = rng.standard_normal(64)
    x = (rng.standard_normal(2048) + 1j * rng.standard_normal(2048)).astype(np.complex64)
    y = np.asarray(FR.filter_signal(h, x, mode="fft"))
    expected = np.convolve(x, h)[:2048]
    check_max_error(y, expected, 5e-3)


def test_ola_streaming_equals_oneshot():
    h = rng.standard_normal(100)
    blk = FR.OlaFft.create(h)
    n = blk.Ne * 4
    x = rng.standard_normal(n).astype(np.float32)
    _, ys = stream(blk, jnp.asarray(x), blk.Ne)
    expected = np.convolve(x, h)[:n]
    check_max_error(np.asarray(ys), expected, 5e-3)


def test_filtfilt_zero_phase():
    h = FD.fir_lowpass(31, 0.1)
    n = 512
    t = np.arange(n)
    x = np.sin(2 * np.pi * 0.02 * t).astype(np.float32)
    y = np.asarray(FR.filtfilt(h, x))
    # zero phase: peak positions preserved (compare interior)
    xi, yi = x[100:400], y[100:400]
    lag = np.argmax(np.correlate(yi, xi, "full")) - (len(xi) - 1)
    assert lag == 0


@pytest.mark.parametrize("B", [7, 16, 33, 100, 257])
def test_stream_tail_safe(B):
    """stream() must equal the one-shot run for ANY block size, including
    ones that don't divide len(x) — the remainder is processed, not
    dropped (parity: tampon keeps the tail, tsd.cc:303-386)."""
    from libtsd_jax.block import stream
    h = FD.fir_lowpass(31, 0.2)
    blk = FR.Fir.create(h)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(501),
                    jnp.float32)
    _, y_stream = stream(blk, x, B)
    _, y_once = blk.step(blk.init_for(x), x)
    assert y_stream.shape == y_once.shape
    assert np.max(np.abs(np.asarray(y_stream) - np.asarray(y_once))) < 1e-5


def test_single_tap_blocks_keep_state_bounded():
    """K=1 degenerate: the [-(K-1):] slice was [-0:] (everything) and the
    carried state grew by n every step."""
    from libtsd_jax.ops.filter_rt import Fir, MovingAverage
    f = Fir.create([2.0])
    st = f.init()
    for _ in range(3):
        st, y = f.step(st, jnp.arange(8.0))
    assert st.shape == (0,) and y.shape == (8,)
    assert np.allclose(np.asarray(y), 2.0 * np.arange(8.0))
    ma = MovingAverage(K=1)
    st = ma.init()
    for _ in range(3):
        st, y = ma.step(st, jnp.arange(4.0))
    assert st.shape == (0,) and y.shape == (4,)


def test_dc_blocker_streaming_matches_oneshot():
    """The scan seed must reproduce y[0] = r*(xd[0] + y_prev) at block
    boundaries (a y_prev/r seed left a (1-r)*y_prev discontinuity)."""
    from libtsd_jax.ops.filter_rt import DcBlocker
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(512), jnp.float32)
    dc = DcBlocker.create(0.02)
    _, y1 = dc.step(dc.init(), x)
    st = dc.init()
    parts = []
    for lo, hi in ((0, 100), (100, 357), (357, 512)):
        st, yb = dc.step(st, x[lo:hi])
        parts.append(np.asarray(yb))
    y2 = np.concatenate(parts)
    assert np.max(np.abs(np.asarray(y1) - y2)) < 1e-6
    # and the recurrence IS the reference's y = r*((x-xp) + yp)
    r = float(dc.r)
    xp = yp = 0.0
    ref = []
    for v in np.asarray(x[:50], np.float64):
        yp = r * ((v - xp) + yp)
        xp = v
        ref.append(yp)
    assert np.max(np.abs(np.asarray(y1[:50]) - np.asarray(ref))) < 1e-5


def test_olafft_complex_taps_real_input_keeps_imag():
    """A complex (analytic/matched) filter on a REAL signal must return
    the complex response."""
    from libtsd_jax.ops.filter_rt import OlaFft, fir_filter
    rng = np.random.default_rng(1)
    h = (rng.standard_normal(31)
         + 1j * rng.standard_normal(31)).astype(np.complex64)
    o = OlaFft.create(h)
    x = jnp.asarray(rng.standard_normal(4 * o.Ne), jnp.float32)
    _, y = o.step(o.init_for(x), x)
    assert jnp.iscomplexobj(y)
    ref = fir_filter(h, x)
    assert float(jnp.max(jnp.abs(y - ref))) < 1e-4


def test_resample_trims_padding_tail():
    """Large-q residual ratios must not hand the caller resampled
    zero-padding as signal."""
    from libtsd_jax.ops.resample import resample
    x = jnp.asarray(np.random.default_rng(2).standard_normal(1000),
                    jnp.float32)
    y = resample(x, np.pi / 2)
    assert abs(y.shape[-1] - round(1000 * np.pi / 2)) <= 3, y.shape


# ---------------------------------------------- OlaFft, Fir, IIR: XLA paths

@pytest.mark.parametrize("taps,sig", [("real", "real"), ("real", "complex"),
                                      ("complex", "real"),
                                      ("complex", "complex")])
def test_olafft_tap_and_signal_kinds(taps, sig):
    """OlaFft (cuFFT overlap-add on the GPU) vs direct convolution for
    real and complex taps on real and complex signals."""
    r = np.random.default_rng(5)
    h = r.standard_normal(129)
    if taps == "complex":
        h = h + 1j * r.standard_normal(129)
    blk = FR.OlaFft.create(h)
    x = r.standard_normal(4 * blk.Ne).astype(np.float32)
    if sig == "complex":
        x = (x + 1j * r.standard_normal(x.shape[0])).astype(np.complex64)
    _, y = blk.step(blk.init_for(jnp.asarray(x)), jnp.asarray(x))
    assert np.iscomplexobj(np.asarray(y)) == (taps == "complex"
                                              or sig == "complex")
    exp = np.convolve(x, h)[:x.shape[0]]
    assert np.abs(np.asarray(y) - exp).max() < 1e-4 * np.abs(exp).max()


@pytest.mark.parametrize("Ne", [64, 256, 1000])
def test_olafft_explicit_ne_stream_continuation(Ne):
    """An explicit block size is honoured, and blocks of several Ne
    continue the stream exactly (the carried overlap-add tail)."""
    r = np.random.default_rng(Ne)
    h = r.standard_normal(100)
    blk = FR.OlaFft.create(h, Ne=Ne)
    assert blk.Ne == Ne and blk.Nf >= Ne + 99
    x = r.standard_normal(6 * Ne).astype(np.float32)
    st = blk.init_for(jnp.asarray(x))
    outs = []
    for a, b in ((0, Ne), (Ne, 3 * Ne), (3 * Ne, 6 * Ne)):
        st, y = blk.step(st, jnp.asarray(x[a:b]))
        outs.append(np.asarray(y))
    exp = np.convolve(x, h)[:6 * Ne]
    got = np.concatenate(outs)
    assert np.abs(got - exp).max() < 1e-4 * np.abs(exp).max()


@pytest.mark.parametrize("K", [1, 2, 3, 127, 128, 129])
def test_fir_short_and_block_edge_taps(K):
    """Toeplitz FIR at tap counts around the 128-sample block edge."""
    r = np.random.default_rng(K)
    h = r.standard_normal(K)
    x = r.standard_normal(700).astype(np.float32)
    y = np.asarray(FR.fir_filter(h, jnp.asarray(x)))
    exp = np.convolve(x, h)[:700]
    assert np.abs(y - exp).max() < 1e-4 * max(np.abs(exp).max(), 1.0)


@pytest.mark.parametrize("shape", [(3, 512), (2, 2, 256)])
def test_fir_batched_streaming(shape):
    """Batched channels stream in two blocks exactly like one shot."""
    r = np.random.default_rng(1)
    h = r.standard_normal(40)
    x = r.standard_normal(shape).astype(np.float32)
    blk = FR.Fir.create(h)
    n = shape[-1]
    st = blk.init_for(jnp.asarray(x))
    st, y1 = blk.step(st, jnp.asarray(x[..., :n // 2]))
    st, y2 = blk.step(st, jnp.asarray(x[..., n // 2:]))
    got = np.concatenate([np.asarray(y1), np.asarray(y2)], axis=-1)
    exp = np.apply_along_axis(lambda v: np.convolve(v, h)[:n], -1, x)
    assert np.abs(got - exp).max() < 1e-4 * np.abs(exp).max()


@pytest.mark.parametrize("design", ["butter4", "cheby8", "ellip6"])
def test_sos_frame_chain_streaming_vs_sosfilt(design):
    """sos_frame_chain (frame-parallel IIR) vs scipy.sosfilt, with the
    state carried across three uneven blocks."""
    sos = {"butter4": lambda: sps.butter(4, 0.1, output="sos"),
           "cheby8": lambda: sps.cheby1(8, 1, 0.05, output="sos"),
           "ellip6": lambda: sps.ellip(6, 0.5, 40, 0.2, output="sos")}[
               design]()
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 1536)).astype(np.float32)
    ch = FR.sos_frame_chain(sos)
    st = ch.init_for(jnp.asarray(x[:, :256]))
    outs = []
    for a, b in ((0, 256), (256, 1024), (1024, 1536)):
        st, y = ch.step(st, jnp.asarray(x[:, a:b]))
        outs.append(np.asarray(y))
    exp = sps.sosfilt(sos, x.astype(np.float64), axis=-1)
    check_max_error(np.concatenate(outs, axis=-1), exp, 1e-4)
