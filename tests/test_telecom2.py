"""Equalizer, LFSR/PRBS, spread spectrum, analog AM/FM tests."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.models import waveform as WF
from libtsd_jax.models import analog as AN
from libtsd_jax.models import spread as SP
from libtsd_jax.models import lfsr as LF
from libtsd_jax.models.equalizer import LmsEqualizer, zfe_design, \
    convolution_matrix
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.ops.filter_rt import fir_filter


def test_convolution_matrix():
    h = np.array([1.0, 0.5, 0.25])
    x = np.random.default_rng(0).standard_normal(10)
    C = convolution_matrix(h, 10)
    assert np.allclose(C @ x, np.convolve(h, x))


def test_zfe_inverts_channel():
    h = np.array([1.0, 0.4, 0.2])
    g = zfe_design(h, 31)
    combined = np.convolve(h, g)
    peak = np.argmax(np.abs(combined))
    others = np.delete(np.abs(combined), peak)
    assert abs(combined[peak]) > 0.95
    assert others.max() < 0.1


def test_lms_equalizer_converges():
    rng = np.random.default_rng(1)
    wf = WF.wf_qpsk()
    bits = randbits(jax.random.PRNGKey(2), 2 * 4000)
    s = wf.make_symbols(bits)
    # mild ISI channel
    h = np.array([1.0, 0.3 + 0.2j, 0.1])
    x = fir_filter(h, s)
    eq = LmsEqualizer(wf=wf, structure="ffe", errf="dec", alpha=0.01, N1=11)
    _, (y, err, act) = eq.step(eq.init(), x)
    err = np.asarray(err)
    # error must decrease substantially after convergence
    assert err[-500:].mean() < 0.5 * err[:500].mean()
    # final decisions near the constellation
    tail = np.asarray(y)[-500:]
    d = np.abs(tail[:, None] - np.asarray(wf.symbols)[None, :]).min(axis=1)
    assert d.mean() < 0.2


def test_lms_cma():
    rng = np.random.default_rng(3)
    wf = WF.wf_qpsk()
    bits = randbits(jax.random.PRNGKey(4), 2 * 4000)
    s = wf.make_symbols(bits)
    h = np.array([1.0, 0.25])
    x = fir_filter(h, s)
    eq = LmsEqualizer(wf=wf, structure="ffe", errf="cma", alpha=0.005, N1=11)
    _, (y, err, act) = eq.step(eq.init(), x)
    tail = np.abs(np.asarray(y)[-500:])
    # CMA restores constant modulus
    assert abs(tail.mean() - 1.0) < 0.1
    assert tail.std() < 0.15


def test_lms_dfe_cma_converges():
    """Regression: the CMA+DFE feedback-tap update used the partial
    feedback sum (zero at init -> taps could never bootstrap); with the
    correct Wirtinger gradient the combination converges."""
    wf = WF.wf_qpsk()
    bits = randbits(jax.random.PRNGKey(8), 2 * 6000)
    s = wf.make_symbols(bits)
    h = np.array([1.0, 0.4, 0.2])
    x = fir_filter(h, s)
    eq = LmsEqualizer(wf=wf, structure="dfe", errf="cma", alpha=0.003,
                      N1=11, N2=5)
    _, (y, err, act) = eq.step(eq.init(), x)
    tail = np.abs(np.asarray(y)[-800:])
    assert abs(tail.mean() - 1.0) < 0.12, tail.mean()
    assert tail.std() < 0.2, tail.std()


def test_lms_nonminimum_phase_channel():
    """Regression: the FFE init spike now sits at the CENTER, giving the
    equalizer precursor reach — a non-minimum-phase channel (strong
    precursor) must converge under DD-LMS."""
    wf = WF.wf_qpsk()
    bits = randbits(jax.random.PRNGKey(9), 2 * 6000)
    s = wf.make_symbols(bits)
    h = np.array([0.35, 1.0])          # precursor-dominant
    x = fir_filter(h, s)
    eq = LmsEqualizer(wf=wf, structure="ffe", errf="dec", alpha=0.01,
                      N1=15)
    _, (y, err, act) = eq.step(eq.init(), x)
    err = np.asarray(err)
    assert err[-800:].mean() < 0.5 * err[:800].mean()
    tail = np.asarray(y)[-800:]
    d = np.abs(tail[:, None] - np.asarray(wf.symbols)[None, :]).min(axis=1)
    assert d.mean() < 0.25, d.mean()


def test_propagation_channel_random_delay_jits():
    """Regression: clock_delay=-1 (randomized) crashed under jit with a
    tracer concretization error."""
    from libtsd_jax.models.channel import ChannelConfig, propagation_channel
    x = jnp.asarray(np.random.default_rng(0).standard_normal(512)
                    + 1j * np.random.default_rng(1).standard_normal(512),
                    jnp.complex64)
    cfg = ChannelConfig(Eb_N0=20.0, clock_delay=-1.0)
    y = jax.jit(lambda k, v: propagation_channel(k, v, cfg))(
        jax.random.PRNGKey(3), x)
    assert y.shape == x.shape and np.isfinite(np.asarray(y)).all()


def test_lfsr_mls_properties():
    for reglen in [4, 5, 7]:
        m = (1 << reglen) - 1
        c = np.asarray(LF.mls_code(reglen), np.float64) * 2 - 1
        assert len(c) == m
        # MLS autocorrelation: peak m, off-peak -1
        for lag in [1, 3, m // 2]:
            r = np.sum(c * np.roll(c, lag))
            assert abs(r - (-1)) < 1e-9, (reglen, lag, r)


def test_lfsr_stream_period():
    reglen = 5
    m = (1 << reglen) - 1
    bits = np.asarray(LF.lfsr_bits(reglen, 3 * m, seed=1))
    assert np.array_equal(bits[:m], bits[m:2 * m])
    assert bits[:m].sum() in (m // 2, m // 2 + 1)  # balanced


def test_prbs_check_detects_errors():
    reglen = 9
    bits = np.asarray(LF.lfsr_bits(reglen, 2000, seed=5))
    ber, errs = LF.prbs_check(jnp.asarray(bits), reglen)
    assert errs == 0
    # flip some bits
    b2 = bits.copy()
    b2[500] ^= 1
    b2[900] ^= 1
    ber2, errs2 = LF.prbs_check(jnp.asarray(b2), reglen)
    # each flipped bit causes 1 direct + popcount(pol) feedback errors
    assert errs2 >= 2


def test_barker():
    c = np.asarray(LF.barker_code(13))
    r = np.correlate(c, c, "full")
    peak = r[12]
    side = np.abs(np.delete(r, 12)).max()
    assert peak == 13 and side <= 1


def test_dsss_roundtrip():
    wf = WF.wf_bpsk()
    bits = randbits(jax.random.PRNGKey(5), 100)
    s = wf.make_symbols(bits)
    chips = np.asarray(LF.mls_code(5), np.float32) * 2 - 1  # 31 chips
    y = SP.dsss_modulate(s, jnp.asarray(chips), osf_in=1)
    assert y.shape[0] == 100 * 31
    z = SP.dsss_demodulate(y, jnp.asarray(chips), osf_in=1)
    rx = wf.decode_symbols(z)
    assert np.array_equal(np.asarray(rx)[:100], np.asarray(bits))


def test_fhss_occupies_hopping_freqs():
    x = jnp.ones(1024, jnp.complex64)
    hop = jnp.asarray([0, 3, 2, 6])
    y = SP.fhss_modulate(x, hop, slot_len=256, nfreqs=8)
    # each slot is a pure tone at hop/8
    for i, h in enumerate([0, 3, 2, 6]):
        seg = np.asarray(y[i * 256:(i + 1) * 256])
        f = np.angle(seg[1:] * np.conj(seg[:-1])).mean() / (2 * np.pi)
        f = f % 1.0
        assert abs(f - h / 8.0) < 1e-3, (i, f)


def test_transpo_bb():
    cfg = SP.TranspoBBConfig(fi=0.2)
    t = SP.TranspoBB.create(cfg, real_input=True)
    n = 2048
    fm = 0.02  # message
    x = jnp.cos(2 * jnp.pi * (0.2 + fm) * jnp.arange(n)).astype(jnp.float32)
    _, y = t.step(t.init(), x)
    y = np.asarray(y)[200:]
    # downconverted tone at fm
    f = np.angle(y[1:] * np.conj(y[:-1])).mean() / (2 * np.pi)
    assert abs(f - fm) < 2e-3


def test_fm_mod_demod():
    n = 4096
    audio = jnp.sin(2 * jnp.pi * 0.01 * jnp.arange(n)).astype(jnp.float32)
    x = AN.fm_modulate(audio, deviation=0.1)
    y = np.asarray(AN.fm_demodulate(x, deviation=0.1))
    # recovered audio matches (skip transient)
    err = np.abs(y[10:] - np.asarray(audio)[10:])
    assert err.max() < 0.02


def test_fm_discriminator_tone():
    f0 = 0.07
    x = jnp.exp(2j * jnp.pi * f0 * jnp.arange(512)).astype(jnp.complex64)
    d = np.asarray(AN.fm_discriminator(x))
    assert np.allclose(d[1:], 2 * np.pi * f0, atol=1e-4)


def test_am_dsb_roundtrip():
    n = 8192
    audio = jnp.sin(2 * jnp.pi * 0.005 * jnp.arange(n)).astype(jnp.float32)
    cfg = AN.AMConfig(mode="dsb", index=0.7, f_rf=0.25)
    x = AN.am_modulate(audio, cfg)
    y = np.asarray(AN.am_demodulate(x, cfg, audio_cut=0.02))
    a = np.asarray(audio)
    # compensate the demodulator group delay (hilbert 255//2=127 + audio
    # lowpass 31) then compare
    d = 127 + 31
    seg, ref = y[1000 + d:-1000], a[1000:-1000 - d]
    seg = seg / np.abs(seg).max()
    corr = np.corrcoef(seg, ref)[0, 1]
    assert corr > 0.99, corr


def test_am_ssb_single_sided():
    n = 4096
    audio = jnp.sin(2 * jnp.pi * 0.03 * jnp.arange(n)).astype(jnp.float32)
    x = AN.am_modulate(audio, AN.AMConfig(mode="usb", f_rf=0.2))
    X = np.abs(np.fft.fft(np.asarray(x)))
    f = np.fft.fftfreq(n)
    upper = X[(f > 0.21) & (f < 0.26)].max()
    lower = X[(f > 0.14) & (f < 0.19)].max()
    # single-sided, with the REFERENCE's label convention: its "USB" mode
    # computes Re(z*conj(carrier)) which lands the audio BELOW the carrier
    # (analogique.cc:121-126; see am_modulate docstring) — we pin the
    # binary's behavior, so mode="usb" -> lower sideband only
    assert lower > 10 * upper
    x = AN.am_modulate(audio, AN.AMConfig(mode="lsb", f_rf=0.2))
    X = np.abs(np.fft.fft(np.asarray(x)))
    upper = X[(f > 0.21) & (f < 0.26)].max()
    lower = X[(f > 0.14) & (f < 0.19)].max()
    assert upper > 10 * lower


def test_fm_broadcast_stereo_separation():
    """Broadcast FM stereo multiplex -> (L, R): the pilot-PLL subcarrier
    regeneration must separate the channels (>20 dB).  The reference's
    own stereo path is unusable (three documented defects — see
    models/analog.py fm_broadcast_demodulate); this pins our working
    design."""
    fe = 250e3
    n = 1 << 15
    t = np.arange(n)
    L = 0.8 * np.sin(2 * np.pi * 1000 / fe * t).astype(np.float32)
    R = 0.6 * np.sin(2 * np.pi * 2500 / fe * t).astype(np.float32)
    x = AN.fm_broadcast_multiplex(jnp.asarray(L), jnp.asarray(R), fe)
    l, r = AN.fm_broadcast_demodulate(x, fe)
    l, r = np.asarray(l)[8000:], np.asarray(r)[8000:]

    def corr(a, b):
        a = a - a.mean()
        b = b - b.mean()
        return float(np.max(np.abs(np.correlate(a, b, "same")))
                     / (np.linalg.norm(a) * np.linalg.norm(b)))

    assert corr(l, L[8000:]) > 0.99
    assert corr(r, R[8000:]) > 0.99
    assert corr(l, R[8000:]) < 0.1      # >20 dB separation
    assert corr(r, L[8000:]) < 0.1


def test_matzner_tracker_clamp_mode():
    """clamp=True floors S at 0 on noise-dominated input, where the
    reference-parity default emits NaN indefinitely (2*e2^2 - e4 is
    zero-mean for complex Gaussian noise)."""
    import numpy as np
    from libtsd_jax.models.snr import MatznerTracker
    key = jax.random.PRNGKey(0)
    nz = (jax.random.normal(key, (4096,)) +
          1j * jax.random.normal(jax.random.PRNGKey(1), (4096,)))
    tr = MatznerTracker(gamma=0.1)
    _, (S, _) = jax.jit(tr.step)(tr.init(), nz)
    assert np.isnan(np.asarray(S)[100:]).any()   # the documented default
    trc = MatznerTracker(gamma=0.1, clamp=True)
    _, (Sc, Nc) = jax.jit(trc.step)(trc.init(), nz)
    assert not np.isnan(np.asarray(Sc)).any()
    assert not np.isnan(np.asarray(Nc)).any()


def test_cmp_bits_psk_degenerate_returns_real_counts():
    """All-rotations-BER-1.0 input must return the actual measurement,
    not the 2^30 sentinel."""
    import numpy as np
    from libtsd_jax.models.ber import cmp_bits_psk
    tx = jnp.asarray(np.zeros(32, np.int8))
    rx = jnp.asarray(np.ones(32, np.int8))
    ber, errs, lag = cmp_bits_psk(tx, rx, k=1, max_lag=4)
    assert errs <= 32, (ber, errs, lag)


def test_fsk_gen_samples_matches_modulator_scaling():
    """gen_samples' FSK deviation must be normalized by the CONSTELLATION
    extreme, not the per-call data max: a block using only inner 4-FSK
    levels must NOT stretch to full deviation."""
    import numpy as np
    from libtsd_jax.models import waveform as WF
    from libtsd_jax.models.demod import quadrature_discriminator
    wf = WF.wf_fsk(4, index=1.0, shaping=WF.PulseShape.nrz())
    osf = 8
    # symbols 1 and 2 are the INNER +-1/3 levels of 4-FSK
    bits_inner = jnp.asarray(np.tile([0, 1, 1, 0], 32), jnp.int32)
    y, _ = wf.gen_samples(bits_inner, osf)
    d = np.asarray(quadrature_discriminator(y))
    # steady-state |inst freq| must be ~1/3 of the max deviation
    om_max = np.pi * 1.0 / osf
    mid = np.abs(d[5 * osf:-5 * osf])
    assert mid.max() < 0.5 * om_max, (mid.max(), om_max)
