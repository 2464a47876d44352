"""Decision-directed demod, IMU EKF, channelizer, rt-spectrum, filter
analysis tests."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.models import waveform as WF, channel as CH, ber as BER
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.models.modulator import ModConfig, Modulator
from libtsd_jax.models.demod_dec import DecisionDemod, DecDemodConfig
from libtsd_jax.models.imu import ImuModel, imu_simulate, imu_ekf
from libtsd_jax.models.channelizer import Channelizer, channelize
from libtsd_jax.ops.spectrum import RtSpectrum, SpectrumConfig
from libtsd_jax.ops import filter_analysis as FA
from libtsd_jax.ops import fir_design as FD
from libtsd_jax.ops import iir_design as ID
from libtsd_jax.ops.fft import delay_signal


def test_decision_demod_impaired():
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(0), 2 * 3000)
    x, _ = mod.modulate(bits)
    x = delay_signal(x, 1.7)
    n = x.shape[0]
    x = x * jnp.exp(2j * jnp.pi * 2e-4 * jnp.arange(n)).astype(jnp.complex64)
    x = CH.awgn(jax.random.PRNGKey(1), x, 15.0, osf=4, k_bits=2)
    dd = DecisionDemod.create(wf, DecDemodConfig(osf=4))
    _, (rb, syms, mask, bmask) = dd.step(dd.init(), x)
    rbn = np.asarray(rb)[np.asarray(bmask)]
    ber, errs, lag = BER.cmp_bits_psk(bits[2 * 800:],
                                      jnp.asarray(rbn[2 * 800:]), 2,
                                      max_lag=64)
    assert ber < 0.01, (ber, errs)


def test_decision_demod_16qam_agc():
    # AGC must fix a 2x amplitude error for QAM decisions to work
    wf = WF.wf_qam(16, WF.PulseShape.rcs(0.25))
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(2), 4 * 3000)
    x, _ = mod.modulate(bits)
    x = 0.5 * x  # amplitude error
    dd = DecisionDemod.create(wf, DecDemodConfig(osf=4, agc_tc=5.0))
    _, (rb, syms, mask, bmask) = dd.step(dd.init(), x)
    rbn = np.asarray(rb)[np.asarray(bmask)]
    ber, errs, lag = BER.cmp_bits(bits[4 * 1500:],
                                  jnp.asarray(rbn[4 * 1500:]), max_lag=64)
    assert ber < 0.02, (ber, errs)


def test_imu_ekf_tracks_attitude():
    model = ImuModel(dt=0.01, gyro_noise=2e-3, accel_noise=0.03,
                     mag_noise=0.03)
    qs, gyro, obs = imu_simulate(model, jax.random.PRNGKey(0), 600)
    qhat = imu_ekf(model, gyro, obs)
    # quaternion distance (up to sign) in the converged tail
    qt = np.asarray(qs)[200:]
    qe = np.asarray(qhat)[200:]
    d = np.minimum(np.linalg.norm(qt - qe, axis=1),
                   np.linalg.norm(qt + qe, axis=1))
    assert d.mean() < 0.05, d.mean()


def test_imu_ekf_beats_dead_reckoning():
    model = ImuModel(dt=0.01, gyro_noise=0.02, accel_noise=0.05,
                     mag_noise=0.05)
    qs, gyro, obs = imu_simulate(model, jax.random.PRNGKey(1), 800)
    qhat = imu_ekf(model, gyro, obs)
    # dead reckoning: integrate noisy gyro only
    q = jnp.asarray([1.0, 0, 0, 0])
    dr = []
    for i in range(800):
        q = model.f(q, gyro[i])
        dr.append(q)
    dr = np.asarray(jnp.stack(dr))
    qt = np.asarray(qs)
    qe = np.asarray(qhat)
    err_ekf = np.minimum(np.linalg.norm(qt - qe, axis=1),
                         np.linalg.norm(qt + qe, axis=1))[400:].mean()
    err_dr = np.minimum(np.linalg.norm(qt - dr, axis=1),
                        np.linalg.norm(qt + dr, axis=1))[400:].mean()
    assert err_ekf < 0.5 * err_dr, (err_ekf, err_dr)


def test_channelizer_separates_tones():
    M = 8
    n = 4096
    k = jnp.arange(n)
    # tones centered on channels 1 and 3
    x = (jnp.exp(2j * jnp.pi * (1 / M) * k)
         + 0.5 * jnp.exp(2j * jnp.pi * (3 / M) * k)).astype(jnp.complex64)
    ch = channelize(x, M)
    p = np.asarray(jnp.mean(jnp.abs(ch) ** 2, axis=0))
    # power concentrated in channels 1 and 3
    assert p[1] > 10 * max(p[0], p[2], p[4])
    assert p[3] > 10 * max(p[0], p[2], p[4])
    assert p[1] > 2 * p[3]  # 0.5 amplitude -> 1/4 power


def test_channelizer_streaming():
    M = 4
    c = Channelizer.create(M)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(1024)
                    + 1j * rng.standard_normal(1024), jnp.complex64)
    st = c.init()
    _, y_once = c.step(st, x)
    st = c.init()
    parts = []
    for i in range(0, 1024, 256):
        st, y = c.step(st, x[i:i + 256])
        parts.append(np.asarray(y))
    y_stream = np.concatenate(parts, axis=0)
    assert np.max(np.abs(y_stream - np.asarray(y_once))) < 1e-4


def test_rt_spectrum():
    cfg = SpectrumConfig(N=256, navg=2)
    sp = RtSpectrum.create(cfg)
    f0 = 0.1
    x = jnp.exp(2j * jnp.pi * f0 * jnp.arange(2048)).astype(jnp.complex64)
    st = sp.init()
    st, S = sp.step(st, x)
    S = np.asarray(S)
    freqs = np.fft.fftshift(np.fft.fftfreq(256))
    fpk = freqs[np.argmax(S)]
    assert abs(fpk - f0) < 1e-2
    # averaging: second step with noise only decays slowly
    st, S2 = sp.step(st, 0.01 * jnp.asarray(
        np.random.default_rng(0).standard_normal(2048)
        + 1j * np.random.default_rng(1).standard_normal(2048), jnp.complex64))
    assert np.argmax(np.asarray(S2)) == np.argmax(S)


def test_filter_analysis_metrics():
    h = FD.fir_lowpass(63, 0.1, "hn")
    a = FA.analyze_filter(h)
    assert 0.08 < a.main_lobe_width < 0.16
    assert a.first_sidelobe_atten_db > 30  # Hann-windowed sinc
    assert FA.filter_type_of(h) == "lp"
    hp = FD.fir_design_windowed(63, "hp", 0.2, "hn")
    assert FA.filter_type_of(hp) == "hp"


def test_analysis_responses():
    h = ID.design_iir(4, "lp", "butt", 0.1)
    fr, mag = FA.frmag(h)
    assert abs(mag[0] - 1.0) < 1e-6
    i3 = np.argmin(np.abs(fr - 0.1))
    assert abs(mag[i3] - 1 / np.sqrt(2)) < 0.02
    fr, gd = FA.frgroup(h)
    assert np.all(gd[:100] > 0)
    imp = FA.repimp(h, 64)
    stp = FA.repech(h, 64)
    assert abs(stp[-1] - 1.0) < 1e-3       # DC gain 1
    assert abs(imp.sum() - 1.0) < 1e-3


def test_window_analysis():
    from libtsd_jax.ops.window import window
    a_hn = FA.analyze_window(window("hann", 64, sym=True))
    a_re = FA.analyze_window(window("rect", 64))
    # Hann: ~-31 dB first sidelobe; rect: ~-13 dB
    assert 25 < a_hn.first_sidelobe_atten_db < 40
    assert 10 < a_re.first_sidelobe_atten_db < 16


def test_decision_demod2_qpsk_fused():
    """Single-scan pointer-based DD demod (DecisionDemod2) under combined
    timing + frequency offset + noise."""
    from libtsd_jax.models.demod_dec2 import DecisionDemod2
    from libtsd_jax.models.demod_dec import DecDemodConfig as DC
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(40), 2 * 3000)
    x, _ = mod.modulate(bits)
    x = delay_signal(x, 1.7)
    x = x * jnp.exp(2j * jnp.pi * 2e-4 *
                    jnp.arange(x.shape[0])).astype(jnp.complex64)
    x = CH.awgn(jax.random.PRNGKey(41), x, 15.0, osf=4, k_bits=2)
    dd = DecisionDemod2.create(wf, DC(osf=4))
    _, (rb, syms, mask, bmask) = dd.step(dd.init(), x)
    rbn = np.asarray(rb)[np.asarray(bmask)]
    ber, errs, lag = BER.cmp_bits_psk(bits[2 * 800:],
                                      jnp.asarray(rbn[2 * 800:]), 2,
                                      max_lag=64)
    assert ber < 0.01, (ber, errs)


def test_rt_spectrum_sweep_composite():
    """Frequency-sweep mode (parity: fourier.cc:1188-1196,1259-1266): a
    tone present in every capture at stepped LO positions must appear at
    the right composite bin, with DC/edge masking applied."""
    import numpy as np
    N, nsubs, step = 256, 4, 128
    cfg = SpectrumConfig(N=N, navg=1, nsubs=nsubs, sweep_step=step,
                         mask_hf=8, mask_bf=4)
    sp = RtSpectrum.create(cfg)
    assert cfg.Ns == N + (nsubs - 1) * step
    # capture i sees a tone at normalized frequency f_i such that, after
    # the LO step, the composite shows ONE consistent line: put a tone at
    # +32 bins from each capture's center -> composite bin i*step+N/2+32
    k = np.arange(N)
    caps = []
    for i in range(nsubs):
        f = 32.0 / N
        caps.append(np.exp(2j * np.pi * f * k))
    x = jnp.asarray(np.concatenate(caps), jnp.complex64)
    st = sp.init()
    st, db = sp.step(st, x)
    db = np.asarray(db)
    assert db.shape == (cfg.Ns,)
    # each capture's tone lands at its span's center+32 (spans overlap, so
    # assert the expected bins all carry near-max power)
    top = np.max(db)
    for i in range(nsubs):
        peak = i * step + N // 2 + 32
        assert db[peak] >= top - 6.0, (i, db[peak], top)
    # masked DC region of capture 0 (bins N/2-4..N/2+4) is floor-level
    assert db[N // 2] < top - 60


def test_rt_spectrum_sweep_overlap_normalized():
    """Overlapping sweep spans are hit-count normalized (mag_cnt,
    fourier.cc:1188-1196): flat noise in -> flat composite out."""
    import numpy as np
    N, nsubs, step = 128, 3, 64
    cfg = SpectrumConfig(N=N, navg=1, nsubs=nsubs, sweep_step=step)
    sp = RtSpectrum.create(cfg)
    rng = np.random.default_rng(0)
    nsw = 64
    x = jnp.asarray(
        (rng.standard_normal(nsw * nsubs * N)
         + 1j * rng.standard_normal(nsw * nsubs * N)) / np.sqrt(2),
        jnp.complex64)
    st = sp.init()
    st, db = sp.step(st, x)
    db = np.asarray(db)
    # hit-count normalization makes the composite flat at the per-bin
    # noise power: E|FFT_k|^2/N = sigma^2 = 1 -> 0 dB
    interior = db[4:-4]
    assert np.std(interior) < 1.5, np.std(interior)
    assert abs(np.mean(interior)) < 1.0, np.mean(interior)


def test_cqt_stream_decimated():
    """Streaming decimated CQT (parity: CQT::Impl, cqt.cc:255-365): tone
    lands in the right geometric bin; per-bin output rate follows the
    constant-Q decimation (hop = ktime/2)."""
    import numpy as np
    from libtsd_jax.ops.cqt import (cqt_stream_kernel, cqt_stream,
                                    cqt_interpolate)
    K = cqt_stream_kernel(fmin=0.01, fmax=0.3, gamma=2 ** (1 / 6), Q=20)
    n = 8 * (K.N // 2)
    f0 = 0.05
    x = jnp.asarray(np.cos(2 * np.pi * f0 * np.arange(n)), jnp.float32)
    times, mags, valid = jax.jit(lambda v: cqt_stream(v, K))(x)
    mags, valid = np.asarray(mags), np.asarray(valid)
    avg = (mags * valid).sum(axis=(0, 2)) / np.maximum(
        valid.sum(axis=(0, 2)), 1)
    assert int(np.argmax(avg)) == int(np.argmin(np.abs(K.freqs - f0)))
    # constant-Q decimation: output-count ratio tracks the ktime ratio
    cnt = valid.sum(axis=(0, 2))
    ratio = cnt[-1] / cnt[0]
    expect = K.ktime[0] / K.ktime[-1]
    assert 0.5 * expect < ratio < 2.0 * expect, (ratio, expect)
    # regular-grid interpolation (cqt.cc:368-421)
    g, f, A = cqt_interpolate(np.asarray(times), mags, valid, K, hop_out=64)
    assert A.shape[1] == len(K.freqs)
    assert int(np.argmax(A.mean(axis=0))) == int(np.argmax(avg))
    # grid covers the last valid output time (regression: one column short)
    assert g[-1] + 64 > np.asarray(times)[np.asarray(valid)].max()


def test_cqt_stream_low_bin_positions_stay_valid():
    """Regression: with the N/2 hop, every bin's window must fit the
    buffer (N >= 2*ktime_max) — the old sizing let low-bin evaluation
    positions drift NEGATIVE (window reaching before the buffer; the
    frequency-domain shift then wraps circularly, corrupting magnitudes
    with valid=True)."""
    import numpy as np
    from libtsd_jax.ops.cqt import cqt_stream, cqt_stream_kernel
    K = cqt_stream_kernel(fmin=0.01, fmax=0.3, Q=20)
    assert K.ktime.max() <= K.N // 2          # window fits every alignment
    n = 50 * (K.N // 2)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    times, mags, valid = jax.jit(lambda v: cqt_stream(v, K))(x)
    times, valid = np.asarray(times), np.asarray(valid)
    # all valid window-start times are in-range and per-bin spacing is dt
    assert (times[valid] >= 0).all()
    dt = np.maximum(K.ktime // 2, 1)
    for k in (0, len(K.freqs) // 2, len(K.freqs) - 1):
        tk = np.sort(times[:, k, :][valid[:, k, :]])
        gaps = np.diff(tk)
        assert gaps.size and (gaps == dt[k]).all(), (k, np.unique(gaps))


def test_dechannelize_roundtrip():
    """Critically sampled synthesis: unit gain and ~0.2% reconstruction
    at channel centers; broadband crossover aliasing bounded (structural
    for a critically sampled single-prototype DFT bank — documented).
    Guards the analysis/synthesis transform DIRECTION (an FFT where the
    IFFT belongs reconstructs with negated frequencies)."""
    from libtsd_jax.models.channelizer import dechannelize
    M, n, d = 16, 1 << 13, 128
    t = np.arange(n)
    x = np.exp(2j * np.pi * (3 / M) * t).astype(np.complex64)
    xr = np.asarray(dechannelize(channelize(jnp.asarray(x), M), M))
    m = slice(500, n - d - 500)
    err = np.sqrt(np.mean(np.abs(x[:n - d][m] - xr[d:][m]) ** 2))
    assert err < 0.01, err          # unit gain, tiny center-tone error
    rng = np.random.default_rng(0)
    xb = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)
    xrb = np.asarray(dechannelize(channelize(jnp.asarray(xb), M), M))
    errb = np.sqrt(np.mean(np.abs(xb[:n - d][m] - xrb[d:][m]) ** 2)
                   / np.mean(np.abs(xb[:n - d][m]) ** 2))
    assert errb < 0.35, errb        # crossover aliasing bound


def test_wola_near_perfect_reconstruction():
    """2x oversampled WOLA pair with the root-Nyquist prototype:
    broadband reconstruction to < -65 dB, including channel-EDGE tones
    (each edge tone passes the prototype twice; the -3 dB root-Nyquist
    crossing makes adjacent channels sum to exactly 1)."""
    from libtsd_jax.models.channelizer import wola_analysis, wola_synthesis
    M, n = 16, 1 << 13
    rng = np.random.default_rng(0)
    for x in (np.exp(2j * np.pi * (3.5 / M) * np.arange(n)),    # edge
              np.exp(2j * np.pi * 0.123 * np.arange(n)),        # arbitrary
              rng.standard_normal(n) + 1j * rng.standard_normal(n)):
        x = x.astype(np.complex64)
        ch = wola_analysis(jnp.asarray(x), M)
        xr = np.asarray(wola_synthesis(ch, M))
        L = min(len(xr), n)
        m = slice(900, L - 900)
        err = np.sqrt(np.mean(np.abs(x[:L][m] - xr[:L][m]) ** 2)
                      / np.mean(np.abs(x[:L][m]) ** 2))
        assert err < 6e-4, err


def test_wola_channel_isolation():
    """A channel-center tone lands in exactly one WOLA channel."""
    from libtsd_jax.models.channelizer import wola_analysis
    M, n = 16, 1 << 12
    x = np.exp(2j * np.pi * (5 / M) * np.arange(n)).astype(np.complex64)
    ch = np.asarray(wola_analysis(jnp.asarray(x), M))
    e = (np.abs(ch[100:-100]) ** 2).mean(axis=0)
    assert np.argmax(e) == 5
    others = np.delete(e, 5)
    assert others.max() < 1e-3 * e[5], (others.max(), e[5])
