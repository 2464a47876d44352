"""FIR design tests vs scipy + response-spec checks (mirrors
core/tests/test-filtres.cc strategy: verify the achieved frequency response
against the design spec)."""
import numpy as np
import pytest
import scipy.signal as sps

from libtsd_jax.ops import fir_design as FD


def freq_resp(h, nfft=4096):
    H = np.abs(np.fft.rfft(h, nfft))
    f = np.arange(len(H)) / nfft
    return f, H


def test_windowed_lowpass_response():
    fc = 0.1
    h = FD.fir_design_windowed(63, "lp", fc, "hn")
    f, H = freq_resp(h)
    assert abs(H[0] - 1.0) < 1e-6          # unit DC gain
    assert H[f > 0.18].max() < 0.01        # stopband < -40 dB
    assert H[f < 0.05].min() > 0.99        # flat passband


def test_windowed_highpass_response():
    h = FD.fir_design_windowed(63, "hp", 0.1, "hn")
    f, H = freq_resp(h)
    # DC rejection limited by the lowpass's stopband leakage (the reference
    # has the same behavior and notes "TODO: normalisation gain pour hp")
    assert H[0] < 1e-3
    assert abs(H[np.argmin(np.abs(f - 0.25))] - 1.0) < 0.02


def test_windowed_bandpass_response():
    h = FD.fir_design_windowed(127, "bp", 0.1, "hn", 0.2)
    f, H = freq_resp(h)
    i_mid = np.argmin(np.abs(f - 0.15))
    assert abs(H[i_mid] - 1.0) < 0.05
    assert H[0] < 1e-3
    assert H[f > 0.28].max() < 0.02


def test_windowed_bandstop_response():
    h = FD.fir_design_windowed(127, "sb", 0.1, "hn", 0.2)
    f, H = freq_resp(h)
    i_mid = np.argmin(np.abs(f - 0.15))
    assert H[i_mid] < 0.01
    assert abs(H[0] - 1.0) < 0.02


def test_kaiser_design_meets_atten():
    h = FD.fir_design_kaiser("lp", 0.125, 60.0, 0.05)
    f, H = freq_resp(h)
    sb = H[f > 0.125 + 0.05 / 2 + 0.01]
    assert 20 * np.log10(sb.max()) < -55


def test_equiripple_lowpass():
    spec = [FD.FreqIntervalSpec(0.0, 0.1, 1.0, 1.0),
            FD.FreqIntervalSpec(0.15, 0.5, 0.0, 1.0)]
    h = FD.fir_design_equiripple(63, spec)
    f, H = freq_resp(h)
    pb = H[f < 0.09]
    sb = H[(f > 0.16) & (f < 0.49)]
    assert np.all(np.abs(pb - 1.0) < 0.03)
    assert 20 * np.log10(sb.max() + 1e-12) < -35
    # linear phase: symmetric taps
    assert np.max(np.abs(h - h[::-1])) < 1e-9


def test_freq_sampling():
    m = 16
    d = np.ones(m); d[m // 2:] = 0.0   # crude lowpass template
    h = FD.fir_design_freq_sampling(2 * m - 1, d)
    fr = FD.fir_freq_sampling_freqs(2 * m - 1)
    _, A = FD.fir_amplitude(h, 1024)
    fgrid = np.linspace(0, 0.5 - 0.5 / 1024, 1024)
    # response must interpolate the template at its sampling freqs
    for fi, di in zip(fr, d):
        ai = np.interp(fi, fgrid, A)
        assert abs(ai - di) < 0.05, (fi, ai, di)


def test_raised_cosine_matches_scipy_shape():
    # RC filter: zero ISI property — value at multiples of symbol period = 0
    n, beta, osf = 127, 0.25, 8
    h = FD.raised_cosine(n, beta, 1 / (2 * osf))
    center = n // 2
    sym_samples = h[center + osf::osf]
    assert np.max(np.abs(sym_samples)) < 1e-3 * np.abs(h[center])


def test_rrc_autocorrelation_is_rc():
    # RRC * RRC (matched pair) must satisfy Nyquist (zero ISI)
    n, beta, osf = 127, 0.35, 8
    h = FD.root_raised_cosine(n, beta, osf, nrm="e")
    rc = np.convolve(h, h)
    center = len(rc) // 2
    sym = rc[center + osf::osf]
    assert np.max(np.abs(sym)) < 5e-3 * rc[center]


def test_gaussian_fir():
    h = FD.gaussian_fir(33, 3.0)
    assert abs(h.sum() - 1.0) < 1e-9
    assert np.argmax(h) == 16
    assert np.max(np.abs(h - h[::-1])) < 1e-12


def test_gaussian_telecom():
    h = FD.gaussian_fir_telecom(33, 0.3, 4)
    assert abs(h.sum() - 1.0) < 1e-9


def test_halfband():
    h = FD.fir_halfband(31, 0.22)
    m = (len(h) - 1) // 2
    # every other tap is zero except center = 0.5
    assert abs(h[m] - 0.5) < 1e-9
    odd_taps = [h[k] for k in range(len(h)) if k != m and (k - m) % 2 == 0]
    assert np.max(np.abs(odd_taps)) < 1e-9
    # half-band complementarity: A(f) + A(0.5 - f) = 1 where A is the
    # SIGNED zero-phase amplitude (remove the linear phase e^{-j2pi f m}
    # first; |H| would add 2*|ripple| wherever the stopband amplitude
    # goes negative).  Structural for an odd-tap zero-interleaved design
    # with center 0.5, so the tolerance is float-level.
    H = np.fft.rfft(h, 1024)
    k = np.arange(513)
    amp = np.real(H * np.exp(2j * np.pi * k * m / 1024))
    comp = amp[:256] + amp[512 - np.arange(256)]
    assert np.max(np.abs(comp - 1.0)) < 1e-9, np.max(np.abs(comp - 1.0))
    mag = np.abs(H)
    # main property check: -6 dB at quarter band
    assert abs(mag[256] - 0.5) < 0.01


def test_hilbert():
    n = 63
    h = FD.fir_hilbert(n, "hn")
    w, H = sps.freqz(h, worN=1024)
    f = w / (2 * np.pi)
    band = (f > 0.08) & (f < 0.42)
    assert np.max(np.abs(np.abs(H[band]) - 1.0)) < 0.03
    # antisymmetric taps
    assert np.max(np.abs(h + h[::-1])) < 1e-9


def test_differentiator():
    h = FD.fir_differentiator(31, centered=True)
    # response should approximate |H(f)| = 2*pi*f in low band
    w, H = sps.freqz(h, worN=1024)
    f = w / (2 * np.pi)
    band = (f > 0.05) & (f < 0.2)
    ratio = np.abs(H[band]) / (2 * np.pi * f[band])
    # truncated 1/k series without window -> slow Gibbs convergence
    assert np.max(np.abs(ratio - 1.0)) < 0.25


def test_fir_type():
    assert FD.fir_type(np.array([1, 2, 1.0])) == 1
    assert FD.fir_type(np.array([1, 1.0])) == 2
    assert FD.fir_type(np.array([1, 0, -1.0])) == 3
    assert FD.fir_type(np.array([1, -1.0])) == 4


def test_fir_amplitude_linear_phase():
    h = FD.fir_lowpass(31, 0.1)
    fr, A = FD.fir_amplitude(h, 512)
    w, H = sps.freqz(h, worN=512, whole=False)
    # |A| must match |H| (A is signed amplitude)
    assert np.max(np.abs(np.abs(A) - np.abs(H)[:512])) < 1e-6


def test_lp_transforms():
    h = FD.fir_lowpass(31, 0.1)
    g = FD.lowpass_to_highpass_is(h)
    _, Hg = freq_resp(g)
    assert Hg[0] < 1e-6
    g2 = FD.lowpass_to_highpass_rs(h)
    _, Hg2 = freq_resp(g2)
    assert Hg2[0] < 1e-3
    g3 = FD.lowpass_to_bandpass(h, 0.25)
    f3, Hg3 = freq_resp(g3)
    assert abs(Hg3[np.argmin(np.abs(f3 - 0.25))] - 1.0) < 0.05
