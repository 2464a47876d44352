"""IIR design tests vs scipy (independent golden) and response specs."""
import numpy as np
import pytest
import scipy.signal as sps

from libtsd_jax.ops import iir_design as ID
from libtsd_jax.ops.poly import freq_response_ba, group_delay_ba


def resp(zpk, f):
    return np.abs(zpk.freq_response(np.asarray(f)))


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8])
def test_butterworth_lowpass(n):
    fc = 0.1
    h = ID.design_iir(n, "lp", "butt", fc)
    # -3 dB at cutoff, monotone
    assert abs(resp(h, [fc])[0] - 1 / np.sqrt(2)) < 1e-3
    assert abs(resp(h, [0.0])[0] - 1.0) < 1e-6
    # compare against scipy's butter
    b, a = h.to_ba()
    bs, as_ = sps.butter(n, 2 * fc)
    w, H1 = sps.freqz(b, a, worN=256)
    w, H2 = sps.freqz(bs, as_, worN=256)
    assert np.max(np.abs(np.abs(H1) - np.abs(H2))) < 1e-5


@pytest.mark.parametrize("n", [2, 5])
def test_butterworth_highpass(n):
    fc = 0.15
    h = ID.design_iir(n, "hp", "butt", fc)
    b, a = h.to_ba()
    bs, as_ = sps.butter(n, 2 * fc, btype="highpass")
    w, H1 = sps.freqz(b, a, worN=256)
    w, H2 = sps.freqz(bs, as_, worN=256)
    assert np.max(np.abs(np.abs(H1) - np.abs(H2))) < 1e-5


def test_cheby1():
    n, rp, fc = 5, 1.0, 0.1
    h = ID.design_iir(n, "lp", "cheb1", fc, rp=rp)
    f = np.linspace(0, fc, 200)
    H = resp(h, f)
    # ripple bounded by rp dB in passband
    assert H.max() < 1.001
    assert 20 * np.log10(H.min()) > -rp - 0.1
    # reference convention: DC gain forced to 1 (rii.cc:365-368)
    assert abs(resp(h, [0.0])[0] - 1.0) < 1e-6


def test_cheby2():
    n, rs, fc = 5, 40.0, 0.1
    h = ID.design_iir(n, "lp", "cheb2", fc, rs=rs)
    # stopband: attenuation >= rs beyond cutoff
    f = np.linspace(fc * 1.05, 0.49, 200)
    H = resp(h, f)
    assert 20 * np.log10(H.max()) < -rs + 1.0
    assert abs(resp(h, [0.0])[0] - 1.0) < 1e-6


@pytest.mark.parametrize("n", [3, 4, 5, 6])
def test_elliptic(n):
    # exact agreement with scipy.ellip (independent implementation)
    rp, rs, fc = 1.0, 40.0, 0.1
    h = ID.design_iir(n, "lp", "ellip", fc, rp=rp, rs=rs)
    b, a = h.to_ba()
    bs, as_ = sps.ellip(n, rp, rs, 2 * fc)
    w, H1 = sps.freqz(b, a, worN=1024)
    w, H2 = sps.freqz(bs, as_, worN=1024)
    assert np.max(np.abs(np.abs(H1) - np.abs(H2))) < 1e-9
    # passband ripple within rp
    f = w / (2 * np.pi)
    Hp = np.abs(H1)[f < fc * 0.99]
    assert 20 * np.log10(Hp.min()) > -rp - 0.2
    assert Hp.max() < 1.01
    # for n >= 5 the transition is narrow enough to check 40 dB at 1.35 fc
    if n >= 5:
        Hs = np.abs(H1)[f > fc * 1.35]
        assert 20 * np.log10(Hs.max()) < -rs + 2.0


def test_bandpass_butterworth():
    h = ID.design_iir(3, "bp", "butt", 0.1, fcut2=0.2)
    f0 = np.sqrt(0.1 * 0.2)  # geometric center (approx, prewarped)
    Hmid = resp(h, [0.14])[0]
    assert Hmid > 0.9
    assert resp(h, [0.01])[0] < 0.05
    assert resp(h, [0.35])[0] < 0.05


def test_bandstop_butterworth():
    h = ID.design_iir(3, "sb", "butt", 0.1, fcut2=0.2)
    assert resp(h, [0.14])[0] < 0.05
    assert resp(h, [0.01])[0] > 0.95
    assert resp(h, [0.4])[0] > 0.9


def test_biquad_lp_matches_rbj():
    b, a = ID.design_biquad(ID.BiquadSpec("lp", 0.1, 0.707))
    w, H = sps.freqz(b, a, worN=512)
    f = w / (2 * np.pi)
    assert abs(np.abs(H[0]) - 1.0) < 1e-6
    i = np.argmin(np.abs(f - 0.1))
    assert abs(np.abs(H[i]) - 1 / np.sqrt(2)) < 0.02


def test_biquad_notch():
    b, a = ID.design_biquad(ID.BiquadSpec("notch", 0.15, 5.0))
    H = freq_response_ba(b, a, np.array([0.15]))
    assert np.abs(H[0]) < 1e-3
    H2 = freq_response_ba(b, a, np.array([0.02, 0.45]))
    assert np.all(np.abs(H2) > 0.9)


def test_biquad_shelf():
    b, a = ID.design_biquad(ID.BiquadSpec("lowshelf", 0.1, 0.707, 12.0))
    H0 = np.abs(freq_response_ba(b, a, np.array([0.001]))[0])
    H1 = np.abs(freq_response_ba(b, a, np.array([0.49]))[0])
    assert abs(20 * np.log10(H0) - 12.0) < 0.5
    assert abs(20 * np.log10(H1)) < 0.5


def test_lexp():
    fc = 0.05
    b, a = ID.design_lexp(fc)
    H0 = np.abs(freq_response_ba(b, a, np.array([0.0]))[0])
    Hc = np.abs(freq_response_ba(b, a, np.array([fc]))[0])
    assert abs(H0 - 1.0) < 1e-6
    assert abs(Hc - 1 / np.sqrt(2)) < 0.08  # first-order approx of cutoff


def test_dc_blocker():
    b, a = ID.design_dc_blocker(0.01)
    H0 = np.abs(freq_response_ba(b, a, np.array([0.0]))[0])
    Hh = np.abs(freq_response_ba(b, a, np.array([0.25]))[0])
    assert H0 < 1e-9
    assert Hh > 0.95


def test_notch_design():
    b, a = ID.design_notch(0.2, 0.02)
    assert np.abs(freq_response_ba(b, a, np.array([0.2]))[0]) < 1e-6
    assert np.abs(freq_response_ba(b, a, np.array([0.05]))[0]) > 0.9


def test_zpk_to_sos_reconstruction():
    h = ID.design_iir(5, "lp", "ellip", 0.12, rp=0.5, rs=50)
    sos, k = ID.zpk_to_sos(h)
    # evaluate SOS cascade response and compare with direct zpk response
    f = np.linspace(0, 0.49, 200)
    H = np.ones_like(f, dtype=complex) * k
    for row in sos:
        H = H * freq_response_ba(row[:3], row[3:], f)
    Href = h.freq_response(f)
    assert np.max(np.abs(H - Href)) < 1e-6


def test_bilinear_vs_scipy():
    ha = ID.cheby1_analog(4, 1.0)
    hd = ID.bilinear(ID.lp_to_lp(ha, 2 * np.tan(np.pi * 0.1)), 1.0)
    b, a = hd.to_ba()
    bs, as_ = sps.cheby1(4, 1.0, 2 * 0.1)
    w, H1 = sps.freqz(b, a, worN=256)
    w, H2 = sps.freqz(bs, as_, worN=256)
    # reference forces DC gain 1 while scipy keeps the ripple convention —
    # compare shapes after normalizing at DC
    H1 = np.abs(H1) / np.abs(H1[0])
    H2 = np.abs(H2) / np.abs(H2[0])
    assert np.max(np.abs(H1 - H2)) < 1e-4


def test_design_iir_pm_alias_validates_band_edges():
    """'pm' (passe-milieu) must hit the same band-edge validation as
    'bp' — it silently produced a marginally unstable filter."""
    import pytest
    from libtsd_jax.ops.iir_design import design_iir
    with pytest.raises(ValueError, match="band edges"):
        design_iir(4, "pm", "butt", 0.2)
    z = design_iir(4, "pm", "butt", 0.1, fcut2=0.2)
    assert np.max(np.abs(z.p)) < 1.0     # stable
