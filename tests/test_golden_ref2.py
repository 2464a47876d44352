"""Direct numerical diff against the ACTUAL reference binary — round 2:
design / estimation / detection layers, beyond the five BASELINE configs
covered by test_golden_ref.py.

Goldens produced by refbuild/golden_gen2.cc (deterministic inputs, no
RNG; `make -C refbuild golden` regenerates bit-for-bit).  Components:
windows (Chebyshev synthesis, Kaiser), pulse-shaping FIR designs,
equiripple IRLS, IIR designs through the SOS runtime, RBJ biquad,
Goertzel, xcorr, fractional-delay estimation, CZT, lifting DWT,
LPC/Levinson, the streaming pattern detector, baseband transposition,
single-tone frequency estimation, real FFT.

Documented deviations from the reference (each asserted below where
checkable):
 * SOS runtime startup transient: the reference's filtre_sois warms up
   differently over the first ~16 samples (its own output disagrees with
   scipy.lfilter on its own coefficients there, max 0.23 at sample 2,
   <3e-7 past sample 64); steady state is float32-exact.
 * Elliptic design: we fix the reference's odd-order ek off-by-one vs
   the Orchard-Willson paper (ops/iir_design.py:185-190), so elliptic
   coefficients deviate by design; butt/cheb1/cheb2 are float32-exact.
 * czt: the reference's czt is untested in its own suite and its output
   provably disagrees with its own documented formula (fourier.hpp
   czt doc) at n=512 — the per-bin ratio is not even a constant scale.
   Ours matches the brute-force formula to float32; asserted here.
 * DWT boundary: the reference lifts with a zero boundary
   (tod.cc:231-236); we periodize (vectorized rolls).  Haar (support-1
   steps) is boundary-free and compared in full; db2 is compared on the
   interior.
"""
import os

import numpy as np
import pytest
import jax.numpy as jnp

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


# ------------------------------------------------------------- windows

def test_window_chebyshev_matches_reference():
    from libtsd_jax.ops.window import chebyshev_window
    assert np.abs(np.asarray(chebyshev_window(64, 60))
                  - g("g2_win_cheb")).max() < 1e-5


def test_window_kaiser_matches_reference():
    from libtsd_jax.ops.window import kaiser_window
    assert np.abs(np.asarray(kaiser_window(64, 6.0))
                  - g("g2_win_kaiser")).max() < 1e-6


# ------------------------------------------------- FIR design familly

def test_fir_designs_match_reference():
    from libtsd_jax.ops import fir_design as FD
    cases = [
        (FD.root_raised_cosine(63, 0.25, 4), "g2_fir_rcs"),   # fc=1/(2*4)
        (FD.raised_cosine(63, 0.25, 0.125), "g2_fir_cs"),
        (FD.gaussian_fir_telecom(21, 0.3, 4), "g2_fir_gauss"),
        (FD.fir_halfband(31, 0.22), "g2_fir_hb"),
        (FD.fir_hilbert(63, "hn"), "g2_fir_hilbert"),
    ]
    for ours, name in cases:
        ours = np.asarray(ours)
        ref = g(name)
        assert ours.shape == ref.shape, name
        assert np.abs(ours - ref).max() < 1e-6, name


def test_fir_equiripple_irls_matches_reference():
    """Same 512-point D/W grid as golden_gen2.cc -> same IRLS fixpoint."""
    from libtsd_jax.ops.fir_design import fir_design_equiripple_grid
    n = 512
    f = 0.5 * np.arange(n) / n
    D = np.where(f <= 0.2, 1.0, np.where(f >= 0.25, 0.0,
                                         1 - (f - 0.2) / 0.05))
    W = np.where(f <= 0.2, 1.0, np.where(f >= 0.25, 10.0, 1e-3))
    h = np.asarray(fir_design_equiripple_grid(63, D, W))
    assert np.abs(h - g("g2_fir_eq")).max() < 5e-6


# ------------------------------------------------ IIR design + runtime

@pytest.mark.parametrize("name,order,proto,fc,rp,rs", [
    ("butt", 4, "butt", 0.12, 1.0, 40.0),
    ("cheb1", 5, "cheb1", 0.15, 1.0, 40.0),
    ("cheb2", 5, "cheb2", 0.15, 1.0, 40.0),
])
def test_iir_design_coefficients_match_reference(name, order, proto, fc, rp, rs):
    """Expanded b/a of design_riia (reference stores ascending powers,
    monic in the HIGHEST power -> compare reversed)."""
    from libtsd_jax.ops.iir_design import design_iir
    b, a = design_iir(order, "lp", proto, fc, rp, rs).to_ba()
    ref_b, ref_a = g(f"g2_iir_{name}_b")[::-1], g(f"g2_iir_{name}_a")[::-1]
    assert np.abs(np.real(b) - ref_b).max() < 2e-6
    assert np.abs(np.real(a) - ref_a).max() < 2e-6


def test_iir_elliptic_deviates_as_documented():
    """Elliptic: our odd-order fix (iir_design.py:185-190) makes the
    coefficients deviate from the reference by a small, non-zero amount
    — and ours must agree with scipy's independent implementation."""
    import scipy.signal as ss
    from libtsd_jax.ops.iir_design import design_iir
    b, a = design_iir(5, "lp", "ellip", 0.15, 0.5, 50.0).to_ba()
    bs, as_ = ss.ellip(5, 0.5, 50.0, 0.3)
    assert np.abs(np.real(b) - bs).max() < 1e-9
    assert np.abs(np.real(a) - as_).max() < 1e-9
    ref_a = g("g2_iir_ellip_a")[::-1]
    d = np.abs(np.real(a) - ref_a).max()
    assert 1e-3 < d < 0.2, d  # deviation exists and is bounded


@pytest.mark.parametrize("name,order,proto,fc,rp,rs", [
    ("butt", 4, "butt", 0.12, 1.0, 40.0),
    ("cheb1", 5, "cheb1", 0.15, 1.0, 40.0),
    ("cheb2", 5, "cheb2", 0.15, 1.0, 40.0),
])
def test_sos_runtime_matches_reference_steady_state(name, order, proto,
                                                    fc, rp, rs):
    """design -> SOS cascade -> chirp: float32-level agreement with the
    reference's filtre_sois PAST its startup transient (see module
    docstring; the first ~64 samples differ in the reference's own warmup
    convention, its output there disagrees with lfilter on its own
    coefficients)."""
    from libtsd_jax.ops.filter_rt import Sos
    from libtsd_jax.ops.iir_design import design_iir
    x = jnp.asarray(g("g2_iir_x"))
    s = Sos.from_zpk(design_iir(order, "lp", proto, fc, rp, rs))
    _, y = s.step(s.init_for(x), x)
    # the reference transient decays with the filter poles (cheb1 at
    # fc=0.15 still differs 1e-3 from lfilter-on-its-own-coefficients at
    # sample 64, 2e-6 by 256) — compare once it has died
    err = np.abs(np.asarray(y)[256:] - g(f"g2_iir_{name}")[256:])
    assert err.max() < 1e-5, err.max()


def test_biquad_matches_reference():
    """RBJ lowpass biquad; reference Poly coefs are ascending powers."""
    from libtsd_jax.ops.iir_design import BiquadSpec, design_biquad
    b, a = design_biquad(BiquadSpec("lp", 0.1, 1.2))
    assert np.abs(b - g("g2_biquad_b")[::-1]).max() < 1e-6
    assert np.abs(a - g("g2_biquad_a")[::-1]).max() < 1e-6


# ------------------------------------------------- spectral estimation

def test_goertzel_matches_reference():
    from libtsd_jax.ops.fft import goertzel
    from libtsd_jax.ops.signal import sigcos, sigsin
    x = sigcos(0.1, 500) + 0.5 * sigsin(0.17, 500)
    ref = g("g2_goertzel")
    for i, f0 in enumerate((0.1, 0.17, 0.3)):
        assert abs(float(goertzel(x, f0)) - ref[i]) < 1e-5


def test_xcorr_matches_reference():
    from libtsd_jax.ops.corr import xcorr
    from libtsd_jax.ops.fft import delay_signal
    x = jnp.asarray(g("g2_xcorr_x"))
    y = delay_signal(x, 5.5)
    _, c = xcorr(x, y, 127)
    ref = g("g2_xcorr")
    assert c.shape == ref.shape
    assert np.abs(np.asarray(c) - ref).max() < 1e-4


def test_delay_estimation_matches_reference():
    """estimation_délais parity: same fractional delay, same normalized
    score, to float32 rounding."""
    from libtsd_jax.ops.corr import estimate_delay
    from libtsd_jax.ops.fft import delay_signal
    x = jnp.asarray(g("g2_xcorr_x"))
    d, s = estimate_delay(x, delay_signal(x, 5.5))
    ref = g("g2_delay_est")
    assert abs(float(d) - ref[0]) < 1e-4
    assert abs(float(s) - ref[1]) < 1e-4


def test_czt_reference_defect_documented():
    """Our czt matches the brute-force contour evaluation; the
    reference's czt does NOT match its own documented formula here (and
    its test suite never exercises czt) — keep the evidence asserted so
    the deviation stays documented."""
    from libtsd_jax.ops.fft import czt
    x = g("g2_xcorr_x").astype(np.complex128)
    n = len(x)
    k = np.arange(n)
    W = np.exp(-2j * np.pi * 0.0013)
    z0 = np.exp(1j * 0.3)
    direct = np.array([np.sum(x * ((1 / z0) ** k) * (W ** (m * k)))
                       for m in range(n)])
    scale = np.abs(direct).max()
    ours = np.asarray(czt(jnp.asarray(x.astype(np.complex64)), n,
                          W=W, z0=z0))
    assert (np.abs(ours - direct) / scale).max() < 1e-5
    ref = g("g2_czt")
    assert (np.abs(ref - direct) / scale).max() > 0.5  # reference defect


def test_freq_estim_matches_reference():
    from libtsd_jax.ops.psd import freq_estim
    from libtsd_jax.ops.signal import sigexp
    tone = sigexp(0.12347, 1000)
    ref = g("g2_freqestim")
    for i, m in enumerate(("fft", "candan2", "quadratic")):
        assert abs(float(freq_estim(tone, m)) - ref[i]) < 1e-6, m


def test_rfft_matches_reference():
    """Reference rfft returns the full packed spectrum; ours the n//2+1
    non-negative bins — compare those (orthonormal scaling both sides)."""
    from libtsd_jax.ops.fft import rfft
    R = np.asarray(rfft(jnp.asarray(g("g2_rfft_x"))))
    assert np.abs(R - g("g2_rfft")[: len(R)]).max() < 1e-6


# ------------------------------------------------------ DWT / lifting

def test_dwt_haar_matches_reference():
    """Depth-3 Haar lifting: boundary-free, so full-vector agreement.
    The reference does not apply the normalization K inside lift_step
    (tod.cc:211-240 ignores Lift.K); divide ours out per level."""
    from libtsd_jax.ops.lifting import lift_dwt, lift_haar
    x = jnp.asarray(g("g2_dwt_x"))
    d1, d2, d3, a3 = lift_dwt(x, lift_haar(), 3)
    K = np.sqrt(2.0)
    ours = np.concatenate([
        np.asarray(a3) / K ** 3,
        np.asarray(d3) / K,          # level 3 detail: K^2 in, 1/K out
        np.asarray(d2),              # level 2: K in, 1/K out
        np.asarray(d1) * K,          # level 1: 1/K out
    ])
    assert np.abs(ours - g("g2_dwt_haar")).max() < 1e-5


def test_dwt_db2_interior_matches_reference():
    """db2 lifting, depth 1: interior agreement (boundary cells differ —
    zero vs periodized extension, module docstring)."""
    from libtsd_jax.ops.lifting import lift_dwt, lift_db2
    x = jnp.asarray(g("g2_dwt_x"))
    d1, a1 = lift_dwt(x, lift_db2(), 1)
    Kd = (np.sqrt(3) - 1) / np.sqrt(2)
    ours = np.concatenate([np.asarray(a1) / Kd, np.asarray(d1) * Kd])
    ref = g("g2_dwt_db2")
    assert np.abs(ours[4:124] - ref[4:124]).max() < 1e-5
    assert np.abs(ours[132:252] - ref[132:252]).max() < 1e-5


# ---------------------------------------------------- LPC / Levinson

def test_levinson_matches_reference():
    from libtsd_jax.models.stats import levinson_real
    r = np.array([1.0, 0.5, 0.2, 0.05, -0.01, 0.003])
    assert np.abs(levinson_real(r) - g("g2_levinson")).max() < 1e-6


def test_lpc_composite_matches_reference():
    """Reference lpc = unbiased xcorr lags 0..p-1 -> levinson_reel
    (stats.cc:122-130).  Same composite through our primitives.  The
    deterministic tone mixture makes the normal equations borderline
    (pure AR(6) signal, order-8 fit), so float32 autocorrelation noise
    moves the high-order coefficients at the 1e-2 level — gate there and
    cross-check the model against the signal itself (spectral peaks)."""
    from libtsd_jax.models.stats import levinson_real
    from libtsd_jax.ops.corr import xcorr
    x = jnp.asarray(g("g2_lpc_x"))
    _, cr = xcorr(x, x, 8)
    r = np.real(np.asarray(cr)[7:])  # lags 0..7
    a = levinson_real(r)
    ref = g("g2_lpc_a")
    assert a.shape == ref.shape
    assert np.abs(a - ref).max() < 0.05
    # both predictors must whiten the signal comparably
    xs = np.asarray(x, np.float64)
    def perr(c):
        return np.std(np.convolve(xs, c)[8:-8])
    assert perr(a) < 0.06 * np.std(xs)
    assert abs(perr(a) - perr(ref)) < 0.02 * np.std(xs)


# ------------------------------------------------------ detector / BB

def test_detector_matches_reference():
    """Streaming correlation detector on the reference's exact input:
    same single detection, same position (exact), sub-sample position
    within 0.01, gain/theta/score/SNR at reference precision
    (Detection fields, fourier.hpp:546-574)."""
    from libtsd_jax.models.detector import DetectorConfig, detect_pattern
    x = jnp.asarray(g("g2_det_x"))
    motif = jnp.asarray(g("g2_det_motif"))
    det, _ = detect_pattern(x, motif, DetectorConfig(threshold=0.4, Ne=1024))
    v = np.asarray(det.valid)
    assert v.sum() == 1
    i = int(np.argmax(v))
    ref = g("g2_det")  # [pos, pos_frac, score, gain, theta, snr_db]
    pos = float(np.asarray(det.position)[i])
    frac = float(np.asarray(det.position_frac)[i])
    assert pos == ref[0]
    assert abs((pos + frac) - ref[1]) < 0.01
    assert abs(float(np.asarray(det.score)[i]) - ref[2]) < 1e-3
    assert abs(float(np.asarray(det.gain)[i]) - ref[3]) < 1e-3
    assert abs(float(np.asarray(det.theta)[i]) - ref[4]) < 1e-3
    assert abs(float(np.asarray(det.snr_db)[i]) - ref[5]) < 0.2


def test_transpo_bb_matches_reference():
    """Complex-input baseband transposition: pure NCO mix (no image
    filter), float32 phase-accumulation agreement."""
    from libtsd_jax.models.spread import TranspoBB, TranspoBBConfig
    x = jnp.asarray(g("g2_transpo_x"))
    t = TranspoBB.create(TranspoBBConfig(fi=0.17), real_input=False)
    _, y = t.step(t.init(), x)
    assert np.abs(np.asarray(y) - g("g2_transpo")).max() < 5e-4
