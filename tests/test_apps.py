"""Application-layer tests: Kalman/EKF, DOA/MUSIC, linear prediction."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg as sla

from libtsd_jax.models import kalman as KF
from libtsd_jax.models import doa as DOA
from libtsd_jax.models import stats as ST


def test_levinson_real_vs_toeplitz_solve():
    rng = np.random.default_rng(0)
    # a valid autocorrelation: PSD of an AR process
    x = rng.standard_normal(10000)
    from scipy.signal import lfilter
    x = lfilter([1.0], [1, -0.8, 0.3], x)
    n = 8
    r = np.array([np.dot(x[:len(x)-k], x[k:]) for k in range(n)]) / len(x)
    a = ST.levinson_real(r)
    # prediction filter must satisfy the Yule-Walker equations:
    # R[1:n,1:n-ish] — check: sum_j a[j] r[|i-j|] ~ 0 for i=1..n-1
    T = sla.toeplitz(r)
    resid = T @ a
    assert np.allclose(resid[1:], 0, atol=1e-10)


def test_levinson_general():
    rng = np.random.default_rng(1)
    n = 12
    c = rng.standard_normal(n); c[0] = 5.0
    l = rng.standard_normal(n); l[0] = c[0]
    T = sla.toeplitz(c, l)
    y = rng.standard_normal(n)
    x = ST.levinson(l, c, y)
    assert np.allclose(T @ x, y, atol=1e-8)


def test_lpc_recovers_ar():
    rng = np.random.default_rng(2)
    from scipy.signal import lfilter
    a_true = [1, -1.2, 0.5]
    x = lfilter([1.0], a_true, rng.standard_normal(100000))
    a, err = ST.lpc(x, 2)
    assert np.allclose(a, a_true, atol=0.02)


def test_wiener_fir_identity():
    # if desired signal == input, Wiener filter ~ identity
    rxx = np.array([1.0, 0.2, 0.05, 0.0])
    rxy = np.array([1.0, 0.2, 0.05, 0.0])
    h = ST.wiener_fir(rxx, rxy)
    assert abs(h[0] - 1.0) < 1e-6
    assert np.abs(h[1:]).max() < 1e-6


def test_psd_subspace_resolves_close_tones():
    rng = np.random.default_rng(3)
    n = 1024
    f1, f2 = 0.1, 0.11  # closer than the FFT resolution of m=48
    x = (np.exp(2j*np.pi*f1*np.arange(n)) + np.exp(2j*np.pi*f2*np.arange(n))
         + 0.05*(rng.standard_normal(n)+1j*rng.standard_normal(n))).astype(np.complex64)
    grid, S = ST.psd_subspace(jnp.asarray(x), Ns=2, Nf=2048, m=48)
    S = np.asarray(S); grid = np.asarray(grid)
    # the two strongest peaks must be near -f1, -f2: covmtx builds the
    # CONJUGATE of its documented covariance (reference binary parity, see
    # covmtx docstring), so MUSIC peaks land at the mirrored frequencies
    from scipy.signal import find_peaks
    pk, _ = find_peaks(S, height=S.max() - 20)
    fpk = sorted(grid[pk][np.argsort(S[pk])[-2:]])
    assert abs(fpk[0] + f2) < 0.005 and abs(fpk[1] + f1) < 0.005, fpk


def test_r2R_toeplitz():
    """Autocorr vector -> Hermitian Toeplitz matrix (parity: r_vers_R,
    tsd/stats.hpp:118-133; mirrors test-stats.cc usage)."""
    r = (np.array([3.0, 1.0, 0.5]) + 1j * np.array([0.0, 0.2, -0.1]))
    R = np.asarray(ST.r2R(jnp.asarray(r, jnp.complex64)))
    assert R.shape == (3, 3)
    assert np.allclose(np.diag(R), 3.0)
    assert np.isclose(R[1, 0], r[1]) and np.isclose(R[0, 1], np.conj(r[1]))
    assert np.isclose(R[2, 0], r[2]) and np.isclose(R[0, 2], np.conj(r[2]))
    assert np.allclose(R, R.conj().T)
    # real path: plain symmetric Toeplitz
    Rr = np.asarray(ST.r2R(jnp.asarray(r.real, jnp.float32)))
    assert np.allclose(Rr, Rr.T)
    # batched: last axis is the lag axis
    rb = np.stack([r.real, 2 * r.real])
    Rb = np.asarray(ST.r2R(jnp.asarray(rb, jnp.float32)))
    assert Rb.shape == (2, 3, 3) and np.allclose(Rb[1], 2 * Rb[0])


def test_check_normalized_freq():
    from libtsd_jax.ops import fir_design as FD
    FD.check_normalized_freq(0.25)
    with pytest.raises(ValueError):
        FD.check_normalized_freq(0.7, "design")
    with pytest.raises(ValueError):
        FD.fir_design_windowed(31, "lp", 0.8)
    with pytest.raises(ValueError):
        FD.fir_design_windowed(31, "bp", 0.1, fcut2=0.9)


def test_covmtx_hermitian():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(256) + 1j*rng.standard_normal(256)).astype(np.complex64)
    R = np.asarray(ST.covmtx(jnp.asarray(x), 16))
    assert np.allclose(R, R.conj().T, atol=1e-5)


def test_music_doa():
    # two sources at 60 and 100 degrees, half-wavelength array
    m = 16
    d = 0.5
    angles = np.deg2rad([60.0, 100.0])
    pos = 2*np.pi*d*np.arange(m)
    R = DOA.sensorcov_1d(jnp.asarray(pos), jnp.asarray(angles), snr_db=20.0)
    est = np.sort(np.asarray(DOA.musicdoa_1d(R, d, 2, Nf=1024)))
    assert np.allclose(np.rad2deg(est), [60.0, 100.0], atol=2.0), np.rad2deg(est)


def test_capon_doa():
    # Capon/MVDR resolves the same two incoherent sources MUSIC does
    m, d = 16, 0.5
    angles = np.deg2rad([60.0, 100.0])
    pos = 2 * np.pi * d * np.arange(m)
    R = DOA.sensorcov_1d(jnp.asarray(pos), jnp.asarray(angles),
                         snr_db=20.0)
    est = np.sort(np.asarray(DOA.capondoa_1d(R, d, 2, Nf=1024)))
    assert np.allclose(np.rad2deg(est), [60.0, 100.0], atol=2.0), \
        np.rad2deg(est)


def test_spatial_smoothing_coherent_sources():
    # Two FULLY COHERENT sources (multipath: one common envelope, fixed
    # complex gain) collapse the signal subspace to RANK 1: the MDL
    # source counter sees one source and a model-order-2 subspace method
    # has no rank-2 signal space to work with.  Forward-backward spatial
    # smoothing restores the rank to 2 — MDL then counts both, and MUSIC
    # on the smoothed (L, L) covariance localizes both to <0.5 deg.
    from libtsd_jax.models.stats import mdl_source_count
    m, d, L, T = 16, 0.5, 10, 200
    th = np.deg2rad([70.0, 110.0])
    k = np.arange(m)
    a1 = np.exp(2j * np.pi * d * np.cos(th[0]) * k)
    a2 = np.exp(2j * np.pi * d * np.cos(th[1]) * k)
    rng = np.random.default_rng(11)
    c = (rng.standard_normal(T) + 1j * rng.standard_normal(T)) / 2 ** 0.5
    X = np.outer(a1 + 0.8 * np.exp(1j * 0.7) * a2, c)   # coherent pair
    X += 0.1 * (rng.standard_normal((m, T))
                + 1j * rng.standard_normal((m, T))) / 2 ** 0.5
    R = (X @ X.conj().T / T).astype(np.complex64)
    # raw sample covariance: rank-1 signal subspace -> MDL counts ONE
    assert mdl_source_count(R, T)[0] == 1
    # smoothed: rank restored -> MDL counts TWO, MUSIC resolves both
    Rs = DOA.spatial_smoothing(jnp.asarray(R), L)
    assert Rs.shape == (L, L)
    Rsn = np.asarray(Rs)
    assert mdl_source_count(Rsn, T)[0] == 2
    est = np.sort(np.rad2deg(np.asarray(
        DOA.musicdoa_1d(Rs, d, 2, Nf=1024))))
    assert np.allclose(est, [70.0, 110.0], atol=0.5), est
    # smoothed covariance stays Hermitian PSD
    assert np.allclose(Rsn, Rsn.conj().T, atol=1e-5)
    assert np.linalg.eigvalsh(Rsn).min() > -1e-5
    with pytest.raises(ValueError):
        DOA.spatial_smoothing(jnp.asarray(R), m + 1)


def test_kalman_tracks_random_walk():
    ssm = KF.ssm_random_walk(q=0.01, r=0.5)
    key = jax.random.PRNGKey(0)
    xs, ys = ssm.simulate(key, 500)
    xf, Ps = KF.kalman_filter(ssm, ys)
    err_raw = float(jnp.mean((ys[:, 0] - xs[:, 0]) ** 2))
    err_filt = float(jnp.mean((xf[100:, 0] - xs[100:, 0]) ** 2))
    assert err_filt < 0.35 * err_raw


def test_kalman_constant_converges():
    ssm = KF.ssm_constant(r=1.0)
    key = jax.random.PRNGKey(1)
    x_true = 3.0
    n = 400
    ys = x_true + jax.random.normal(key, (n, 1))
    xf, Ps = KF.kalman_filter(ssm, ys)
    assert abs(float(xf[-1, 0]) - x_true) < 0.15
    # covariance decreases ~1/n
    assert float(Ps[-1, 0, 0]) < 0.02


def test_kalman_steady_gain_matches_filter():
    ssm = KF.ssm_random_walk(q=0.05, r=1.0)
    K = KF.kalman_steady_gain(ssm)
    # closed form for the scalar random walk: K = P/(P+r) with
    # P solving P = P*r/(P+r) + q  (predicted covariance form)
    q, r = 0.05, 1.0
    Pp = (q + np.sqrt(q * q + 4 * q * r)) / 2  # steady predicted covariance
    assert abs(K[0, 0] - Pp / (Pp + r)) < 1e-6


def test_ekf_kitagawa_runs():
    f, g = KF.kitagawa_model()
    key = jax.random.PRNGKey(2)
    n = 100
    # simulate
    s = jnp.asarray([0.1, 0.0])
    xs, ys = [], []
    Q = np.diag([0.5, 0.0])
    R = np.array([[0.5]])
    rngn = np.random.default_rng(5)
    for i in range(n):
        s = f(s) + jnp.asarray([rngn.normal() * np.sqrt(0.5), 0.0])
        xs.append(float(s[0]))
        ys.append(float(g(s)[0]) + rngn.normal() * np.sqrt(0.5))
    xf, Ps = KF.ekf_filter(f, g, Q, R, jnp.asarray(ys)[:, None],
                           x0=jnp.asarray([0.1, 0.0]))
    est = np.abs(np.asarray(xf)[:, 0])
    true = np.abs(np.asarray(xs))
    # EKF on Kitagawa tracks |x| decently (sign is unobservable from x^2)
    corr = np.corrcoef(est[20:], true[20:])[0, 1]
    assert corr > 0.5, corr
