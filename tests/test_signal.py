"""Signal generator and base-toolbox tests (parity strategy: closed forms)."""
import numpy as np
import jax.numpy as jnp

from libtsd_jax.ops import signal as S
from libtsd_jax.ops import rng as R
from libtsd_jax.ops import psd as P
from libtsd_jax.utils.testing import check_max_error
import jax


def test_sigcos_sigsin_sigexp():
    n, f = 100, 0.05
    k = np.arange(n)
    check_max_error(np.asarray(S.sigcos(f, n)), np.cos(2 * np.pi * f * k), 1e-5)
    check_max_error(np.asarray(S.sigsin(f, n)), np.sin(2 * np.pi * f * k), 1e-5)
    check_max_error(np.asarray(S.sigexp(f, n)), np.exp(2j * np.pi * f * k), 1e-5)


def test_sigimp():
    x = np.asarray(S.sigimp(10, 3))
    assert x[3] == 1 and x.sum() == 1


def test_sigtri_period():
    p, n = 8, 32
    x = np.asarray(S.sigtri(p, n))
    assert np.allclose(x[:p], x[p:2 * p])
    assert x.max() == 1.0 and x.min() == -1.0


def test_signyquist():
    x = np.asarray(S.signyquist(6))
    assert np.array_equal(x, [-1, 1, -1, 1, -1, 1])


def test_sigchirp_freq():
    # measured instantaneous frequency must sweep f0 -> f1
    n = 4096
    x = np.asarray(S.sigchirp(0.01, 0.1, n))
    # estimate freq in early and late windows via zero crossings
    def freq_est(seg):
        zc = np.sum(np.abs(np.diff(np.sign(seg)))) / 2
        return zc / (2 * len(seg))
    assert abs(freq_est(x[:512]) - 0.015) < 0.01
    assert abs(freq_est(x[-512:]) - 0.095) < 0.01


def test_unwrap():
    ph = np.linspace(0, 20, 300)
    wrapped = np.angle(np.exp(1j * ph))
    u = np.asarray(S.unwrap_phase(jnp.asarray(wrapped, jnp.float32)))
    check_max_error(u, ph, 1e-4)


def test_db():
    assert abs(float(S.mag2db(10.0)) - 20.0) < 1e-6
    assert abs(float(S.db2mag(20.0)) - 10.0) < 1e-6
    assert abs(float(S.pow2db(100.0)) - 20.0) < 1e-6
    assert abs(float(S.db2pow(20.0)) - 100.0) < 1e-6


def test_wrap():
    assert abs(float(S.wrap_pm_pi(3 * np.pi)) - (-np.pi)) < 1e-6
    assert abs(float(S.wrap_2pi(-0.5)) - (2 * np.pi - 0.5)) < 1e-5


def test_up_down_sample():
    x = jnp.arange(8.0)
    u = np.asarray(S.upsample(x, 3))
    assert u.shape[0] == 24
    assert np.allclose(u[::3], np.arange(8.0))
    assert np.allclose(np.asarray(S.downsample(jnp.asarray(u), 3)), np.arange(8.0))


def test_find():
    x = jnp.asarray([0, 1, 0, 1, 1])
    idx = np.asarray(S.find(x > 0))
    assert np.array_equal(idx, [1, 3, 4])
    assert int(S.find_first(x > 0)) == 1
    assert int(S.find_first(x > 10)) == -1
    assert int(S.find_last(x > 0)) == 4
    assert int(S.find_last(x > 10)) == -1


def test_find_first_local_max():
    x = jnp.asarray([0.0, 1.0, 3.0, 2.0, 5.0, 4.0])
    assert int(S.find_first_local_max(x)) == 2
    assert int(S.find_first_local_max(jnp.arange(5.0))) == -1
    # plateaus are NOT maxima (strict >, reference parity) and short
    # inputs return the sentinel instead of crashing
    assert int(S.find_first_local_max(jnp.asarray([0.0, 2.0, 2.0, 1.0]))) == -1
    assert int(S.find_first_local_max(jnp.arange(2.0))) == -1


def test_sample_hold_trange():
    y = np.asarray(S.sample_hold(jnp.asarray([1.0, 2.0]), 3))
    assert np.array_equal(y, [1, 1, 1, 2, 2, 2])
    t = np.asarray(S.trange(4, 100.0))
    assert np.allclose(t, [0.0, 0.01, 0.02, 0.03])


def test_randn_stats():
    x = np.asarray(R.randn(jax.random.PRNGKey(0), 100_000))
    assert abs(x.mean()) < 0.02
    assert abs(x.std() - 1.0) < 0.02


def test_randcn_stats():
    x = np.asarray(R.randcn(jax.random.PRNGKey(1), 100_000))
    assert abs(np.mean(np.abs(x) ** 2) - 1.0) < 0.02


def test_nco_continuity():
    nco = S.NCO.create(0.0123)
    st = nco.init()
    st, a = nco.gen(st, 100)
    st, b = nco.gen(st, 100)
    full = np.asarray(S.sigexp(0.0123, 200))
    got = np.concatenate([np.asarray(a), np.asarray(b)])
    check_max_error(got, full, 1e-3)


def test_nco_no_drift_long_stream():
    """Regression: the NCO accumulated unwrapped float32 radians (drift
    ~0.5 rad per 1e7 samples); with the static frequency + wrapped-cycle
    ramps the phase after thousands of blocks stays within float32 noise
    of the exact value."""
    f = 0.12345678
    nco = S.NCO.create(f)
    st = nco.init()
    nblk, blk = 2000, 4096
    for _ in range(nblk):
        st, _ = nco.gen(st, blk)
    # exact end phase (float64 host), wrapped to [-pi, pi)
    exact = 2 * np.pi * ((f * nblk * blk) % 1.0)
    exact = (exact + np.pi) % (2 * np.pi) - np.pi
    err = abs(float(st) - exact)
    err = min(err, 2 * np.pi - err)
    assert err < 1e-2, err


def test_freq_estim():
    n = 1024
    f0 = 0.12345
    x = np.exp(2j * np.pi * f0 * np.arange(n)).astype(np.complex64)
    # quadratic interp on |X| has a known O(1/n^2)-level bias; candan2 corrects it
    for m, tol in [("fft", 1.0 / n), ("quadratic", 5e-4), ("candan2", 1e-5)]:
        f = float(P.freq_estim(jnp.asarray(x), m))
        assert abs(f - f0) <= tol + 1e-9, (m, f)


def test_psd_welch_peak():
    rng = np.random.default_rng(0)
    n = 8192
    f0 = 0.125
    x = (np.exp(2j * np.pi * f0 * np.arange(n))
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    freqs, S_db = P.psd_welch(jnp.asarray(x), 512)
    freqs, S_db = np.asarray(freqs), np.asarray(S_db)
    f_peak = freqs[np.argmax(S_db)]
    assert abs(f_peak - f0) < 1e-2
