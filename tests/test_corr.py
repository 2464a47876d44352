"""Correlation tests vs naive O(n^2) references — mirrors xcorr_ref in
core/tests/test-fourier.cc:477-570."""
import numpy as np
import jax.numpy as jnp
import pytest

from libtsd_jax.ops import corr as C
from libtsd_jax.utils.testing import check_max_error


def naive_ccorr(x0, x1):
    m = len(x0)
    return np.array([
        np.sum(x0 * np.conj(np.roll(x1, -k))) / m for k in range(m)
    ])


def naive_xcorrb(x, y, m):
    n = len(x)
    lags = np.arange(-(m - 1), m)
    out = []
    for k in lags:
        acc = 0.0 + 0j
        for i in range(n):
            j = i + k
            if 0 <= j < n:
                acc += x[i] * np.conj(y[j])
        out.append(acc / n)
    return lags, np.array(out)


@pytest.fixture
def signals():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(np.complex64)
    y = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(np.complex64)
    return x, y


def test_ccorr(signals):
    x, y = signals
    _, c = C.ccorr(x, y)
    check_max_error(np.asarray(c), naive_ccorr(x, y), 1e-5)


def test_ccorr_auto_peak(signals):
    x, _ = signals
    _, c = C.ccorr(x, x)
    c = np.asarray(c)
    # lag-0 autocorrelation is the mean power, and is the max
    assert abs(c[0] - np.mean(np.abs(x) ** 2)) < 1e-5
    assert np.argmax(np.abs(c)) == 0


def test_xcorrb(signals):
    x, y = signals
    lags, c = C.xcorrb(x, y, 16)
    nl, nc = naive_xcorrb(x, y, 16)
    assert np.array_equal(np.asarray(lags), nl)
    check_max_error(np.asarray(c), nc, 1e-5)


def test_xcorr_unbiased(signals):
    x, _ = signals
    n = len(x)
    lags, c = C.xcorr(x, x, n)
    nl, nc = naive_xcorrb(x, x, n)
    unbias = n / (n - np.abs(nl))
    check_max_error(np.asarray(c), nc * unbias, 1e-4)


def test_estimate_delay():
    rng = np.random.default_rng(8)
    x = rng.standard_normal(512).astype(np.float32)
    d_true = 37
    y = np.roll(x, d_true)
    y[:d_true] = 0
    d, score = C.estimate_delay(x, y)
    assert abs(float(d) - d_true) < 0.5
    assert float(score) > 0.8


def test_estimate_delay_fractional():
    # bandlimited signal, fractional shift via freq domain
    n = 1024
    rng = np.random.default_rng(9)
    X = np.zeros(n, complex)
    X[1:100] = rng.standard_normal(99) + 1j * rng.standard_normal(99)
    x = np.fft.ifft(X).real.astype(np.float32)
    d_true = 20.3
    k = np.fft.fftfreq(n)
    y = np.fft.ifft(np.fft.fft(x) * np.exp(-2j * np.pi * k * d_true)).real.astype(np.float32)
    d, score = C.estimate_delay(x, y)
    assert abs(float(d) - d_true) < 0.1
    assert float(score) > 0.9


def test_coherence(signals):
    x, _ = signals
    # identical signals: MSC = 1 at every bin
    c = np.asarray(C.coherence(x, x))
    check_max_error(c, np.ones_like(c), 1e-4)
    # INDEPENDENT signals: MSC must be far from 1 (the reference's own
    # formula is identically 1 for ANY pair — documented defect; this
    # pins that ours is the real Welch-averaged estimator)
    rng = np.random.default_rng(5)
    a = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    b = jnp.asarray(rng.standard_normal(4096), jnp.float32)
    c2 = np.asarray(C.coherence(a, b))
    assert np.mean(c2) < 0.5, np.mean(c2)
    # and a shared narrowband component shows up as high local coherence
    t = np.arange(4096)
    tone = np.sin(2 * np.pi * 0.1 * t).astype(np.float32)
    c3 = np.asarray(C.coherence(a + 5 * jnp.asarray(tone),
                                b + 5 * jnp.asarray(tone), N=256))
    k = int(round(0.1 * 256))
    assert c3[k] > 0.9, c3[k]


def test_align_int_zero_fill_not_circular():
    """Regression: align_int used a circular roll — |delay| wrapped
    samples contaminated the aligned tail."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(1000).astype(np.float32)
    d = 100
    y = np.concatenate([np.zeros(d, np.float32), x[:-d]])
    xa, ya, di = C.align_int(jnp.asarray(x), jnp.asarray(y))
    assert int(di) == d
    xa, ya = np.asarray(xa), np.asarray(ya)
    # aligned region matches; the zero-filled tail must NOT contain
    # wrapped leading samples of y
    check_max_error(ya[: 1000 - d], xa[: 1000 - d], 1e-5)
    assert np.all(ya[1000 - d:] == 0)


def test_xcorr_edge_cases():
    """m=1 single-lag result; unequal lengths (reference pads to common
    length); boundary peak skips parabolic refinement."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal(64).astype(np.float32)
    lags, c = C.xcorrb(jnp.asarray(x), jnp.asarray(x), m=1)
    assert lags.shape == (1,) and c.shape[-1] == 1
    assert abs(float(jnp.real(c[0])) - float(np.mean(x * x))) < 1e-4
    # unequal lengths: y shorter than x
    y = x[:50]
    d, score = C.estimate_delay(jnp.asarray(x), jnp.asarray(y))
    assert abs(float(d)) < 1.0  # same start, just truncated


def _gauss_pulse(n):
    """Gaussian-windowed pulse (parity: test_signal, test-fourier.cc)."""
    t = np.arange(n, dtype=np.float64)
    c = n / 2.0
    env = np.exp(-((t - c) / (n / 8.0)) ** 2)
    return (env * np.cos(2 * np.pi * 0.05 * t)).astype(np.complex64)


@pytest.mark.parametrize("n", [32, 1024, 15 * 1024])
def test_estimate_delay_sweep(n):
    """Parity sweep of estimation_delais (test-fourier.cc:409-528,
    705-729): integer and fractional delays across signal lengths, with
    the reference's tolerances (0.02 position, 0.1 at N=32; score within
    0.4 of 1), and its scale-invariance check (x0*=7, x1*=4)."""
    from libtsd_jax.ops.fft import delay_signal
    delays = [0.0, 1.0, 10.0, 1.1] if n == 32 else \
        [0.0, 1.0, 10.0, 20.0, 40.0, -50.0, 11.0, 1.1]
    x0 = _gauss_pulse(n)
    tol = 0.1 if n == 32 else 0.02
    for d in delays:
        x1 = np.asarray(delay_signal(jnp.asarray(x0), d))
        dd, score = C.estimate_delay(jnp.asarray(7 * x0),
                                     jnp.asarray(4 * x1))
        err = abs(float(dd) - d)
        assert err < tol, (n, d, float(dd), err)
        assert abs(float(score) - 1.0) < 0.4, (n, d, float(score))
