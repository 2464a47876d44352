"""FFT-layer tests: analytic DFTs, round trips, CZT, Goertzel, Hadamard,
fractional delay — mirrors core/tests/test-fourier.cc:182-256 strategy."""
import numpy as np
import pytest
import jax.numpy as jnp

from libtsd_jax.ops import fft as F
from libtsd_jax.utils.testing import check_max_error


def test_fft_impulse():
    # DFT of impulse = constant 1/sqrt(n) (orthonormal convention)
    n = 64
    x = np.zeros(n); x[0] = 1.0
    X = np.asarray(F.fft(np.asarray(x, np.float32)))
    check_max_error(X, np.full(n, 1 / np.sqrt(n), dtype=complex), 1e-6)


def test_fft_constant():
    n = 128
    x = np.ones(n, np.float32)
    X = np.asarray(F.fft(x))
    expected = np.zeros(n, complex); expected[0] = np.sqrt(n)
    check_max_error(X, expected, 1e-4)


def test_fft_tone():
    n = 256
    k0 = 17
    x = np.exp(2j * np.pi * k0 * np.arange(n) / n).astype(np.complex64)
    X = np.asarray(F.fft(x))
    expected = np.zeros(n, complex); expected[k0] = np.sqrt(n)
    check_max_error(X, expected, 1e-3)


@pytest.mark.parametrize("n", [64, 100, 255])
def test_fft_roundtrip(n):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    y = np.asarray(F.ifft(F.fft(x)))
    check_max_error(y, x, 1e-5)


def test_fft_parseval():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(512).astype(np.float32)
    X = np.asarray(F.fft(x))
    assert abs(np.sum(np.abs(X) ** 2) - np.sum(x ** 2)) < 1e-2


def test_rfft_matches_fft():
    rng = np.random.default_rng(2)
    x = rng.standard_normal(128).astype(np.float32)
    X = np.asarray(F.fft(x))[:65]
    Xr = np.asarray(F.rfft(x))
    check_max_error(Xr, X, 1e-5)


@pytest.mark.parametrize("n,m", [(64, 64), (100, 128), (37, 37)])
def test_czt_matches_dft(n, m):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    W = np.exp(-2j * np.pi / m)
    y = np.asarray(F.czt(x, m, W, 1.0))
    # czt on the unit circle with W = exp(-2pi i/m) = unnormalized DFT (zero
    # padded to m)
    # brute-force chirp-Z reference works for ANY (m, n) — no silent
    # no-assert path if an m < n case is ever parametrized
    k = np.arange(m)[:, None]
    j = np.arange(n)[None, :]
    expected = (np.asarray(x, complex)[None, :]
                * (1.0 * W ** (k * j))).sum(axis=1)
    check_max_error(y, expected, 2e-3)


def test_czt_zoom():
    # zoom transform: evaluate DFT on a fine grid around a tone
    n = 128
    f0 = 0.1234
    x = np.exp(2j * np.pi * f0 * np.arange(n)).astype(np.complex64)
    m = 64
    f_start, f_step = 0.12, 0.0002
    W = np.exp(-2j * np.pi * f_step)
    z0 = np.exp(2j * np.pi * f_start)
    y = np.abs(np.asarray(F.czt(x, m, W, z0)))
    f_est = f_start + f_step * np.argmax(y)
    assert abs(f_est - f0) < 2 * f_step


def test_goertzel():
    n = 1000
    f = 0.1
    x = np.cos(2 * np.pi * f * np.arange(n)).astype(np.float32)
    p = float(F.goertzel(x, f))
    assert abs(p - 1.0) < 0.01  # pure tone at f -> normalized power ~ 1
    p2 = float(F.goertzel(x, 0.3))
    assert p2 < 0.01


def test_wht():
    n = 64
    rng = np.random.default_rng(4)
    x = rng.standard_normal(n).astype(np.float32)
    H = np.asarray(F.hadamard(n))
    y = np.asarray(F.wht(x))
    check_max_error(y, H @ x, 1e-3)


def test_delay_integer():
    x = np.arange(16, dtype=np.float32)
    y = np.asarray(F.delay_signal(x, 3))
    assert np.allclose(y[3:], x[:-3])
    assert np.allclose(y[:3], 0)


def test_delay_fractional():
    # delay a bandlimited signal by 0.5 and compare against analytic shift
    n = 256
    t = np.arange(n)
    f = 0.05
    x = np.cos(2 * np.pi * f * t).astype(np.float32)
    y = np.asarray(F.delay_signal(x, 0.5))
    expected = np.cos(2 * np.pi * f * (t - 0.5))
    # ignore edges (wraparound effects)
    check_max_error(y[16:-16], expected[16:-16], 1e-2)


def test_resample_freq():
    n = 256
    x = np.cos(2 * np.pi * 0.02 * np.arange(n)).astype(np.float32)
    y = np.asarray(F.resample_freq(x, 2.0))
    assert y.shape[0] == 512
    expected = np.cos(2 * np.pi * 0.01 * np.arange(512))
    check_max_error(y[32:-32], expected[32:-32], 5e-2)


def test_force_csym():
    rng = np.random.default_rng(5)
    X = (rng.standard_normal(64) + 1j * rng.standard_normal(64)).astype(np.complex64)
    Xs = np.asarray(F.force_csym(X))
    x = np.fft.ifft(Xs)
    assert np.max(np.abs(x.imag)) < 1e-5


def test_ola_complexity():
    C, Nf, Nz, Ne = F.ola_complexity_optimize(256)
    assert Nf & (Nf - 1) == 0
    assert Ne + 255 <= Nf
    # must beat the naive choice Ne = Nf - M + 1 with Nf = 512
    C512, _, _ = F.ola_complexity(256, 512 - 255)
    assert C <= C512


@pytest.mark.parametrize("N", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_fft_pow2_batched_vs_numpy(N):
    """Orthonormal fft/ifft at the power-of-two lengths the spectrum
    paths use, batched, against np.fft; the inverse round-trips."""
    rng = np.random.default_rng(N)
    x = (rng.standard_normal((3, N))
         + 1j * rng.standard_normal((3, N))).astype(np.complex64)
    X = np.asarray(F.fft(jnp.asarray(x)))
    ref = np.fft.fft(x.astype(np.complex128), axis=-1) / np.sqrt(N)
    assert np.max(np.abs(X - ref)) / np.max(np.abs(ref)) < 1e-5
    rt = np.asarray(F.ifft(jnp.asarray(X)))
    assert np.max(np.abs(rt - x)) < 1e-4


@pytest.mark.parametrize("n", [256, 512, 1024])
def test_fft_honors_n(n):
    """n pads or truncates first, as in np.fft."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(300)
         + 1j * rng.standard_normal(300)).astype(np.complex64)
    y = np.asarray(F.fft(jnp.asarray(x), n=n))
    ref = np.fft.fft(x.astype(np.complex128), n=n) / np.sqrt(n)
    assert y.shape == (n,)
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-5
    yi = np.asarray(F.ifft(jnp.asarray(x), n=n))
    refi = np.fft.ifft(x.astype(np.complex128), n=n) * np.sqrt(n)
    assert np.max(np.abs(yi - refi)) / np.max(np.abs(refi)) < 1e-5


def test_fft_axis0_and_grad():
    """axis=0 transforms, and reverse-mode autodiff through fft: the
    gradient of sum |fft(v)|^2 is 2v (Parseval, orthonormal)."""
    import jax
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((512, 5))
         + 1j * rng.standard_normal((512, 5))).astype(np.complex64)
    X = np.asarray(F.fft(jnp.asarray(x), axis=0))
    ref = np.fft.fft(x.astype(np.complex128), axis=0) / np.sqrt(512)
    assert np.max(np.abs(X - ref)) / np.max(np.abs(ref)) < 1e-5
    v = rng.standard_normal(512).astype(np.float32)
    g = np.asarray(jax.grad(lambda u: jnp.sum(
        jnp.abs(F.fft(u.astype(np.complex64))) ** 2))(jnp.asarray(v)))
    assert np.max(np.abs(g - 2 * v)) < 1e-4


def test_resample_freq_odd_n_upsampling_amplitude():
    """Odd-n upsampling must keep conjugate symmetry: the reference
    copies only n//2 positive bins (fourier.cc:1406), halving the
    near-Nyquist component — documented defect, fixed here."""
    n = 15
    k = np.arange(n)
    x = jnp.asarray(np.cos(2 * np.pi * (7 / 15) * k), jnp.float32)
    y = np.asarray(F.resample_freq(x, 2.0))
    # the tone must come back at full amplitude at the doubled rate
    k2 = np.arange(2 * n)
    ref = np.cos(2 * np.pi * (7 / 30) * k2)
    amp = np.max(np.abs(np.fft.fft(y))) / np.max(np.abs(np.fft.fft(ref)))
    assert abs(amp - 1.0) < 0.05, amp
