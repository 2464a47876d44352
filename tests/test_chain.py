"""FIR + framed 4096-point periodogram (ops/chain.py, ops/pallas/chain.py).

The plain XLA version and the Triton kernel (in the Pallas interpreter)
against a float64 NumPy/SciPy chain: lfilter, framed np.fft, sum of
|X|^2.  Bounds: the plain version runs at full float32 precision; the
kernel's bfloat16 DFT stages are held to the reference's large-n FFT
tolerance, 1e-2 of the peak (/root/reference/core/tests/
test-fourier.cc:256).  The kernel on the card is checked by
``chip_smoke.py`` at deployment sizes.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.ops.chain import (fir_periodogram4096,
                                  fir_periodogram4096_plain, toeplitz_blocks)
from libtsd_jax.ops.filter_rt import fir_toeplitz_mats
from libtsd_jax.ops.fir_design import fir_lowpass
from libtsd_jax.ops.pallas import chain as KC
from libtsd_jax.utils.testing import fir_periodogram_ref as _ref

NFFT = 4096


def _signal(dtype, C, N, seed=0):
    """Noise plus a strong tone, in the ingest dtype."""
    rng = np.random.default_rng(seed)
    t = np.arange(N)
    tone = np.cos(2 * np.pi * 0.05 * t)
    if dtype == "int16":
        x = rng.integers(-2048, 2048, (C, N)) + 3000 * tone
        return x.astype(np.int16)
    if dtype == "int8":
        x = rng.integers(-40, 40, (C, N)) + 80 * tone
        return x.astype(np.int8)
    return (rng.standard_normal((C, N)) + 2 * tone).astype(np.float32)


def _to_jax(x, dtype):
    return (jnp.asarray(x, jnp.bfloat16) if dtype == "bfloat16"
            else jnp.asarray(x))


@pytest.mark.parametrize("dtype", ["int16", "int8", "float32", "bfloat16"])
@pytest.mark.parametrize("nframes", [2, 5])
def test_plain_matches_float64(dtype, nframes):
    h = np.asarray(fir_lowpass(256, 0.2))
    x = _signal("float32" if dtype == "bfloat16" else dtype, 2,
                nframes * NFFT)
    xj = _to_jax(x, dtype)
    ref = _ref(np.asarray(xj.astype(jnp.float32)), h)
    got = np.asarray(fir_periodogram4096_plain(xj, jnp.asarray(h)))
    assert got.shape == (2, NFFT) and got.dtype == np.float32
    assert np.abs(got - ref).max() / ref.max() < 1e-5


@pytest.mark.parametrize("K", [3, 128, 129, 256])
def test_plain_tap_counts(K):
    h = np.random.default_rng(K).standard_normal(K) / K
    x = _signal("float32", 1, 2 * NFFT)
    ref = _ref(x, h)
    got = np.asarray(fir_periodogram4096_plain(jnp.asarray(x),
                                               jnp.asarray(h)))
    assert np.abs(got - ref).max() / ref.max() < 1e-5


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_plain_multi_call_state(dtype):
    """Two calls chained through ``hist`` (the last K-1 samples of the
    first call) sum to one call over the whole signal."""
    h = np.asarray(fir_lowpass(256, 0.2))
    x = _signal(dtype, 2, 4 * NFFT)
    a, b = x[:, :2 * NFFT], x[:, 2 * NFFT:]
    one = np.asarray(fir_periodogram4096_plain(jnp.asarray(x),
                                               jnp.asarray(h)))
    pa = np.asarray(fir_periodogram4096_plain(jnp.asarray(a),
                                              jnp.asarray(h)))
    pb = np.asarray(fir_periodogram4096_plain(
        jnp.asarray(b), jnp.asarray(h), jnp.asarray(a[:, -255:])))
    assert np.abs(pa + pb - one).max() / one.max() < 1e-5
    ref_b = _ref(b, h, hist=a[:, -255:])
    assert np.abs(pb - ref_b).max() / ref_b.max() < 1e-5


@pytest.mark.parametrize("dtype", ["int16", "int8", "float32", "bfloat16"])
@pytest.mark.parametrize("K", [256, 33])
def test_kernel_interpret_matches_float64(dtype, K):
    h = np.asarray(fir_lowpass(K, 0.2))
    x = _signal("float32" if dtype == "bfloat16" else dtype, 2, 3 * NFFT)
    xj = _to_jax(x, dtype)
    ref = _ref(np.asarray(xj.astype(jnp.float32)), h, skip_first=True)
    got = np.asarray(KC.fir_periodogram4096_kernel(
        xj, jnp.asarray(h, jnp.float32), interpret=True))
    assert np.abs(got - ref).max() / ref.max() < 1e-2


def test_kernel_plus_first_frame_is_whole_chain():
    """The GPU wrapper's split — kernel over frames 1.., plain over
    frame 0 with the history — equals the chain with that history."""
    h = np.asarray(fir_lowpass(256, 0.2))
    x = _signal("int16", 2, 2 * NFFT)
    hist = _signal("int16", 2, 255, seed=1)
    k = KC.fir_periodogram4096_kernel(jnp.asarray(x),
                                      jnp.asarray(h, jnp.float32),
                                      interpret=True)
    first = fir_periodogram4096_plain(jnp.asarray(x[:, :NFFT]),
                                      jnp.asarray(h), jnp.asarray(hist))
    ref = _ref(x, h, hist=hist)
    got = np.asarray(k + first)
    assert np.abs(got - ref).max() / ref.max() < 1e-2


def test_dispatch_off_gpu_is_plain():
    h = jnp.asarray(fir_lowpass(64, 0.3))
    x = jnp.asarray(_signal("float32", 1, 2 * NFFT))
    np.testing.assert_array_equal(np.asarray(fir_periodogram4096(x, h)),
                                  np.asarray(fir_periodogram4096_plain(x, h)))


@pytest.mark.parametrize("K", [2, 100, 256, 257])
def test_kernel_toeplitz_blocks_match_host_builder(K):
    h = np.random.default_rng(K).standard_normal(K)
    got = np.asarray(toeplitz_blocks(jnp.asarray(h, jnp.float32), 64))
    exp = fir_toeplitz_mats(h, L=64)
    assert got.shape == exp.shape
    np.testing.assert_allclose(got, exp, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("nframes,F", [(1024, 32), (48, 16), (5, 1),
                                       (2, 2)])
def test_frames_per_program(nframes, F):
    assert KC.frames_per_program(nframes) == F


def test_kernel_rejects_partial_frame():
    with pytest.raises(AssertionError):
        KC.fir_periodogram4096_kernel(jnp.zeros((1, 5000), jnp.int16),
                                      jnp.ones((8,), jnp.float32),
                                      interpret=True)


def test_kernel_dft_factors_are_the_dft():
    """Two 64-point stages with the twiddles equal the 4096-point DFT."""
    wr, wi, twr, twi = KC._dft_factors()
    W = (np.asarray(wr, np.float64) + 1j * np.asarray(wi, np.float64))
    TW = np.asarray(twr) + 1j * np.asarray(twi)
    y = np.random.default_rng(0).standard_normal(NFFT)
    Z = ((W @ y.reshape(64, 64)) * TW) @ W
    got = Z.T.reshape(-1)      # bin k1 + 64 k2 is Z[k1, k2]
    exp = np.fft.fft(y)
    assert np.abs(got - exp).max() / np.abs(exp).max() < 1e-2
