"""Tests that need the GPU: the chain kernel as compiled for the card.

They skip off the GPU (the ``gpu`` fixture decides at run time) and are
run on the card by ``python chip_smoke.py`` (its on-card test phase
calls each test with every case in ``chip_cases``).
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu

NFFT = 4096


@pytest.fixture
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; chip_smoke.py runs these on the card")


CHAIN_CASES = [("int16", 256, 8), ("int8", 256, 8), ("float32", 33, 8),
               ("bfloat16", 256, 8), ("int16", 257, 5), ("float32", 256, 64)]


@pytest.mark.parametrize("dtype,K,nframes", CHAIN_CASES)
def test_chain_kernel_on_card_matches_float64(gpu, dtype, K, nframes):
    """The compiled kernel (through the public dispatch) against the
    float64 chain and the plain version, 1e-2 of the peak."""
    import jax.numpy as jnp
    from libtsd_jax.ops.chain import (fir_periodogram4096,
                                      fir_periodogram4096_plain)
    from libtsd_jax.ops.fir_design import fir_lowpass
    from libtsd_jax.utils.testing import fir_periodogram_ref
    rng = np.random.default_rng(K + nframes)
    C, N = 4, nframes * NFFT
    tone = np.cos(2 * np.pi * 0.05 * np.arange(N))
    if dtype == "int16":
        x = (rng.integers(-2048, 2048, (C, N)) + 3000 * tone).astype(np.int16)
    elif dtype == "int8":
        x = (rng.integers(-40, 40, (C, N)) + 80 * tone).astype(np.int8)
    else:
        x = (rng.standard_normal((C, N)) + 2 * tone).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else None)
    h = jnp.asarray(fir_lowpass(K, 0.2), jnp.float32)
    got = np.asarray(fir_periodogram4096(xj, h))
    ref = fir_periodogram_ref(np.asarray(xj.astype(jnp.float32)), h)
    assert np.abs(got - ref).max() / ref.max() < 1e-2
    plain = np.asarray(fir_periodogram4096_plain(xj, h))
    assert np.abs(plain - ref).max() / ref.max() < 1e-5


test_chain_kernel_on_card_matches_float64.chip_cases = CHAIN_CASES
