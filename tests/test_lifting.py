"""Lifting-scheme wavelet tests: generic engine, Laurent/polyphase/QMF,
Euclidean factorization, and the real bior-3.5 (ops/lifting.py; parity:
tod.cc:40-266 + the dead bior code at :271-313 done properly)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.ops.lifting import (
    Laurent, Lift, LiftStep, cdf_filters, factor_lifting, lift_bior35,
    lift_cdf53, lift_db2, lift_dwt, lift_dwt_level, lift_haar, lift_idwt,
    lift_idwt_level, lift_polyphase, lift_qmf)

rng = np.random.default_rng(7)


@pytest.mark.parametrize("mk", [lift_haar, lift_db2, lift_cdf53,
                                lift_bior35])
def test_perfect_reconstruction(mk):
    lf = mk()
    x = jnp.asarray(rng.standard_normal((3, 128)), jnp.float32)
    s, d = lift_dwt_level(x, lf)
    xr = lift_idwt_level(s, d, lf)
    assert float(jnp.max(jnp.abs(xr - x))) < 2e-5, lf.name


def test_multilevel_pr():
    lf = lift_bior35()
    x = jnp.asarray(rng.standard_normal(256), jnp.float32)
    coeffs = lift_dwt(x, lf, levels=3)
    assert [c.shape[-1] for c in coeffs] == [128, 64, 32, 32]
    xr = lift_idwt(coeffs, lf)
    assert float(jnp.max(jnp.abs(xr - x))) < 5e-5


def test_qmf_haar_db2():
    """QMF extraction (parity: QMF, tod.cc:75-97) gives the known
    orthogonal filters."""
    h0, _ = lift_qmf(lift_haar())
    assert np.allclose(np.trim_zeros(h0), [1 / np.sqrt(2)] * 2, atol=1e-12)
    h0, _ = lift_qmf(lift_db2())
    db2 = np.array([1 + np.sqrt(3), 3 + np.sqrt(3), 3 - np.sqrt(3),
                    1 - np.sqrt(3)]) / (4 * np.sqrt(2))
    got = np.trim_zeros(h0)
    assert np.allclose(got, db2, atol=1e-10), got


def test_bior35_filters_exact():
    """The factored lifting steps reproduce the CDF(3,5) analysis lowpass
    (the published bior3.5 dec_lo, length 12) exactly."""
    dec_lo, rec_lo = cdf_filters(3, 5)
    assert len(dec_lo) == 12 and len(rec_lo) == 4
    # B-spline synthesis side: sqrt(2)*(1,3,3,1)/8
    assert np.allclose(rec_lo, np.sqrt(2) * np.array([1, 3, 3, 1]) / 8)
    h0, _ = lift_qmf(lift_bior35())
    assert np.allclose(np.trim_zeros(h0), dec_lo, atol=1e-8)


def test_bior35_vanishing_moments():
    """3 primal vanishing moments: polynomials up to degree 2 produce
    (numerically) zero detail coefficients."""
    lf = lift_bior35()
    for p in range(3):
        t = (np.arange(256, dtype=np.float64) / 256.0) ** p
        _, d = lift_dwt_level(jnp.asarray(t, jnp.float32), lf)
        assert np.max(np.abs(np.asarray(d)[20:-20])) < 1e-5, p


def test_factor_roundtrip_random_complementary():
    """factor_lifting inverts lift_polyphase on a nontrivial scheme."""
    lf = Lift("rand", (LiftStep((0.4, -0.3), -1, True),
                       LiftStep((0.25, 0.1), 0, False),
                       LiftStep((-0.7,), 1, True)), K=1.3)
    (a, b), (c, d) = lift_polyphase(lf)
    lf2 = factor_lifting(a, b, c, d, "re")
    x = jnp.asarray(rng.standard_normal(64), jnp.float32)
    s1, d1 = lift_dwt_level(x, lf)
    s2, d2 = lift_dwt_level(x, lf2)
    assert float(jnp.max(jnp.abs(s1 - s2))) < 1e-5
    assert float(jnp.max(jnp.abs(d1 - d2))) < 1e-5


def test_laurent_algebra():
    a = Laurent.make([1.0, 2.0], -1)    # z^-1 + 2
    b = Laurent.make([3.0], 1)          # 3z
    assert (a * b).n0 == 0
    assert np.allclose((a * b).coefs, [3.0, 6.0])
    assert (a + (-a)).is_zero
