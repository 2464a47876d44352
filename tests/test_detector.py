"""Pattern detector (models/detector.py) against a naive NumPy
normalised correlation, plus its streaming and batching properties."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.models.detector import (Detector, DetectorConfig,
                                        detect_pattern)


def _pattern(M, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(M)
            + 1j * rng.standard_normal(M)).astype(np.complex64)


def _sig(n, rng, pat, places):
    x = 0.05 * (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(np.complex64)
    for pos, g, th in places:
        x[pos:pos + len(pat)] += (g * np.exp(1j * th) * pat
                                  ).astype(np.complex64)
    return x


def _naive_score(x, pat):
    """|<pattern, window>| / (|pattern| |window|) for the window ending
    at every sample (zeros before the signal)."""
    M = len(pat)
    pn = np.asarray(pat, np.complex128) / np.linalg.norm(pat)
    xp = np.concatenate([np.zeros(M - 1), np.asarray(x, np.complex128)])
    c = np.correlate(xp, pn, mode="valid")          # sum conj(pn) * x
    e = np.convolve(np.abs(xp) ** 2, np.ones(M), mode="valid")
    return np.minimum(np.abs(c) / np.sqrt(e + 1e-20), 1.0)


@pytest.mark.parametrize("M", [88, 128, 256])
def test_detector_matches_naive_correlation(M):
    rng = np.random.default_rng(M)
    pat = _pattern(M, M)
    places = [(1200, 0.9, 0.5), (5000, 1.1, -0.8)]
    x = _sig(8192, rng, pat, places)
    det, score = detect_pattern(jnp.asarray(x), pat,
                                DetectorConfig(threshold=0.5))
    ref = _naive_score(x, pat)
    assert np.abs(np.asarray(score) - ref).max() < 1e-3
    got = sorted(np.asarray(det.position)[np.asarray(det.valid)].tolist())
    # past the first window (where few samples normalise the score)
    assert [p for p in got if p > M] == [p for p, _, _ in places]
    for p, g, th in places:
        i = list(np.asarray(det.position)).index(p)
        assert abs(float(np.asarray(det.gain)[i]) - g) < 0.05
        assert abs(float(np.asarray(det.theta)[i]) - th) < 0.05


@pytest.mark.parametrize("blocks", [2, 4])
def test_detector_streaming_split_invariance(blocks):
    """The same signal in Ne-multiple blocks gives the detections of one
    shot (the OLA tail, energy window and deferred last-segment
    candidate carry across blocks)."""
    rng = np.random.default_rng(7)
    pat = _pattern(256, 7)
    n = 12288
    x = _sig(n, rng, pat, [(1000, 1.0, 0.3), (5100, 0.8, -0.4),
                           (9800, 1.2, 1.0)])
    det = Detector.create(pat, DetectorConfig(threshold=0.5))

    def run(block):
        block = -(-block // det.Ne) * det.Ne
        xp = np.concatenate([x, np.zeros((-n) % block, np.complex64)])
        st = det.init()
        out = []
        for off in range(0, len(xp), block):
            st, (d, _) = det.step(st, jnp.asarray(xp[off:off + block]))
            pos = np.asarray(d.position) + off
            out += [int(p) for p, v in zip(pos, np.asarray(d.valid)) if v]
        return sorted(out)

    one = run(n)
    assert run(blocks * det.Ne) == one
    assert [p for p in one if p > 256] == [1000, 5100, 9800]


def test_detector_vmap_over_channels_matches_single():
    rng = np.random.default_rng(4)
    pat = _pattern(128, 4)
    C, n = 3, 4096
    xs = np.stack([_sig(n, rng, pat, [(500 + 700 * c, 1.0, 0.2 * c)])
                   for c in range(C)])
    det = Detector.create(pat, DetectorConfig(threshold=0.5, Ne=1024))
    sts = jax.vmap(lambda _: det.init())(jnp.arange(C))
    _, (db, scb) = jax.vmap(det.step)(sts, jnp.asarray(xs))
    for c in range(C):
        _, (d1, sc1) = det.step(det.init(), jnp.asarray(xs[c]))
        assert np.array_equal(np.asarray(d1.valid),
                              np.asarray(db.valid)[c])
        assert np.array_equal(np.asarray(d1.position),
                              np.asarray(db.position)[c])
        # batched FFTs may sum in another order: float32 noise
        np.testing.assert_allclose(np.asarray(sc1), np.asarray(scb)[c],
                                   atol=1e-5)


def test_detector_long_pattern_and_awkward_length():
    rng = np.random.default_rng(5)
    pat = _pattern(1280, 5)
    n = 131 * 128 + 768
    x = _sig(n, rng, pat, [(2000, 1.0, 0.4), (9000, 0.7, -0.2)])
    det, score = detect_pattern(jnp.asarray(x), pat,
                                DetectorConfig(threshold=0.5))
    got = sorted(np.asarray(det.position)[np.asarray(det.valid)].tolist())
    assert got == [2000, 9000]
    assert np.abs(np.asarray(score) - _naive_score(x, pat)).max() < 1e-3


def test_detector_configured_ne_honored():
    det = Detector.create(_pattern(128, 1), DetectorConfig(Ne=2048))
    assert det.Ne == 2048
    assert Detector.create(_pattern(128, 1),
                           DetectorConfig(mode="rif")).Ne == 1
