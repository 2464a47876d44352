"""Reference-binary diff, round 4c: the streaming constant-Q transform.

BEHAVIORAL golden, not a sample-level one: our `cqt_stream` redesigns the
reference's CQT::Impl for static shapes (the reference consumes
variable-size chunks per step — `nb_data_attendu` is data-dependent,
cqt.cc:286-291 — which is exactly the dynamic-shape pattern SURVEY §7
rules out under jit; we double the FFT buffer and hop by N/2 instead).  The
kernel truncation grids therefore differ and magnitudes agree only in
shape, so the golden pins what is exactly shared (the geometric bin
grid) and the time/frequency localization behavior on a two-tone signal
analyzed by the actual binary (refbuild/golden_gen6.cc).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


def test_cqt_stream_matches_reference_behavior():
    from libtsd_jax.ops.cqt import (cqt_stream_kernel, cqt_stream,
                                    cqt_interpolate)
    x = g("g6_cqt_x")
    dims = g("g6_cqt_dims").astype(int)
    B = g("g6_cqt_A").reshape(dims[0], dims[1])
    freqs_ref = g("g6_cqt_freqs")

    K = cqt_stream_kernel(0.02, 0.2, 2 ** 0.25, Q=34.0, kprec=0.99,
                          window="hm")
    # (1) the geometric frequency grid is EXACT (same fmin * gamma^k law)
    assert len(K.freqs) == dims[1]
    assert np.abs(K.freqs - freqs_ref).max() < 1e-6

    t, m, v = cqt_stream(jnp.asarray(x, jnp.float32), K)
    _, _, A = cqt_interpolate(t, m, v, K, 256)

    # (2) localization: the 0.05 tone sits at bin 5 (0.02 * 2^(5/4)) for
    # BOTH analyses, in (almost) every time frame
    nr = min(A.shape[0], B.shape[0])
    a, b = A[4:nr - 4], B[4:nr - 4]
    assert np.mean(np.argmax(a, axis=1) == 5) > 0.85
    assert np.mean(np.argmax(b, axis=1) == 5) > 0.8

    # (3) the weaker 0.12 tone (bin ~10) is a local maximum of both
    # time-averaged profiles
    pa = a.mean(0)
    pb = b.mean(0)
    assert pa[10] > pa[9] * 1.2 and pa[10] > pa[11] * 1.2
    assert pb[10] > pb[9] * 1.2 and pb[10] > pb[11] * 1.2

    # (4) overall profile shape tracks the binary (normalized cosine;
    # the kernel-truncation grids differ by design, see module docstring)
    pa = pa / np.linalg.norm(pa)
    pb = pb / np.linalg.norm(pb)
    assert float(pa @ pb) > 0.8


def _run_case(tag, fmin, fmax, gamma):
    from libtsd_jax.ops.cqt import (cqt_stream_kernel, cqt_stream,
                                    cqt_interpolate)
    x = g(tag + "_x")
    dims = g(tag + "_dims").astype(int)
    B = g(tag + "_A").reshape(dims[0], dims[1])
    K = cqt_stream_kernel(fmin, fmax, gamma, Q=34.0, kprec=0.99,
                          window="hm")
    assert len(K.freqs) == dims[1]
    assert np.abs(K.freqs - g(tag + "_freqs")).max() < 1e-6
    t, m, v = cqt_stream(jnp.asarray(x, jnp.float32), K)
    _, _, A = cqt_interpolate(t, m, v, K, 256)
    A = np.asarray(A)
    nr = min(A.shape[0], B.shape[0])
    return A[:nr], B[:nr]


def test_cqt_chirp_ridge_tracks_reference():
    """Full-band linear chirp (0.01 -> 0.3 over 16k samples): every bin's
    kernel is exercised.  In the time range where the instantaneous
    frequency is inside the analysis band, the per-frame argmax ridge of
    our analysis agrees with the binary's to <=1 bin on >=85 % of frames,
    both ridges track the chirp law, and per-frame profiles correlate."""
    A, B = _run_case("g6_chirp", 0.02, 0.2, 2 ** 0.25)
    n = 16384
    rows = np.arange(A.shape[0])
    finst = 0.01 + (0.3 - 0.01) * (rows * 256) / n
    sel = (finst > 0.025) & (finst < 0.18)
    a, b = A[sel], B[sel]
    ra, rb = np.argmax(a, 1), np.argmax(b, 1)
    kexp = np.round(np.log(finst[sel] / 0.02)
                    / np.log(2 ** 0.25)).astype(int)
    assert np.mean(np.abs(ra - rb) <= 1) >= 0.85       # measured 0.94
    assert np.mean(np.abs(ra - kexp) <= 1) >= 0.85     # measured 0.91
    assert np.mean(np.abs(rb - kexp) <= 1) >= 0.9      # measured 1.0
    rc = np.mean([(ai @ bi)
                  / (np.linalg.norm(ai) * np.linalg.norm(bi) + 1e-12)
                  for ai, bi in zip(a, b)])
    assert rc > 0.85                                   # measured 0.92


def test_cqt_impulse_time_localization_matches_reference():
    """Mid-signal impulse: each bin's response peaks where its decimated
    kernel crosses it.  Time-argmax per bin agrees with the binary to
    <=1 interpolated frame on bins >=3 (the lowest bins' long kernels
    land on visibly different truncation grids — the documented 2x-buffer
    deviation), and time-averaged profiles match closely."""
    A, B = _run_case("g6_imp", 0.02, 0.2, 2 ** 0.25)
    a, b = A[4:-4], B[4:-4]
    ta, tb = np.argmax(a, 0), np.argmax(b, 0)
    assert np.abs(ta[3:] - tb[3:]).max() <= 1, (ta, tb)
    pa, pb = a.mean(0), b.mean(0)
    pa, pb = pa / np.linalg.norm(pa), pb / np.linalg.norm(pb)
    assert float(pa @ pb) > 0.98                       # measured 0.993


def test_cqt_dense_grid_three_tone_matches_reference():
    """Sixth-octave bins over a wider span (fmin=0.01, fmax=0.25, 28
    bins) with three tones: the config-dependent kernel synthesis, not
    just the default grid.  The geometric grid is float-exact, the
    per-frame ridge agrees on every frame, and the time-averaged profile
    matches to ~1 %."""
    A, B = _run_case("g6_dense", 0.01, 0.25, 2 ** (1.0 / 6))
    a, b = A[4:-4], B[4:-4]
    ra, rb = np.argmax(a, 1), np.argmax(b, 1)
    assert np.mean(ra == rb) >= 0.95                   # measured 1.0
    pa, pb = a.mean(0), b.mean(0)
    pa, pb = pa / np.linalg.norm(pa), pb / np.linalg.norm(pb)
    assert float(pa @ pb) > 0.995                      # measured 0.9996
    assert np.abs(pa - pb).max() < 0.03                # measured 0.014
