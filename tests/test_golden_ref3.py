"""Direct numerical diff against the ACTUAL reference binary — round 3:
applications + telecom-support layers, beyond the design/estimation
components covered by test_golden_ref2.py.

Goldens produced by refbuild/golden_gen3.cc (deterministic inputs, no
RNG; `make -C refbuild golden` regenerates bit-for-bit).  Components:
MLS + Barker codes, Kalman filter + steady-state gain on the
random-walk model, MUSIC subspace spectrum (matrix + signal-composite
paths), streaming Matzner SNR, CIC decimator runtime, AM modulator
family (DSB / DSB-SC / USB), Shannon capacity, quaternion/Cardan
geometry, astronomical date/time, fractional-delay interpolator
coefficient generators (cspline / linear / Lagrange / windowed sinc).

REFERENCE DEFECTS found while generating (documented in
refbuild/golden_gen3.cc, verified against the built binary):
 * sensorcov_1d (apps/doa.cc:28) uses the elementwise Tab operator* for
   "A * A.transpose().conjugate()" and throws "dimensions incompatibles"
   for ANY non-square steering matrix — unusable, untested in the
   reference's own suite.  Ours uses a true matrix product.
 * musicdoa_1d's Ns parameter is dead (never forwarded to
   SubSpaceSpectrumConfig.Ns) and the MDL auto-detection it falls back
   to takes index_max of a monotonically decreasing criterion
   (stats.cc:174 — MDL selects a MINIMUM), so the function cannot
   return the requested number of angles.  The golden diff therefore
   targets the working explicit-Ns subspace_spectrum / psd_sousesp
   paths, which our musicdoa_1d builds on.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


# ------------------------------------------------------------ codes

def test_mls_codes_match_reference():
    from libtsd_jax.models.lfsr import mls_code
    for reglen in (5, 7):
        ref = g(f"g3_mls{reglen}")
        ours = np.asarray(mls_code(reglen), np.float32)
        assert ours.shape == ref.shape
        assert np.array_equal(ours, ref), f"MLS reglen={reglen}"


def test_barker_codes_match_reference():
    from libtsd_jax.models.lfsr import barker_code
    for n in (11, 13):
        ref = g(f"g3_barker{n}")
        ours = np.asarray(barker_code(n), np.float32)  # +-1
        assert np.array_equal((ours + 1) / 2, ref), f"Barker n={n}"


# ------------------------------------------------------------ Kalman

def test_kalman_random_walk_matches_reference():
    from libtsd_jax.models.kalman import LinearSSM, kalman_filter
    ssm = LinearSSM(A=np.eye(1), C=np.eye(1),
                    Q=0.01 * np.eye(1), R=0.5 * np.eye(1))
    y = g("g3_kalman_y")
    xs, _ = kalman_filter(ssm, y[:, None],
                          x0=np.zeros(1), P0=np.eye(1))
    ref = g("g3_kalman_xh")
    assert np.abs(np.asarray(xs[:, 0]) - ref).max() < 1e-5


def test_kalman_steady_gain_matches_reference():
    from libtsd_jax.models.kalman import LinearSSM, kalman_steady_gain
    ssm = LinearSSM(A=np.eye(1), C=np.eye(1),
                    Q=0.01 * np.eye(1), R=0.5 * np.eye(1))
    K = kalman_steady_gain(ssm)
    assert abs(float(K[0, 0]) - float(g("g3_kalman_ssg")[0])) < 1e-5


# ------------------------------------------------------------ MUSIC

def test_subspace_spectrum_matches_reference():
    from libtsd_jax.models.stats import subspace_spectrum
    R = g("g3_music_R").reshape(8, 8)
    grid, S = subspace_spectrum(R, 2, 512)
    ref = g("g3_music_spectrum")
    S = np.asarray(S)
    # the dB spectrum spans ~60 dB; peaks (the estimates) must align
    # exactly on the shared grid and the full curve to float32 eig noise
    assert np.argmax(S) == np.argmax(ref)
    assert np.abs(S - ref).max() < 0.2, np.abs(S - ref).max()


def test_psd_subspace_matches_reference():
    from libtsd_jax.models.stats import psd_subspace
    x = g("g3_psdss_x")
    _, S = psd_subspace(x, 2, 512, 16)
    ref = g("g3_psdss")
    S = np.asarray(S)
    assert np.argmax(S) == np.argmax(ref)
    assert np.abs(S - ref).max() < 0.2, np.abs(S - ref).max()


# ------------------------------------------------------------ SNR

def test_matzner_streaming_matches_reference():
    from libtsd_jax.models.snr import MatznerTracker
    x = g("g3_matzner_x")
    tr = MatznerTracker(0.1)
    _, (S, N) = tr.step(tr.init(), x)
    S, N = np.asarray(S), np.asarray(N)
    refS, refN = g("g3_matzner_S"), g("g3_matzner_N")
    # reference-parity warm-up: sqrt(2 e2^2 - e4) is NaN while the moment
    # trackers warm up from 0 — NaN POSITIONS must match exactly, values
    # elsewhere to float32 noise (snr.cc:9-43)
    assert np.array_equal(np.isnan(S), np.isnan(refS))
    assert np.isnan(S[:3]).all() and not np.isnan(S[16:]).any()
    m = ~np.isnan(refS)
    assert np.abs(S[m] - refS[m]).max() < 1e-4
    assert np.abs(N[m] - refN[m]).max() < 1e-4


# ------------------------------------------------------------ CIC

def test_cic_decimator_matches_reference():
    from libtsd_jax.ops.resample import Cic, CicConfig
    x = g("g3_cic_x")  # integer-valued floats
    cic = Cic(config=CicConfig(R=8, N=3, M=1), mode="d")
    _, y = cic.step(cic.init(), x)
    ref = g("g3_cic_y")
    # integer arithmetic end to end: exact
    assert np.array_equal(np.asarray(y), ref)


# ------------------------------------------------------------ AM

def test_am_modulators_match_reference():
    from libtsd_jax.models.analog import AMConfig, am_modulate
    audio = g("g3_am_audio")
    for mode, name, tol in (("dsb", "g3_am_dsb", 2e-6),
                            ("dsb-sc", "g3_am_dsbsc", 2e-6),
                            ("usb", "g3_am_usb", 2e-3)):
        y = am_modulate(audio, AMConfig(mode=mode, index=0.8, f_rf=0.1))
        ref = g(name)
        err = np.abs(np.asarray(y)[: len(ref)] - ref).max()
        assert err < tol, (mode, err)


# ------------------------------------------------------------ capacity

def test_shannon_capacity_matches_reference():
    from libtsd_jax.models.channel import shannon_capacity
    ref = g("g3_capacity")
    for snr_lin, r in zip((0.1, 1.0, 10.0, 100.0), ref):
        c = shannon_capacity(10 * np.log10(snr_lin), 1.0)
        assert abs(float(c) - float(r)) < 1e-5


# ------------------------------------------------------------ geometry

def test_cardan_quaternion_roundtrip_matches_reference():
    from libtsd_jax.utils import geometry as geo
    R = np.asarray(geo.cardan_to_rotmat(0.3, -0.5, 1.2))
    ref_R = g("g3_rotmat").reshape(3, 3)
    assert np.abs(R - ref_R).max() < 1e-5
    q = np.asarray(geo.rotmat_to_quat(R))
    ref_q = g("g3_quat")
    if ref_q[0] * q[0] < 0:
        q = -q  # q and -q encode the same rotation
    assert np.abs(q - ref_q).max() < 1e-5
    # the reference extracts Cardan angles from a QUATERNION with Diebel
    # eq 290 (active convention) even though mat_rotation is passive — its
    # own roundtrip is inconsistent; g3_cardan_rt pins that actual output
    # (see geometry.quat_to_cardan docstring)
    phi, th, psi = geo.quat_to_cardan(jnp.asarray(q))
    ref_c = g("g3_cardan_rt")
    assert np.abs(np.asarray([phi, th, psi]) - ref_c).max() < 1e-5
    # OUR matrix-path pair is a consistent inverse: true roundtrip
    p2, t2, s2 = geo.rotmat_to_cardan(jnp.asarray(ref_R))
    assert np.abs(np.asarray([p2, t2, s2])
                  - np.asarray([0.3, -0.5, 1.2])).max() < 1e-5


# ------------------------------------------------------------ date/time

def test_datetime_j2000_and_sidereal_match_reference():
    from libtsd_jax.utils.timedate import (gregorian_to_jd, sidereal_time,
                                           local_sidereal_time)
    ref = g("g3_time")  # f64
    from libtsd_jax.utils.timedate import j2000
    jd1 = gregorian_to_jd(2021, 2, 8 + 12 / 24)
    jd2 = gregorian_to_jd(2000, 1, 1 + (18 + 30 / 60 + 15 / 3600) / 24)
    # REFERENCE DEFECT (doc vs code): temps.hpp:226 documents J2000() as
    # days since J2000-at-midnight (JD 2451544.5) but temps.cc:348-351
    # subtracts 2415020.0 (the 1900 January 0.5 epoch) — 36524.5 days off
    # its own doc.  The golden pins the binary's actual behavior.
    assert abs(j2000(2021, 2, 8 + 12 / 24) - ref[0]) < 1e-6
    assert abs(j2000(2000, 1, 1 + (18 + 30 / 60 + 15 / 3600) / 24)
               - ref[1]) < 1e-6
    # Greenwich sidereal time (radians); the reference uses the
    # second-based polynomial, we use Meeus' degree polynomial — they
    # agree to ~1e-6 rad
    assert abs(sidereal_time(jd1) - ref[2]) < 1e-5
    assert abs(sidereal_time(jd2) - ref[3]) < 1e-5
    # local: reference adds the longitude in RADIANS; ours takes degrees
    assert abs(local_sidereal_time(jd1, np.rad2deg(2.3488)) - ref[4]) < 1e-4


# ------------------------------------------------------------ interpolators

def test_interpolator_coefs_match_reference():
    from libtsd_jax.ops.resample import (cspline_coefs, linear_coefs,
                                         lagrange_coefs)
    ref = g("g3_itrp")
    ours = []
    for tau in (0.25, 0.75):
        ours += [cspline_coefs(tau), linear_coefs(tau),
                 lagrange_coefs(3, tau)]
    ours = np.concatenate([np.asarray(c, np.float32) for c in ours])
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() < 1e-6


def test_sinc_interpolator_coefs_match_reference():
    from libtsd_jax.ops.resample import sinc_interp_coefs
    ref = g("g3_itrp_sinc")  # 2 x 15 taps, UNNORMALIZED (reference)
    for i, tau in enumerate((0.25, 0.75)):
        r = ref[i * 15:(i + 1) * 15]
        ours = sinc_interp_coefs(15, 0.5, tau)  # ours normalizes to sum 1
        assert np.abs(ours - r / r.sum()).max() < 1e-6, tau
