"""Direct numerical diff against the ACTUAL reference binary — round 4:
the last untested composites.  Goldens from
refbuild/golden_gen4.cc (`make -C refbuild golden` regenerates).

Components: broadcast FM demodulation chain (mono path), adaptive
equalizer trajectories (FFE/DFE x DEC/CMA, reference-parity real-tap
mode), dispersive Rayleigh/Rice channel statistics, real-time spectrum
sweep composite, MDL auto source-count branch.

REFERENCE DEFECTS found while generating (documented in
refbuild/golden_gen4.cc, verified against the built binary):
 * FMDemod's stereo pilot RPLL reads an UNINITIALIZED RPLLConfig.freq
   (telecom.hpp:1682; analogique.cc:497-500) — UB, so only the mono
   chain is diffable; our fm_broadcast_demodulate ships a working
   stereo path (tests/test_telecom2.py exercises the separation).
 * Tab::operator+=(cfloat) is declared but never defined, so the RICE
   branch of CanalDispersif does not LINK against the shipped library.
 * canal_dispersif's constructor unconditionally renders debug figures
   (simulation.cc:65), which segfaults headless; the golden replays its
   exact math + RNG stream through the same reference calls.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


# ------------------------------------------------------- broadcast FM

def test_fm_broadcast_mono_matches_reference():
    from libtsd_jax.models.analog import _fm_broadcast_front
    from libtsd_jax.models.analog import fm_broadcast_mono
    fe = 600e3
    x = jnp.asarray(g("g4_fm_x"))
    a3, fech2, R = _fm_broadcast_front(x, fe)
    assert R == 4 and fech2 == fe / 4
    ref_a3 = g("g4_fm_a3")
    a3 = np.asarray(a3)[: len(ref_a3)]
    s = np.abs(ref_a3).max()
    # the reference FMDiscri has a 3-sample cnt<=2 special case plus a
    # stateful pre-polar pass (analogique.cc:37-62) that only shapes the
    # first few outputs; steady state is EXACT (measured 0 beyond the
    # first ~64 decimated samples)
    assert np.abs(a3[64:] - ref_a3[64:]).max() < 1e-4 * s
    lpr = np.asarray(fm_broadcast_mono(x, fe))
    ref = g("g4_fm_lpr")
    # skip the discri transient propagated through the 255-tap audio FIR
    assert np.abs(lpr[384: len(ref)] - ref[384:]).max() < 1e-4 * s


# --------------------------------------------------------- equalizers

@pytest.mark.parametrize("name,structure,errf,alpha,n2", [
    ("g4_eq_ffe_dec", "ffe", "dec", 0.01, 11),
    ("g4_eq_ffe_cma", "ffe", "cma", 0.002, 11),
    ("g4_eq_dfe_dec", "dfe", "dec", 0.01, 7),
])
def test_equalizer_trajectory_matches_reference(name, structure, errf,
                                                alpha, n2):
    """Full 2000-sample output trajectories in ref_mode (real taps,
    end-init, alpha*real(wnd*conj(e)) updates — egalisation.cc:29-178):
    pins the update equations and gains sample for sample."""
    from libtsd_jax.models.equalizer import LmsEqualizer
    from libtsd_jax.models import waveform as WF
    wf = WF.wf_qpsk(WF.PulseShape.nrz())
    eq = LmsEqualizer(wf=wf, structure=structure, errf=errf, K=1,
                      alpha=alpha, N1=11, N2=n2, ref_mode=True)
    x = jnp.asarray(g("g4_eq_x"))
    _, (y, err, act) = eq.step(eq.init(), x)
    ref = g(name)
    d = np.abs(np.asarray(y) - ref)
    # trajectories are iterative; float32 noise accumulates through the
    # update recursion — 1e-3 on unit-power symbols is lockstep
    assert d.max() < 1e-3, d.max()


# ------------------------------------------------- dispersive channel

def _doppler_bw(h, fe, frac=0.9):
    """Two-sided bandwidth holding `frac` of the process energy."""
    H = np.abs(np.fft.fftshift(np.fft.fft(h - h.mean()))) ** 2
    f = np.fft.fftshift(np.fft.fftfreq(len(h), 1.0 / fe))
    c = np.cumsum(H) / H.sum()
    lo = f[np.searchsorted(c, (1 - frac) / 2)]
    hi = f[np.searchsorted(c, 1 - (1 - frac) / 2)]
    return hi - lo


def test_dispersive_rayleigh_stats_match_reference():
    """The reference's fading process (seeded binary run) and ours must
    agree on the STATISTICS (the noise streams differ by construction):
    Rayleigh envelope law and Jakes-limited Doppler bandwidth."""
    import jax
    from libtsd_jax.models.channel import dispersive_channel
    fd, fe = 50.0, 10000.0
    ref = g("g4_disp_y")
    ours = np.asarray(dispersive_channel(
        jax.random.PRNGKey(5), jnp.ones(len(ref), jnp.complex64), fd, fe))
    for h in (ref, ours):
        p2 = np.mean(np.abs(h) ** 2)
        p4 = np.mean(np.abs(h) ** 4)
        # complex-Gaussian (Rayleigh envelope): E|h|^4 / (E|h|^2)^2 = 2
        assert abs(p4 / p2 ** 2 - 2.0) < 0.45, p4 / p2 ** 2
        bw = _doppler_bw(h, fe)
        assert bw < 2.4 * fd, bw      # energy confined to ~+-fd
        assert bw > 0.3 * fd, bw


def test_dispersive_rice_stats_match_reference():
    """Rice K=4: moment-based K estimate gamma = var(|h|^2)/E[|h|^2]^2 =
    (1+2K)/(1+K)^2 agrees between the reference process and ours."""
    import jax
    from libtsd_jax.models.channel import dispersive_channel
    ref = g("g4_disp_rice_y")
    ours = np.asarray(dispersive_channel(
        jax.random.PRNGKey(6), jnp.ones(len(ref), jnp.complex64),
        50.0, 10000.0, rice_factor=4.0))

    def gamma(h):
        p = np.abs(h) ** 2
        return p.var() / p.mean() ** 2

    expect = (1 + 2 * 4.0) / (1 + 4.0) ** 2      # 0.36
    assert abs(gamma(ours) - expect) < 0.15, gamma(ours)
    # The reference's Rice process is measurably SUB-Rayleigh (LOS
    # present: gamma < the Rayleigh value of 1) but its effective K is
    # still diluted (golden gamma ~0.57 ~ K_eff ~1.1, not 4): its
    # normalization divides by sqrt of the COMPLEX mean of b^2
    # (simulation.cc:84) and the Doppler filter + resampler rescale LOS
    # and diffuse parts differently.  (The golden is generated with the
    # reference's FILE-LOCAL randnc — split draws, unit TOTAL variance,
    # simulation.cc:14-20; an earlier generator used the public randcn,
    # 2x power, which further halved K_eff to ~0.45.)  Ours implements
    # the standard K/(K+1) split and hits the theoretical moment.
    # Assert both show a LOS (ordering), ours quantitatively.
    ray = g("g4_disp_y")
    assert gamma(ref) < 0.75 < gamma(ray) * 1.5, (gamma(ref), gamma(ray))


# ------------------------------------------------- rt_spectrum sweep

def test_rt_spectrum_sweep_matches_reference():
    """Composite sweep assembly, per-capture masking, hit-count
    normalization and nmeans averaging vs the binary.  Known-convention
    offset: the reference divides the averaged power by an extra nsubs
    (fourier.cc:1277) which makes flat unit noise read -10log10(nsubs)
    dB; our normalization keeps E|FFT|^2/N = sigma^2 (0 dB).  Measured
    against the binary the net constant offset is EXACTLY
    10 log10(N * nsubs) dB (orthonormal FFT + the extra /Nf and /nsubs
    divisions, fourier.cc:119 + :1277); the composite SHAPE (masking,
    hit-count normalization, nmeans averaging, span assembly) matches to
    <0.001 dB after removing it."""
    from libtsd_jax.ops.spectrum import RtSpectrum, SpectrumConfig
    sizes = g("g4_spec_sizes")
    Nf, Ns, y0rows = int(sizes[0]), int(sizes[1]), int(sizes[2])
    assert y0rows == 0       # nmeans=2: first block emits nothing
    cfg = SpectrumConfig(N=Nf, navg=1, nsubs=4, sweep_step=128,
                         mask_hf=8, mask_bf=4)
    assert cfg.Ns == Ns
    sp = RtSpectrum.create(cfg)
    x = jnp.concatenate([jnp.asarray(g("g4_spec_x1")),
                         jnp.asarray(g("g4_spec_x2"))])
    # both captures in one step = the reference's nmeans=2 accumulate
    _, db = sp.step(sp.init(), x)
    ref = g("g4_spec_y")
    ours = np.asarray(db) - 10 * np.log10(cfg.N * cfg.nsubs)
    # compare where the reference is above its noise floor (dB diffs at
    # the -250 dB masked floor are meaningless)
    m = ref > ref.max() - 80
    assert m.sum() > 150      # masked zones + floor excluded
    assert np.abs(ours[m] - ref[m]).max() < 0.01, np.abs(ours[m] - ref[m]).max()


# ------------------------------------------------------------- MDL

def test_mdl_auto_selection_matches_reference():
    """Ns=-1 branch: mdl_criterion reproduces the binary's (defective)
    argmax selection; the spectrum at that Ns matches bin for bin."""
    from libtsd_jax.models.stats import mdl_criterion, subspace_spectrum
    R = g("g4_mdl_R").reshape(8, 8)
    ns_ref_binary = int(g("g4_mdl_ns")[0])
    vmdl, ns_ours = mdl_criterion(R)
    assert ns_ours == ns_ref_binary
    _, S = subspace_spectrum(jnp.asarray(R), ns_ref_binary, 256)
    ref = g("g4_mdl_spectrum")
    S = np.asarray(S)
    assert np.argmax(S) == np.argmax(ref)
    assert np.abs(S - ref).max() < 0.2, np.abs(S - ref).max()
