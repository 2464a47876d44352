"""Utils (wav/time/geometry/monitor), viz, CQT/DWT tests."""
import os
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.utils import wav as WAV
from libtsd_jax.utils import timedate as TD
from libtsd_jax.utils import geometry as GEO
from libtsd_jax.utils.monitor import Monitor, Monitors
from libtsd_jax.ops import dwt as DW
from libtsd_jax.ops import cqt as CQ
from libtsd_jax import viz as VZ


def test_wav_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal(1000) * 0.3, -0.99, 0.99).astype(np.float32)
    p = str(tmp_path / "t.wav")
    WAV.wav_save(p, x, 8000, "int16")
    y, rate = WAV.wav_load(p)
    assert rate == 8000
    assert np.max(np.abs(y - x)) < 1e-4


def test_wav_float32_stereo(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((500, 2)).astype(np.float32) * 0.5
    p = str(tmp_path / "s.wav")
    WAV.wav_save(p, x, 44100, "float32")
    y, rate = WAV.wav_load(p)
    assert y.shape == (500, 2)
    assert np.max(np.abs(y - x)) < 1e-7


def test_wav_streaming(tmp_path):
    x = np.sin(2 * np.pi * 0.01 * np.arange(2000)).astype(np.float32)
    p = str(tmp_path / "str.wav")
    with WAV.WavWriter(p, 16000) as w:
        for i in range(0, 2000, 300):
            w.write(x[i:i + 300])
    r = WAV.WavReader(p)
    chunks = []
    while not r.eof:
        chunks.append(r.read(512))
    y = np.concatenate(chunks)
    assert len(y) == 2000
    assert np.max(np.abs(y - x)) < 1e-4


def test_julian_day_known_values():
    # J2000.0 epoch: 2000-01-01 12:00 TT = JD 2451545.0
    assert abs(TD.gregorian_to_jd(2000, 1, 1.5) - 2451545.0) < 1e-9
    # round trip
    y, m, d = TD.jd_to_gregorian(2451545.0)
    assert (y, m) == (2000, 1) and abs(d - 1.5) < 1e-9


def test_leap_years():
    assert TD.is_leap_year(2000) and TD.is_leap_year(2024)
    assert not TD.is_leap_year(1900) and not TD.is_leap_year(2023)
    assert TD.days_in_month(2024, 2) == 29


def test_unit_formatting():
    """SI-prefixed engineering units (parity: tsd::vue::unites,
    unites.cc:8-155; mirrors test_unites, test-figure-old.cc:11-30)."""
    from libtsd_jax.viz import (calc_expo_ndigits, calc_expo_ndigits_common,
                                si_tick_formatter, unit_format)
    assert unit_format(1500, "Hz") == "1.5 KHz"
    assert unit_format(2.5e7, "Hz") == "25 MHz"
    assert unit_format(3e9, "Hz") == "3 GHz"
    assert unit_format(0.0005, "s") == "500 us"
    assert unit_format(0.25, "V") == "250 mV"
    assert unit_format(42, "") == "42"
    assert unit_format(0, "Hz") == "0 Hz"
    assert calc_expo_ndigits(1500, "Hz") == (3, 1)
    assert calc_expo_ndigits_common([0, 1000, 2500], "Hz") == (3, 1)
    # shared exponent across the tick vector
    assert si_tick_formatter([0, 1000, 2000, 2500], "Hz") == [
        "0.0 KHz", "1.0 KHz", "2.0 KHz", "2.5 KHz"]
    # Figure renders with unit ticks
    import matplotlib
    matplotlib.use("Agg")
    import tempfile, os
    f = VZ.Figure("u")
    f.plot(np.linspace(0, 5e6, 50), np.sin(np.linspace(0, 20, 50)))
    f.set_units("Hz", "V")
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "u.png")
        f.save(p)
        assert os.path.getsize(p) > 0


def test_year_validity():
    # parity: année_est_valide / année_mois_valide, temps.cc:190-195,394-397
    assert TD.year_is_valid(1) and TD.year_is_valid(9999)
    assert not TD.year_is_valid(0) and not TD.year_is_valid(10000)
    assert TD.year_month_valid(2024, 12)
    assert not TD.year_month_valid(2024, 13)
    assert not TD.year_month_valid(0, 1)
    assert not TD.is_leap_year(0)


def test_sidereal_time():
    # GMST at 2000-01-01 12:00 UT ~ 18h 41m 50s = 280.46 deg
    jd = 2451545.0
    gmst = np.rad2deg(TD.sidereal_time(jd))
    assert abs(gmst - 280.46061837) < 1e-6


def test_quaternion_rotation():
    q = GEO.quat_from_axis_angle([0, 0, 1], np.pi / 2)
    v = jnp.asarray([1.0, 0.0, 0.0])
    r = np.asarray(GEO.quat_rotate(q, v))
    assert np.allclose(r, [0, 1, 0], atol=1e-6)
    R = np.asarray(GEO.quat_to_rotmat(q))
    assert np.allclose(R @ np.asarray(v), [0, 1, 0], atol=1e-6)


def test_quat_rotmat_roundtrip():
    rng = np.random.default_rng(2)
    for _ in range(5):
        q = GEO.quat_normalize(jnp.asarray(rng.standard_normal(4),
                                           jnp.float32))
        R = GEO.quat_to_rotmat(q)
        q2 = GEO.rotmat_to_quat(R)
        # q and -q are the same rotation
        d = min(float(jnp.linalg.norm(q - q2)),
                float(jnp.linalg.norm(q + q2)))
        assert d < 1e-5


def test_cardan_roundtrip():
    phi, theta, psi = 0.3, -0.5, 1.2
    R = GEO.cardan_to_rotmat(phi, theta, psi)
    p2, t2, s2 = GEO.rotmat_to_cardan(R)
    assert np.allclose([float(p2), float(t2), float(s2)],
                       [phi, theta, psi], atol=1e-6)


def test_monitors():
    mons = Monitors()
    import time
    with mons["stage/a"].scope(samples=1000):
        time.sleep(0.01)
    with mons["stage/b"].scope(samples=500):
        time.sleep(0.005)
    s = mons.stats()
    assert s["stage/a"].count == 1
    assert s["stage/a"].total_s >= 0.009
    assert s["stage/a"].samples_per_s > 0
    assert "stage/a" in mons.report()


@pytest.mark.parametrize("name", ["haar", "db4", "bior"])
def test_dwt_roundtrip(name):
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(512), jnp.float32)
    y = DW.idwt(DW.dwt(x, name, levels=4), name)
    assert float(jnp.max(jnp.abs(y - x))) < 1e-5


def test_dwt2_roundtrip():
    rng = np.random.default_rng(4)
    img = jnp.asarray(rng.standard_normal((64, 128)), jnp.float32)
    rec = DW.idwt2(*DW.dwt2(img, "db4"), "db4")
    assert float(jnp.max(jnp.abs(rec - img))) < 1e-5


def test_dwt_compresses_smooth_signal():
    # most energy should land in the approximation band
    x = jnp.sin(2 * jnp.pi * 0.01 * jnp.arange(256)).astype(jnp.float32)
    a, d = DW.dwt_level(x, "db4")
    ea = float(jnp.sum(a ** 2))
    ed = float(jnp.sum(d ** 2))
    assert ea > 100 * ed


def test_cqt_tone():
    ker = CQ.cqt_kernel(0.01, 0.25, 12)
    f0 = 0.05
    x = jnp.cos(2 * jnp.pi * f0 * jnp.arange(8192)).astype(jnp.float32)
    M = CQ.cqt(x, ker, hop=512)
    km = int(jnp.argmax(jnp.mean(M, axis=0)))
    assert abs(ker.freqs[km] - f0) / f0 < 0.03  # within one bin


def test_figure_and_report(tmp_path):
    from libtsd_jax.viz import Figure, Figures
    from libtsd_jax.viz.report import Report
    rep = Report(str(tmp_path / "rep"))
    f = Figure("test")
    f.plot(np.sin(np.linspace(0, 10, 100)), fmt="b-", label="sine")
    f.plot_psd(np.sin(2 * np.pi * 0.1 * np.arange(256)))
    rep.add_figure(f, "figure one")
    fs = Figures()
    fs.subplot().plot(np.arange(10), fmt="r-")
    fs.subplot().plot_iq(np.exp(2j * np.pi * np.linspace(0, 1, 50)))
    rep.add_figure(fs, "subplots")
    rep.printf("hello report")
    rep.flush()
    assert os.path.exists(str(tmp_path / "rep" / "index.html"))
    assert os.path.exists(str(tmp_path / "rep" / "img" / "img-0.png"))
    html = open(str(tmp_path / "rep" / "index.html")).read()
    assert "hello report" in html and "img-1.png" in html


def test_frat_algebra_and_simplify():
    """FRat rational algebra (parity: frat.hpp:16-916)."""
    from libtsd_jax.ops.poly import FRat
    f = FRat.from_zpk([0.5, 2.0], [0.5, 0.9], 3.0)
    g = f.simplify()
    assert np.allclose(sorted(g.zeros.real), [2.0])
    assert np.allclose(sorted(g.poles.real), [0.9])
    for x in [1.7, -0.3 + 1j, 0.2]:
        assert abs(f(x) - g(x)) < 1e-9
    h = FRat.make([1, 2], [1, 0, 0.25])
    prod = (h * h.inv()).simplify()
    assert len(prod.zeros) == 0 and len(prod.poles) == 0
    assert abs(prod(0.7) - 1.0) < 1e-9
    s = h + 1.0
    assert abs(s(0.3) - (h(0.3) + 1.0)) < 1e-12


def test_duration_algebra():
    """Duration/HourComposite arithmetic (parity: temps.cc:51-331)."""
    from libtsd_jax.utils.timedate import (Calendar, DateTime, Duration,
                                           HourComposite, TimeOfDay,
                                           datetime_add, datetime_diff)
    d = Duration.hours(1) + Duration.minutes(30)
    assert d.total_minutes == 90
    assert (2 * d).total_hours == 3
    assert (d - Duration.minutes(30)).total_seconds == 3600
    assert Duration.days(1) > d
    hc = HourComposite.parse("12:34:56.250")
    assert (hc.hour, hc.minutes, hc.seconds, hc.ms) == (12, 34, 56, 250)
    assert hc.is_valid()
    assert not HourComposite(25, 0, 0).is_valid()
    rt = HourComposite.from_duration(hc.to_duration())
    assert rt == hc
    dt = DateTime(Calendar(2024, 3, 1), TimeOfDay(12, 0, 0.0))
    dt2 = datetime_add(dt, Duration.days(1.5))
    diff = datetime_diff(dt2, dt)
    assert abs(diff.total_days - 1.5) < 1e-9
    assert dt2.cal.day == 3  # 2024-03-03 00:00


def test_plot_plz_and_ellipse(tmp_path):
    from libtsd_jax.viz.figure import (plot_plz, covariance_ellipse,
                                       plot_covariance_ellipse, Figure)
    from libtsd_jax.ops import iir_design as ID
    # plot a REAL designed filter (not dead hardcoded literals)
    zpk = ID.design_iir(4, "lp", "butt", 0.1)
    b, a = zpk.to_ba()
    f = plot_plz(np.asarray(b), np.asarray(a))
    f.save(str(tmp_path / "plz.png"))
    assert (tmp_path / "plz.png").exists()

    P = np.array([[2.0, 0.8], [0.8, 1.0]])
    xs, ys = covariance_ellipse(P, center=(1.0, -1.0), nsig=2.0)
    # points satisfy the ellipse equation (x-c)' P^-1 (x-c) = nsig^2
    v = np.vstack([xs - 1.0, ys + 1.0])
    q = np.einsum("in,ij,jn->n", v, np.linalg.inv(P), v)
    assert np.allclose(q, 4.0, atol=1e-6)
    fig = Figure("ellipse")
    plot_covariance_ellipse(fig, P, (1.0, -1.0), 2.0)
    fig.save(str(tmp_path / "ell.png"))


def test_cic_analyse_figures(tmp_path):
    from libtsd_jax.viz.figure import cic_analyse
    from libtsd_jax.ops.resample import CicConfig
    cfg = CicConfig(R=8, N=4, M=1)
    figs, metrics = cic_analyse(cfg, fe=1.0, comp_ncoefs=31)
    assert metrics["droop_db"] < 0          # droop is a loss
    assert metrics["alias_rejection_db"] > 20
    assert metrics["add_bits"] >= 8
    assert "comp_ripple_db" in metrics
    figs.save(str(tmp_path / "cic.png"))
    assert (tmp_path / "cic.png").exists()


def test_rotmat_to_quat_180_degree_branches():
    """Shepperd's method must survive 180-degree rotations (the
    trace-only branch collapsed them to the identity quaternion)."""
    from libtsd_jax.utils.geometry import (quat_to_rotmat, rotmat_to_quat)
    cases = [np.diag([1.0, -1.0, -1.0]),     # 180 about x
             np.diag([-1.0, 1.0, -1.0]),     # 180 about y
             np.diag([-1.0, -1.0, 1.0])]     # 180 about z
    for R in cases:
        q = np.asarray(rotmat_to_quat(jnp.asarray(R, jnp.float32)))
        R2 = np.asarray(quat_to_rotmat(jnp.asarray(q)))
        assert np.max(np.abs(R2 - R)) < 1e-5, (R, q)
    # near-180: the dominant axis component must be ~1, not ~0
    th = np.pi - 1e-3
    R = np.array([[1, 0, 0],
                  [0, np.cos(th), -np.sin(th)],
                  [0, np.sin(th), np.cos(th)]])
    q = np.asarray(rotmat_to_quat(jnp.asarray(R, jnp.float32)))
    assert abs(q[1]) > 0.999
    R2 = np.asarray(quat_to_rotmat(jnp.asarray(q)))
    assert np.max(np.abs(R2 - R)) < 1e-4


def test_julian_calendar_roundtrip():
    """Pre-1582 dates are Julian-calendar: encoder and decoder must
    agree (they did not — the encoder always applied the Gregorian
    correction)."""
    from libtsd_jax.utils.timedate import gregorian_to_jd, jd_to_gregorian
    for ymd in [(1500, 1, 1), (1000, 6, 15), (4, 2, 29), (1582, 10, 4),
                (1582, 10, 15), (2021, 2, 8)]:
        y, m, d = ymd
        jd = gregorian_to_jd(y, m, float(d))
        y2, m2, d2 = jd_to_gregorian(jd)
        assert (y2, m2, round(d2, 6)) == (y, m, float(d)), (ymd, (y2, m2, d2))
    # the 10 skipped days of the reform: Oct 4 (Julian) + 1 day = Oct 15
    assert gregorian_to_jd(1582, 10, 15.0) - gregorian_to_jd(
        1582, 10, 4.0) == 1.0


def test_wav_streaming_writer_reader(tmp_path):
    """True streaming: the writer appends to disk per write (header
    patched at close), the reader freads only what's asked."""
    from libtsd_jax.utils.wav import WavReader, WavWriter, wav_load
    p = str(tmp_path / "s.wav")
    rng = np.random.default_rng(0)
    chunks = [rng.standard_normal(n).astype(np.float32) * 0.5
              for n in (1000, 37, 4096)]
    with WavWriter(p, rate=8000, dtype="float32") as w:
        for c in chunks:
            w.write(c)
        # bytes are on disk BEFORE close (truncate-proof streaming)
        import os
        assert os.path.getsize(p) >= sum(len(c) for c in chunks) * 4
    full, rate = wav_load(p)
    assert rate == 8000
    assert np.array_equal(full, np.concatenate(chunks))
    with WavReader(p) as r:
        assert r.nsamples == len(full)
        got = []
        while not r.eof:
            got.append(r.read(777))
        assert np.array_equal(np.concatenate(got), full)


def test_figure_titles_preserve_axis_labels():
    from libtsd_jax.viz.figure import Figure
    f = Figure()
    f.plot_psd(np.random.default_rng(0).standard_normal(256))
    f.titles("My PSD")
    assert f._title == "My PSD"
    assert f._xlabel == "Frequency" and f._ylabel == "PSD (dB)"


def test_plot_filter_panel(tmp_path):
    """plot_filter (parity: plot_filtre, filtre-plot.cc): one-call
    design panel for FIR taps and (b, a) IIR, complete mode includes
    phase/group-delay/step/pole-zero subplots."""
    import os
    from libtsd_jax.ops.fir_design import fir_lowpass
    from libtsd_jax.ops.iir_design import design_iir
    from libtsd_jax.viz import plot_filter
    figs = plot_filter(fir_lowpass(63, 0.2))
    p1 = str(tmp_path / "fir.png")
    figs.save(p1)
    assert os.path.getsize(p1) > 1000
    assert len(figs._subs) == 2
    b, a = design_iir(4, "lp", "butt", 0.2).to_ba()
    figs = plot_filter(b, a, complete=True)
    assert len(figs._subs) == 6
    p2 = str(tmp_path / "iir.png")
    figs.save(p2)
    assert os.path.getsize(p2) > 1000
