"""Gap-closing tests: logging, ct functions, Dirichlet, streaming Goertzel,
Rpll, polyphase form, checkpoint/resume, eye diagram."""
import os
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.utils import log as L
from libtsd_jax.utils import checkpoint as CKPT
from libtsd_jax.ops import ct as CT
from libtsd_jax.ops.fft import goertzel_stream
from libtsd_jax.ops.resample import polyphase_form, ipolyphase_form
from libtsd_jax.models.carrier_rec import Rpll, CpllConfig


def test_logging_sink():
    records = []
    L.set_logger(lambda r: records.append(r), min_level="info")
    L.msg("hello {}", 42)
    L.msg_warn("careful")
    L.msg_error("bad")
    L.set_logger(None, min_level="warn")  # restore default
    assert [r.level for r in records] == ["info", "warn", "error"]
    assert records[0].text == "hello 42"
    assert records[0].line > 0
    assert "test_misc2" in records[0].file


def test_sampled_function():
    sf = CT.sample_function(lambda t: jnp.sin(2 * jnp.pi * t), 0.0, 1.0, 101)
    # interpolation at arbitrary points
    v = float(sf(0.25))
    assert abs(v - 1.0) < 1e-3
    assert abs(float(sf.energy()) - 0.5) < 0.02  # integral of sin^2 over 1s


def test_sampled_function_fourier():
    f0 = 5.0
    sf = CT.sample_function(lambda t: jnp.cos(2 * jnp.pi * f0 * t),
                            0.0, 2.0, 512)
    f, X = sf.fourier()
    f, X = np.asarray(f), np.asarray(X)
    fpk = abs(f[np.argmax(np.abs(X))])
    assert abs(fpk - f0) < 0.3


def test_dirichlet():
    assert abs(float(CT.dirichlet(5, 0.0)) - 11.0) < 1e-5
    # matches the closed form away from 0
    w = 0.7
    expect = np.sin(5.5 * w) / np.sin(w / 2)
    assert abs(float(CT.dirichlet(5, w)) - expect) < 1e-4


def test_goertzel_stream():
    f = 0.125
    R = 128
    x = jnp.cos(2 * jnp.pi * f * jnp.arange(1024)).astype(jnp.float32)
    p = np.asarray(goertzel_stream(x, f, R))
    assert p.shape == (8,)
    assert np.all(np.abs(p - 1.0) < 0.02)
    p2 = np.asarray(goertzel_stream(x, 0.3, R))
    assert np.all(p2 < 0.02)


def test_rpll_locks_real_carrier():
    # real carrier at 0.2 with slow phase drift; Rpll downconverts + locks
    n = 4000
    k = np.arange(n)
    phase = 0.5 + 2 * np.pi * 1e-4 * k
    x = jnp.asarray(np.cos(2 * np.pi * 0.2 * k + phase), jnp.float32)
    pll = Rpll.create(0.2, CpllConfig(ped="tloop", M=1, order=2, BL=0.02))
    _, y = pll.step(pll.init(), x)
    y = np.asarray(y)[2000:]
    # locked: output phase near 0 (real positive)... amplitude 0.5 from
    # mixing a real carrier
    ang = np.angle(y)
    assert np.abs(np.angle(np.exp(1j * ang))).mean() < 0.3


def test_polyphase_form_roundtrip():
    x = jnp.arange(24.0)
    X = polyphase_form(x, 4)
    assert X.shape == (4, 6)
    assert np.array_equal(np.asarray(X[1]), np.arange(1.0, 24, 4))
    y = ipolyphase_form(X)
    assert np.array_equal(np.asarray(y), np.asarray(x))


def test_checkpoint_roundtrip(tmp_path):
    from libtsd_jax.ops import filter_rt as FR
    from libtsd_jax.ops import fir_design as FD
    h = FD.fir_lowpass(33, 0.1)
    blk = FR.Fir.create(h)
    rng = np.random.default_rng(0)
    x1 = jnp.asarray(rng.standard_normal(256), jnp.float32)
    x2 = jnp.asarray(rng.standard_normal(256), jnp.float32)
    st = blk.init()
    st, y1 = blk.step(st, x1)
    # checkpoint mid-stream, restore, continue
    path = str(tmp_path / "state.npz")
    CKPT.save_state(path, st)
    st2 = CKPT.load_state(path, blk.init())
    _, y2a = blk.step(st, x2)
    _, y2b = blk.step(st2, x2)
    assert np.array_equal(np.asarray(y2a), np.asarray(y2b))


def test_checkpoint_complex_state_as_planes(tmp_path):
    """Complex leaves are saved/restored as re/im planes (config.to_ri)
    and a mismatched tree structure is rejected."""
    import pytest
    from libtsd_jax.ops import filter_rt as FR
    from libtsd_jax.ops import fir_design as FD
    h = FD.fir_lowpass(17, 0.2)
    blk = FR.Fir.create(h)
    rng = np.random.default_rng(3)
    xc = jnp.asarray(rng.standard_normal(128)
                     + 1j * rng.standard_normal(128), jnp.complex64)
    st = blk.init_for(xc)
    st, _ = blk.step(st, xc)
    path = str(tmp_path / "cstate.npz")
    CKPT.save_state(path, st)
    # no raw complex array inside the file
    raw = np.load(path)
    assert all(not np.iscomplexobj(raw[k]) for k in raw.files)
    st2 = CKPT.load_state(path, blk.init_for(xc))
    x2 = jnp.asarray(rng.standard_normal(128), jnp.float32).astype(
        jnp.complex64)
    _, ya = blk.step(st, x2)
    _, yb = blk.step(st2, x2)
    assert np.allclose(np.asarray(ya), np.asarray(yb))
    # structural mismatch detected
    with pytest.raises(ValueError):
        CKPT.load_state(path, (st,))


def test_checkpoint_bytes_roundtrip():
    state = {"a": jnp.arange(5.0), "b": (jnp.zeros(3), jnp.ones((2, 2)))}
    b = CKPT.state_bytes(state)
    st2 = CKPT.state_from_bytes(b, state)
    assert np.array_equal(np.asarray(st2["a"]), np.arange(5.0))
    assert np.array_equal(np.asarray(st2["b"][1]), np.ones((2, 2)))


def test_eye_diagram(tmp_path):
    from libtsd_jax.viz.figure import plot_eye
    from libtsd_jax.models import waveform as WF
    from libtsd_jax.models.modulator import ModConfig, Modulator
    from libtsd_jax.models.bitstream import randbits
    wf = WF.wf_bpsk(WF.PulseShape.rcs(0.3))
    mod = Modulator.create(ModConfig(wf=wf, fe=8.0, fsymb=1.0))
    x, _ = mod.modulate(randbits(jax.random.PRNGKey(0), 200))
    f = plot_eye(np.asarray(x), osf=8)
    p = str(tmp_path / "eye.png")
    f.save(p)
    assert os.path.exists(p) and os.path.getsize(p) > 5000


def test_resample_freq_degenerate_guards():
    """REGRESSION: n2 == 1 crashed with a broadcast error (the -0 slice);
    a ratio rounding to the same length returned x*sqrt(ratio)."""
    import jax.numpy as jnp
    import numpy as np
    import pytest as _pytest
    from libtsd_jax.ops.fft import resample_freq
    x = jnp.asarray(np.arange(16.0, dtype=np.float32))
    with _pytest.raises(ValueError):
        resample_freq(x, 1.0 / 16)
    y = resample_freq(jnp.asarray(np.arange(10.0, dtype=np.float32)), 1.01)
    assert np.allclose(np.asarray(y), np.arange(10.0))


def test_kalman_steady_gain_iters_guard():
    import pytest as _pytest
    import numpy as np
    from libtsd_jax.models.kalman import LinearSSM, kalman_steady_gain
    ssm = LinearSSM(A=np.eye(1), C=np.eye(1),
                    Q=np.eye(1) * 0.1, R=np.eye(1))
    with _pytest.raises(ValueError):
        kalman_steady_gain(ssm, iters=0)
