"""PSD-suite additions (round 3)."""
import jax.numpy as jnp
import numpy as np


def test_periodogram_cqt_oneliner():
    """PSD-suite CQT periodogram (parity: periodogramme_cqt,
    cqt.cc:461-476): two tones land on the right constant-Q bins."""
    from libtsd_jax.ops.psd import periodogram_cqt
    fs = 8000.0
    t = np.arange(8192) / fs
    x = jnp.asarray(np.sin(2 * np.pi * 440 * t)
                    + 0.5 * np.sin(2 * np.pi * 880 * t), jnp.float32)
    tt, ff, A = periodogram_cqt(x, fs, 100.0, 2000.0)
    assert A.shape == (len(tt), len(ff))
    mid = A[A.shape[0] // 2]
    top = ff[np.argsort(mid)[-4:]]
    assert any(abs(f - 440) < 440 * 0.1 for f in top), sorted(top)
    assert any(abs(f - 880) < 880 * 0.1 for f in top), sorted(top)
