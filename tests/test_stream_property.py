"""Randomized streaming-split property sweep: every stateful runtime
block must produce IDENTICAL output regardless of how the input is
split into step() calls (the block-state contract the whole serving
layer and the time-sharded parallel layer rest on).

Existing per-block tests pin one fixed split; this sweep drives each
block through several RANDOM split patterns (seeded, deterministic)
against the one-shot run.  This test class found real bugs in earlier
rounds (DcBlocker seed, OlaFft complex-taps-on-real, K=1 state growth,
clock_rec2 zero-front-pad) — keep it when adding blocks.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.ops import filter_rt as FR
from libtsd_jax.ops import fir_design as FD
from libtsd_jax.ops import iir_design as ID
from libtsd_jax.ops import resample as RS

rng = np.random.default_rng(0)


def _splits(n: int, gran: int, seed: int):
    """Random split of n into chunks, each a positive multiple of gran."""
    r = np.random.default_rng(seed)
    units = n // gran
    cuts = sorted(set(r.integers(1, units, size=5).tolist()) - {0})
    pts = [0] + [c * gran for c in cuts] + [units * gran]
    return [(a, b) for a, b in zip(pts[:-1], pts[1:]) if b > a]


def _stream(blk, x, gran, seed):
    st = blk.init_for(x) if hasattr(blk, "init_for") else blk.init()
    outs = []
    for a, b in _splits(x.shape[-1], gran, seed):
        st, y = blk.step(st, x[..., a:b])
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=-1)


def _case(name):
    n = 2048
    if name == "fir_real":
        x = rng.standard_normal(n).astype(np.float32)
        return FR.Fir.create(rng.standard_normal(47)), jnp.asarray(x), 1
    if name == "fir_complex_taps":
        x = (rng.standard_normal(n)
             + 1j * rng.standard_normal(n)).astype(np.complex64)
        h = (rng.standard_normal(33)
             + 1j * rng.standard_normal(33)).astype(np.complex64)
        return FR.Fir.create(h), jnp.asarray(x), 1
    if name == "fir_batched":
        x = rng.standard_normal((3, n)).astype(np.float32)
        return FR.Fir.create(rng.standard_normal(21)), jnp.asarray(x), 1
    if name == "iir":
        zpk = ID.design_iir(4, "lp", "butt", 0.2)
        b, a = zpk.to_ba()
        x = rng.standard_normal(n).astype(np.float32)
        return FR.Iir.create(b, a), jnp.asarray(x), 1
    if name == "sos":
        zpk = ID.design_iir(5, "lp", "cheb1", 0.15)
        sos, kk = ID.zpk_to_sos(zpk)
        x = rng.standard_normal(n).astype(np.float32)
        return FR.Sos.create(sos, kk), jnp.asarray(x), 1
    if name == "moving_average":
        x = rng.standard_normal(n).astype(np.float32)
        return FR.MovingAverage(K=9), jnp.asarray(x), 1
    if name == "dc_blocker":
        x = (rng.standard_normal(n) + 0.7).astype(np.float32)
        return FR.DcBlocker.create(0.01), jnp.asarray(x), 1
    if name == "exp_smoother":
        x = rng.standard_normal(n).astype(np.float32)
        return FR.ExpSmoother.create(0.05), jnp.asarray(x), 1
    if name == "ola_fft":
        blk = FR.OlaFft.create(FD.fir_lowpass(129, 0.2))
        x = rng.standard_normal(4 * blk.Ne).astype(np.float32)
        return blk, jnp.asarray(x), blk.Ne
    if name == "decimator":
        x = rng.standard_normal(n).astype(np.float32)
        return FR.Decimator(R=4), jnp.asarray(x), 4
    if name == "fir_decim":
        x = rng.standard_normal(n).astype(np.float32)
        return FR.FirDecim.create(rng.standard_normal(33), 4), \
            jnp.asarray(x), 4
    if name == "fir_ups":
        x = rng.standard_normal(n).astype(np.float32)
        return RS.FirUps.create(FD.fir_lowpass(31, 0.2), 3), \
            jnp.asarray(x), 1
    if name == "halfband":
        x = rng.standard_normal(n).astype(np.float32)
        return RS.HalfbandDecim.create(n=31), jnp.asarray(x), 2
    if name == "cic":
        x = rng.standard_normal(n).astype(np.float32)
        return RS.Cic(config=RS.CicConfig(R=4, N=3), mode="d",
                      scale=4096.0), jnp.asarray(x), 4
    if name == "delay_line":
        x = rng.standard_normal(n).astype(np.float32)
        return FR.DelayLine(d=13), jnp.asarray(x), 1
    raise KeyError(name)


BLOCKS = ["fir_real", "fir_complex_taps", "fir_batched", "iir", "sos",
          "moving_average", "dc_blocker", "exp_smoother", "ola_fft",
          "decimator", "fir_decim", "fir_ups", "halfband", "cic",
          "delay_line"]


@pytest.mark.parametrize("name", BLOCKS)
def test_streaming_split_invariance(name):
    blk, x, gran = _case(name)
    st = blk.init_for(x) if hasattr(blk, "init_for") else blk.init()
    _, y_one = blk.step(st, x)
    y_one = np.asarray(y_one)
    for seed in (1, 2, 3):
        y_s = _stream(blk, x, gran, seed)
        nc = min(y_one.shape[-1], y_s.shape[-1])
        assert y_s.shape == y_one.shape, (name, seed, y_s.shape,
                                          y_one.shape)
        err = np.max(np.abs(y_s[..., :nc] - y_one[..., :nc]))
        scale = np.max(np.abs(y_one)) + 1e-9
        assert err < 2e-5 * scale + 1e-6, (name, seed, err)
