"""(chan, time)-sharded FM receiver chain — BASELINE config 4 end-to-end
under the mesh, INCLUDING the recursive de-emphasis stage.

Round-3 limitation: time-axis sharding covered only
sample-tail-state blocks, so a mesh-level FM chain had to keep its IIR
stage channel-parallel-only.  With `iir_time_sharded` (parallel/halo.py:
exact cross-shard affine state composition) every stage of the chain now
time-shards:

  1. NCO channel mix — stateless given the GLOBAL sample offset; each
     time shard reconstructs its wrapped-cycle base from its axis index
     (the per-shard phase base is reduced mod 1 on the host, so the f32
     ramp never sees a large argument);
  2. polyphase channel-select FIR + decimate (`FirDecim`) — its state IS
     the last Kp*R input samples, so the standard tail-halo ppermute
     seeds it exactly;
  3. quadrature discriminator — 1-sample halo;
  4. de-emphasis IIR — `IirFrame` + cross-shard state composition.

Output matches the unsharded `FmReceiver.step` (models/receivers.py) to
float32 reassociation noise; see tests/test_parallel.py.
New-design mandate: SURVEY §2.11/§5.7 (the reference is single-threaded).
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..config import complex_dtype, real_dtype
from ..models.demod import quadrature_discriminator
from ..ops.filter_rt import IirFrame
from ..ops.signal import cycles
from .halo import halo_exchange_left, iir_time_sharded

__all__ = ["sharded_fm_receiver"]


def sharded_fm_receiver(mesh: Mesh, fm, x: jax.Array) -> jax.Array:
    """One-shot (zero initial state) FM receive over a (chan, time)-sharded
    IF signal x (C, N) complex; returns (C, N/decim) audio sharded the
    same way.  ``fm`` is a models.receivers.FmReceiver."""
    cfg = fm.cfg
    R = cfg.decim
    f = float(cfg.channel_freq)
    dev = float(cfg.deviation)
    # de-emphasis as a frame-parallel IIR (order 1) for the cross-shard
    # state composition; same b/a as the unsharded Iir stage
    b = np.asarray(fm.deemph.b, np.float64)
    a = np.asarray(fm.deemph.a, np.float64)
    has_deemph = not (len(b) == 1 and len(a) == 1)
    deemph = IirFrame.create(b, a) if has_deemph else None
    chan = fm.chan_filt
    hist = chan.P.shape[0] * R              # FirDecim carried samples

    n_local = x.shape[-1] // mesh.shape["time"]
    # exact per-shard phase base: (f * n_local) mod 1 in host float64 —
    # the traced multiply by the small shard index stays accurate
    base_step = float(np.mod(np.float64(f) * n_local, 1.0))

    def local(xs):
        tidx = lax.axis_index("time").astype(real_dtype)
        # shard-local wrapped ramp from signal.cycles: host-f64-exact,
        # and for large shards it bakes only two small tables into the
        # executable instead of an n_local-sized constant
        kcyc = cycles(f, n_local)
        cyc = jnp.mod(base_step * tidx + kcyc, 1.0)
        xb = xs.astype(complex_dtype) * jnp.exp(
            -2j * jnp.pi * cyc).astype(complex_dtype)
        halo = halo_exchange_left(xb, hist)
        _, xd = chan.step(halo, xb)
        prev = halo_exchange_left(xd, 1)
        d = quadrature_discriminator(xd, prev)
        audio = d / (2 * jnp.pi * dev)
        if has_deemph:
            audio = iir_time_sharded(deemph, audio)
        return audio

    fn = shard_map(local, mesh=mesh,
                   in_specs=P("chan", "time"),
                   out_specs=P("chan", "time"))
    return fn(x)
