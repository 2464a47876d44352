"""Sharded metric chain: the FIR + periodogram run SPMD over the
("chan", "time") mesh.

* channels are data-parallel over the "chan" axis (no steady-state
  collectives);
* long signals are sequence-parallel over the "time" axis: each time
  shard hands its last K-1 input samples — the FIR state its right
  neighbour starts from — with one `ppermute` (halo_exchange_left), and
  the chain starts from that history instead of zeros.  The first shard
  receives zeros = fresh filter state, so the sharded run equals the
  unsharded run up to float32 re-association of the per-shard sums;
* the per-shard partial spectra are combined with one `psum` over
  "time", a (C_local, 4096) reduction.

XLA hands both collectives to NCCL on the GPU.  This layer is new design:
the reference is single-threaded C++ with no distribution (SURVEY §2.11).
"""
from __future__ import annotations

import jax
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.chain import fir_periodogram4096
from .halo import halo_exchange_left

__all__ = ["sharded_fir_periodogram4096"]


def sharded_fir_periodogram4096(mesh: Mesh, x: jax.Array,
                                h: jax.Array) -> jax.Array:
    """Distributed FIR + periodogram over a ("chan", "time") mesh.

    x: (C, N), sharded (or shardable) as P("chan", "time"); each time
    shard's length must be a multiple of 4096.  h: (K,) taps, replicated.

    Returns (C, 4096) accumulated power spectra of the FIR-filtered
    signal — equal to ``fir_periodogram4096(x, h)`` on one device — laid
    out P("chan", None) (replicated over "time")."""
    K = h.shape[0]

    def local(xs, hh):
        # left neighbour's input tail = this shard's initial FIR state
        hist = halo_exchange_left(xs, K - 1, "time")
        return lax.psum(fir_periodogram4096(xs, hh, hist), "time")

    # check_vma=False: pallas_call (the GPU kernel) does not declare
    # varying-mesh-axes metadata, so shard_map's checker cannot see
    # through it
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("chan", "time"), P()),
                   out_specs=P("chan", None), check_vma=False)
    return fn(x, h)
