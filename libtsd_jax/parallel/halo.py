"""Overlap-save halo exchange over the time axis (mesh collectives).

The reference's "long-context" mechanism is streaming block processing with
carried filter state (SURVEY §5.7: tampon_création + FiltreFFT overlap
blocks).  Sharded over a device mesh, the carried state becomes a *halo*: each
time shard needs the last (K-1) input samples of its left neighbor.  One
`lax.ppermute` moves all halos right simultaneously (NCCL on GPUs); the first
shard receives zeros (ppermute's default for unaddressed targets), which is
exactly the zero initial filter state.

Delay/halo bookkeeping uses the Block protocol's explicit state: a halo IS
the block's streaming state, so `block.step(halo, local_x)` gives bit-exact
agreement with the unsharded streaming run — cascades with different group
delays compose correctly because each block carries its own state size
(SURVEY "hard parts" #2).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..block import Block

__all__ = ["halo_exchange_left", "sharded_fir", "sharded_chain",
           "iir_time_sharded"]


def halo_exchange_left(x: jax.Array, halo: int, axis_name: str = "time") -> jax.Array:
    """Inside shard_map: return this shard's left halo — the last ``halo``
    samples (along the last axis) of the left neighbor's shard; zeros on the
    first shard."""
    assert halo <= x.shape[-1], (
        f"halo ({halo}) exceeds the local shard length ({x.shape[-1]}); "
        f"use fewer/larger time shards")
    n_shards = lax.axis_size(axis_name)
    if halo == 0:
        # stateless block: x[..., -0:] would be the WHOLE shard
        return x[..., :0]
    tail = x[..., -halo:]
    if n_shards == 1:
        return jnp.zeros_like(tail)
    perm = [(i, i + 1) for i in range(n_shards - 1)]
    return lax.ppermute(tail, axis_name, perm)


def _mat_pow(M: jax.Array, p: int) -> jax.Array:
    """M^p by repeated squaring (static p), HIGHEST precision."""
    R = jnp.eye(M.shape[0], dtype=M.dtype)
    while p:
        if p & 1:
            R = jnp.matmul(M, R, precision=lax.Precision.HIGHEST)
        M = jnp.matmul(M, M, precision=lax.Precision.HIGHEST)
        p >>= 1
    return R


def iir_time_sharded(blk, xs: jax.Array, axis_name: str = "time"):
    """Run a frame-parallel IIR (`ops.filter_rt.IirFrame`) over a
    time-SHARDED signal, exactly — inside shard_map.

    A recursive filter's state at a shard boundary depends on ALL previous
    input, so the sample-tail halo of `halo_exchange_left` cannot seed it.
    But the state map over any input span is AFFINE: shard i maps an entry
    state s to  M_tot s + v_i  with M_tot = A^{n_local} and v_i the
    shard's zero-entry end state — the exact same algebra IirFrame already
    uses for its log-depth frame hop (filter_rt.py:544-575), lifted one
    level to shards.  Each shard:

      1. runs the frame-parallel step with ZERO entry state (one local
         pass: y0 and v_i fall out together);
      2. `all_gather`s the tiny (..., k) zero-entry end states
         and prefix-composes the affine pairs locally (n_shards is small
         and static) -> its exact entry state s_i;
      3. adds the linear correction  y += S . (A^{fL} s_i)  per frame —
         one k-dim associative scan plus one rank-k matmul.

    Output equals the unsharded `IirFrame.step` bit-for-near (float32
    reassociation only).  New-design mandate: SURVEY §2.11/§5.7 — the
    reference has no distributed anything.
    """
    from ..ops.filter_rt import _affine_matrix_scan
    L = blk.T.shape[0]
    n = xs.shape[-1]
    assert n % L == 0, (n, L)
    nf = n // L
    # (1) local zero-entry pass
    v_local, y0 = blk.step(blk.init_for(xs), xs)
    # (2) compose affine pairs across shards (equal shard lengths under
    # shard_map, so every shard shares one M_tot)
    M_tot = _mat_pow(blk.M, nf)
    n_shards = lax.axis_size(axis_name)
    idx = lax.axis_index(axis_name)
    if n_shards == 1:
        return y0
    vs = lax.all_gather(v_local, axis_name)          # (n_shards, ..., k)
    acc = jnp.zeros_like(v_local)
    s_entry = jnp.zeros_like(v_local)
    for i in range(n_shards):
        s_entry = jnp.where(idx == i, acc, s_entry)
        acc = jnp.einsum("ij,...j->...i", M_tot, acc,
                         precision=lax.Precision.HIGHEST) + vs[i]
    # (3) per-frame linear correction y += S @ (M^f s_entry)
    u = jnp.zeros(xs.shape[:-1] + (nf, blk.order), s_entry.dtype)
    u = u.at[..., 0, :].set(s_entry)
    s_extra = _affine_matrix_scan(blk.M.astype(s_entry.dtype), u)
    y_corr = jnp.einsum("...fk,lk->...fl", s_extra,
                        blk.S.astype(s_entry.dtype),
                        precision=lax.Precision.HIGHEST)
    return y0 + y_corr.reshape(xs.shape)


def sharded_fir(mesh: Mesh, block: Block, x: jax.Array,
                state_len: int) -> jax.Array:
    """Run a stateful streaming block over a (chan, time)-sharded signal.

    x: (channels, n) array (or sharded already).  Each time shard receives
    its left neighbor's tail as initial state; output matches the unsharded
    streaming run exactly.

    ``state_len`` is the number of carried samples: K-1 for a K-tap FIR,
    whose streaming state is exactly the last K-1 input samples.
    """

    def local(xs):
        halo = halo_exchange_left(xs, state_len)
        _, y = block.step(halo, xs)
        return y

    fn = shard_map(local, mesh=mesh,
                   in_specs=P("chan", "time"),
                   out_specs=P("chan", "time"))
    return fn(x)


def sharded_chain(mesh: Mesh, blocks_and_state_lens, x: jax.Array) -> jax.Array:
    """Cascade several sample-carrying blocks under one shard_map, with one
    halo exchange per stage (halo sizes differ per stage — explicit
    bookkeeping, SURVEY hard-part #2).

    Stages whose state is SAMPLES (FIR, OLA, delay lines) take
    ``(block, state_len)`` and get the ppermute tail halo.  RECURSIVE
    stages (IIR) are passed as `IirFrame` instances (or a `Chain` of
    them, e.g. `sos_frame_chain`'s cascade) with any state_len — they are
    routed through the exact cross-shard affine state composition
    (:func:`iir_time_sharded`) instead, so a chain with feedback stages
    time-shards end-to-end."""
    from ..block import Chain
    from ..ops.filter_rt import (DcBlocker, ExpSmoother, Iir, IirFrame,
                                 Sos)
    # blocks whose state is a RECURSION variable, not an input-sample
    # tail: the ppermute tail halo would be silently consumed as state
    # (an order-1 Iir's state even has the right SHAPE for a 1-sample
    # halo) — these must come through the affine composition instead
    recursive = (Iir, Sos, DcBlocker, ExpSmoother)

    def run_stage(block, slen, xs):
        if isinstance(block, IirFrame):
            return iir_time_sharded(block, xs)
        if isinstance(block, Chain):
            if all(isinstance(b, IirFrame) for b in block.blocks):
                for b in block.blocks:
                    xs = iir_time_sharded(b, xs)
                return xs
            if any(isinstance(b, (IirFrame,) + recursive)
                   for b in block.blocks):
                raise TypeError(
                    "sharded_chain: a Chain mixing recursive stages with "
                    "sample-tail stages cannot take the tail halo — pass "
                    "the recursive stages as separate list entries "
                    "(IirFrame / sos_frame_chain)")
        if isinstance(block, recursive):
            raise TypeError(
                f"sharded_chain: {type(block).__name__} carries recursion "
                f"state, which the sample-tail halo cannot seed — convert "
                f"to the frame-parallel form (IirFrame.create(b, a) or "
                f"sos_frame_chain) for exact cross-shard composition")
        if not getattr(block, "tail_state", False):
            # POSITIVE protocol check (Block.tail_state), not an
            # isinstance denylist: any block whose state is not the
            # last state_len INPUT samples (phase counters, OA output
            # residue, nested Chains, future blocks) would silently
            # consume the raw halo array as structured state
            raise TypeError(
                f"sharded_chain: {type(block).__name__} does not declare "
                f"tail_state=True — its streaming state is not an "
                f"input-sample tail, so the ppermute halo cannot seed "
                f"it.  Pass tail-state blocks (Fir) or the "
                f"frame-parallel recursive forms as separate stages")
        halo = halo_exchange_left(xs, slen)
        _, y = block.step(halo, xs)
        return y

    def local(xs):
        for block, slen in blocks_and_state_lens:
            xs = run_stage(block, slen, xs)
        return xs

    fn = shard_map(local, mesh=mesh,
                   in_specs=P("chan", "time"),
                   out_specs=P("chan", "time"))
    return fn(x)
