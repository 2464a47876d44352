"""Functional streaming-block protocol.

The reference's central abstraction is the stateful virtual filter
``FiltreGen<Te,Ts>::step(x) -> y`` (core/include/tsd/tsd.hpp:626-657) with
``Source`` / ``Sink`` variants.  The JAX equivalent is a *pure*
protocol::

    state = block.init()
    state, y = block.step(state, x_block)

* ``block`` is a frozen ``libtsd_jax.struct`` pytree: coefficient arrays are leaves,
  config is static metadata.  Blocks therefore pass through ``jax.jit`` /
  ``shard_map`` / ``lax.scan`` unchanged.
* ``state`` is a pytree of arrays — trivially checkpointable (an improvement
  slot over the reference, whose filter state is hidden inside C++ objects and
  never serialisable, SURVEY §5.4).
* Delay/halo bookkeeping is explicit: every block reports ``delay`` (group
  delay in output samples, possibly fractional) and ``ratio`` (output/input
  rate), mirroring the reference's careful latency accounting
  (core/src/reechan/polyphase.cc:363-393, core/src/telecom/recepteur.cc:112-129).
"""
from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp
from . import struct

State = Any


class Block(struct.PyTreeNode):
    """Base class for streaming blocks. Subclasses implement ``init`` and
    ``step``; both must be pure."""

    def init(self) -> State:
        return ()

    def init_for(self, x: jax.Array) -> State:
        """Initial state for an input shaped/typed like ``x``.  Blocks
        whose state depends on batch shape or complex dtype override this
        (Fir, OlaFft, ...); the default ignores x."""
        return self.init()

    def step(self, state: State, x: jax.Array) -> Tuple[State, jax.Array]:
        raise NotImplementedError

    # --- bookkeeping -----------------------------------------------------
    @property
    def tail_state(self) -> bool:
        """True when this block's streaming state IS the last
        ``state_len`` INPUT samples (the overlap-save contract): only
        such blocks may be seeded with a neighbor-shard tail halo
        (parallel.sharded_chain).  Blocks carrying recursion variables,
        phase counters or any other structured state must return False
        (the default) — a raw halo array handed to them would be
        silently consumed as state."""
        return False

    @property
    def delay(self) -> float:
        """Group delay introduced by this block, in *output* samples."""
        return 0.0

    @property
    def ratio(self) -> float:
        """Output samples produced per input sample (rate change factor)."""
        return 1.0

    # --- conveniences ----------------------------------------------------
    def __call__(self, state: State, x: jax.Array) -> Tuple[State, jax.Array]:
        return self.step(state, x)

    def apply(self, x: jax.Array) -> jax.Array:
        """One-shot: fresh state, single step over the whole signal.
        Uses init_for so blocks whose state is batched by the input
        shape/dtype (Fir, IirFrame, ...) work on batched input too."""
        _, y = self.step(self.init_for(x), x)
        return y


class Chain(Block):
    """Sequential composition of blocks (a TX/RX chain).

    Parity concept: the reference composes filters by manual ``step`` call
    nesting (e.g. core/src/telecom/recepteur.cc:404-650); here composition is
    a first-class block whose state is the tuple of member states.
    """

    blocks: Tuple[Block, ...]

    def init(self) -> State:
        return tuple(b.init() for b in self.blocks)

    def init_for(self, x: jax.Array) -> State:
        # delegate so members that batch state by input shape/dtype
        # (Fir, IirFrame, ...) get a correctly shaped state — and
        # propagate each member's OUTPUT shape/dtype to the next member's
        # init (a dtype-changing stage, e.g. a discriminator, would
        # otherwise hand its successor a wrongly typed state).  The
        # propagation uses eval_shape: nothing runs.
        states = []
        xl = x
        for b in self.blocks:
            s = b.init_for(xl)
            states.append(s)
            out = jax.eval_shape(b.step, s, xl)[1]
            # a ShapeDtypeStruct carries shape/dtype to the next
            # init_for with ZERO device allocation (init_for only
            # inspects .shape / .dtype / iscomplexobj)
            xl = jax.ShapeDtypeStruct(out.shape, out.dtype)
        return tuple(states)

    def step(self, state: State, x: jax.Array):
        new_states = []
        for b, s in zip(self.blocks, state):
            s, x = b.step(s, x)
            new_states.append(s)
        return tuple(new_states), x

    @property
    def delay(self) -> float:
        d = 0.0
        for b in self.blocks:
            d = d * b.ratio + b.delay
        return d

    @property
    def ratio(self) -> float:
        r = 1.0
        for b in self.blocks:
            r *= b.ratio
        return r


def chain(*blocks: Block) -> Chain:
    return Chain(blocks=tuple(blocks))


class Identity(Block):
    """Pass-through (parity: FiltreId, core/src/filtrage/filtre-rt.cc:111)."""

    def step(self, state, x):
        return state, x


def stream(block: Block, x: jax.Array, block_size: int):
    """Drive ``block`` over ``x`` in fixed-size chunks with ``lax.scan``,
    carrying state across chunks — the jit-able equivalent of repeatedly
    calling ``FiltreGen::step`` on a long signal.

    Tail-safe: a remainder (len(x) % block_size) is processed with one
    extra ``step`` call (a second static shape), so the output covers all
    of x — matching the reference's tampon, which never drops samples
    (/root/reference/core/src/tsd.cc:303-386).
    """
    n = (x.shape[0] // block_size) * block_size
    chunks = x[:n].reshape(-1, block_size, *x.shape[1:])

    def body(state, xb):
        state, yb = block.step(state, xb)
        return state, yb

    # init_for, not init: blocks whose state depends on the input dtype
    # or batch shape (Fir on complex input, ...) would otherwise change
    # the scan carry type after one step
    state, ys = jax.lax.scan(body, block.init_for(x[:block_size]), chunks)
    y = ys.reshape(-1, *ys.shape[2:])
    if n < x.shape[0]:
        state, yt = block.step(state, x[n:])
        y = jnp.concatenate([y, yt], axis=0)
    return state, y


def safe_pad(x: jax.Array, pad_front: int, pad_back: int,
             axis: int = -1) -> jax.Array:
    """Zero padding along ``axis`` via explicit zeros + concatenate, with
    the zeros behind an optimization barrier.  Semantically identical to
    ``jnp.pad`` on every backend; the barrier only stops XLA from fusing
    the zeros into the producer.  Whether it costs anything on the GPU is
    unmeasured, so it stays until a cell measures it (ROADMAP G2)."""
    if pad_front == 0 and pad_back == 0:
        return x
    shp = list(x.shape)
    parts = []
    if pad_front:
        shp_f = shp.copy(); shp_f[axis] = pad_front
        parts.append(jax.lax.optimization_barrier(jnp.zeros(shp_f, x.dtype)))
    parts.append(x)
    if pad_back:
        shp_b = shp.copy(); shp_b[axis] = pad_back
        parts.append(jax.lax.optimization_barrier(jnp.zeros(shp_b, x.dtype)))
    return jnp.concatenate(parts, axis=axis)


def pad_to_multiple(x: jax.Array, m: int, axis: int = 0) -> jax.Array:
    n = x.shape[axis]
    pad = (-n) % m
    if pad == 0:
        return x
    return safe_pad(x, 0, pad, axis=axis)
