"""Checkpoint / resume for streaming pipeline state.

The reference has NO checkpointing: its filter state is hidden inside C++
objects and never serializable (SURVEY §5.4 flags this as an improvement
slot).  Here every block's state is an explicit pytree of arrays, so
checkpointing is structural: flatten to named arrays, save as .npz, restore
into the same treedef.
"""
from __future__ import annotations

import io
import os
from typing import Any

import jax
import numpy as np

__all__ = ["save_state", "load_state", "state_bytes", "state_from_bytes",
           "save_stream_state", "load_stream_state"]


_JIT_CACHE = {}


def _to_ri_jit():
    """Module-cached jit of config.to_ri: a fresh jax.jit wrapper per
    checkpoint would re-trace/re-compile on every save."""
    if "to" not in _JIT_CACHE:
        from ..config import to_ri
        _JIT_CACHE["to"] = jax.jit(to_ri)
    return _JIT_CACHE["to"]


def _from_ri_jit():
    if "from" not in _JIT_CACHE:
        from ..config import from_ri
        _JIT_CACHE["from"] = jax.jit(from_ri)
    return _JIT_CACHE["from"]


def _flatten(state) -> dict:
    leaves, treedef = jax.tree.flatten(state)
    out = {}
    for i, l in enumerate(leaves):
        if jax.numpy.iscomplexobj(l):
            # store complex leaves as re/im PLANES (config.to_ri)
            out[f"leaf_{i}__ri"] = np.asarray(_to_ri_jit()(l))
        else:
            out[f"leaf_{i}"] = np.asarray(l)
    out["__treedef__"] = np.frombuffer(
        repr(treedef).encode(), dtype=np.uint8)
    return out


def save_state(path: str, state: Any):
    """Save a pytree state to ``path`` (.npz)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(state))


def load_state(path: str, like: Any) -> Any:
    """Restore a state saved with :func:`save_state`.  ``like`` provides the
    tree structure (e.g. ``block.init()``)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz",
                   allow_pickle=False)
    return state_from_npz(data, like)


def state_from_npz(data, like: Any) -> Any:
    leaves, treedef = jax.tree.flatten(like)
    # structural check: a 'like' with coincidentally matching leaf shapes
    # but different structure would otherwise silently mis-assign state
    if "__treedef__" in data:
        saved = bytes(data["__treedef__"]).decode()
        if saved != repr(treedef):
            raise ValueError(
                "checkpoint tree structure does not match 'like':\n"
                f"  saved: {saved}\n  like:  {treedef!r}")
    new_leaves = []
    for i, l in enumerate(leaves):
        key = f"leaf_{i}__ri" if f"leaf_{i}__ri" in data else f"leaf_{i}"
        if key not in data:
            raise ValueError(f"checkpoint is missing leaf {i}")
        if key.endswith("__ri"):
            planes = jax.numpy.asarray(data[key])
            arr = _from_ri_jit()(planes)
        else:
            arr = data[key]
        # real checks, not asserts: python -O must not let a wrong-shape
        # or wrong-dtype checkpoint unflatten into the state tree (a
        # complex leaf restored into a real slot would silently promote
        # downstream arithmetic on the next jit retrace)
        if arr.shape != tuple(np.shape(l)):
            raise ValueError(
                f"leaf {i}: checkpoint shape {arr.shape} != expected "
                f"{np.shape(l)}")
        exp_dt = np.dtype(getattr(l, "dtype", np.float32))
        got_dt = np.dtype(arr.dtype)
        if (np.issubdtype(got_dt, np.complexfloating)
                != np.issubdtype(exp_dt, np.complexfloating)) or (
                np.issubdtype(got_dt, np.integer)
                != np.issubdtype(exp_dt, np.integer)):
            raise ValueError(
                f"leaf {i}: checkpoint dtype {got_dt} is incompatible "
                f"with expected {exp_dt}")
        new_leaves.append(arr if isinstance(arr, jax.Array)
                          else jax.numpy.asarray(arr))
    return jax.tree.unflatten(treedef, new_leaves)


def save_stream_state(path: str, state: Any, residue: np.ndarray,
                      counters: dict):
    """Shared mid-stream serving-checkpoint protocol (StreamRunner and
    StreamReceiver write the SAME format through here): the device state
    pytree (complex leaves as re/im planes), the host ring residue
    (complex64 or float32 samples awaiting the next full block), and
    integer counters — one .npz."""
    d = _flatten(state)
    if np.iscomplexobj(residue):
        d["__residue_ri__"] = np.stack([residue.real.astype(np.float32),
                                        residue.imag.astype(np.float32)])
    else:
        d["__residue__"] = np.asarray(residue, np.float32)
    for k, v in counters.items():
        d[f"__ctr_{k}__"] = np.int64(v)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **d)


def load_stream_state(path: str, like: Any):
    """Inverse of :func:`save_stream_state`; ``like`` provides the state
    tree structure for validation.  Returns (state, residue, counters);
    complex state leaves are re-assembled ON DEVICE inside jit (no
    complex host transfers)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz",
                   allow_pickle=False)
    state = state_from_npz(data, like)
    if "__residue_ri__" in data:
        r = data["__residue_ri__"]
        residue = (r[0] + 1j * r[1]).astype(np.complex64)
    else:
        residue = np.asarray(data["__residue__"], np.float32)
    counters = {k[6:-2]: int(data[k]) for k in data.files
                if k.startswith("__ctr_")}
    return state, residue, counters


def state_bytes(state: Any) -> bytes:
    """Serialize a state pytree to bytes (for network transport)."""
    buf = io.BytesIO()
    np.savez(buf, **_flatten(state))
    return buf.getvalue()


def state_from_bytes(b: bytes, like: Any) -> Any:
    data = np.load(io.BytesIO(b), allow_pickle=False)
    return state_from_npz(data, like)
