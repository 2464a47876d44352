"""Multi-host (multi-process) launch path — the cross-host half of scale-out.

The reference is single-threaded C++ with no distribution; this layer is
NEW DESIGN per SURVEY §2.11/§5.8.  Model:

* one process per host, `initialize()` first (wraps
  `jax.distributed.initialize`; pass the coordinator address and the
  process count/id explicitly);
* a global ("chan", "time") mesh spans every chip of every host
  (make_mesh already uses `jax.devices()`, which is global after
  initialize);
* each host ingests ONLY its own slice of the signal (its SDR front-end /
  file shard) and publishes it into the global array with
  `ingest_local()` — data crosses hosts only at this boundary; the
  steady-state halo exchange and spectrum psum are mesh collectives;
* every jitted/shard_mapped computation in the library then runs SPMD —
  the same `sharded_fir_periodogram4096` / `sharded_chain` calls work
  unchanged on 1 chip, 1 host, or N hosts.

`examples/multihost_demo.py` drives this with N real OS processes over
gloo on localhost (the honest stand-in this single-chip environment
allows); the same script is the per-host entry on a real pod.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["initialize", "is_distributed", "ingest_local", "host_slice"]

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """Join the multi-process runtime.  Call once, before any device use.

    Pass `coordinator_address="host:port"`, `num_processes` and
    `process_id` (GPU clusters, localhost CPU testing).
    Idempotent within a process.
    """
    global _initialized
    if _initialized:
        return
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_device_ids)
    _initialized = True


def is_distributed() -> bool:
    return jax.process_count() > 1


def host_slice(mesh: Mesh, axis: str, n: int) -> slice:
    """The half-open [start, stop) range of global index space along a
    sharded array dimension of size ``n`` (mapped to mesh axis ``axis``)
    that THIS process's local devices own.  Use it to read/ingest only the
    local part of a signal (file offset, SDR channel subset, ...).

    Requires this process's devices to be contiguous along the axis (the
    default device order on pods satisfies this)."""
    shards = mesh.shape[axis]
    assert n % shards == 0, (n, shards)
    per = n // shards
    # position of each local device along `axis` in the mesh array
    axis_idx = mesh.axis_names.index(axis)
    dev_arr = np.asarray(mesh.devices)
    local = {d.id for d in jax.local_devices()}
    pos = sorted({idx[axis_idx] for idx, d in np.ndenumerate(dev_arr)
                  if d.id in local})
    if not pos:
        raise ValueError(
            f"this process owns no device in the mesh along {axis!r} "
            f"(mesh devices exclude all local devices)")
    assert pos == list(range(pos[0], pos[0] + len(pos))), \
        f"process devices not contiguous along {axis}: {pos}"
    return slice(pos[0] * per, (pos[-1] + 1) * per)


def ingest_local(mesh: Mesh, spec: P, local_data: np.ndarray) -> jax.Array:
    """Publish per-process host data into a globally sharded jax.Array.

    ``local_data`` is this process's slice of the global array (shape =
    global shape with each sharded dim divided by the number of *processes*
    spanning it); the result is a global array laid out per ``spec`` with
    no cross-host transfer beyond what the sharding requires."""
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_process_local_data(sharding, local_data)
