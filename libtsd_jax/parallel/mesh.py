"""Device-mesh setup for multi-channel / time-sharded DSP.

This layer is NEW DESIGN — the reference is single-threaded C++ with no
distribution (SURVEY §2.11).  The sharding model (from BASELINE.json's north
star):

* axis "chan": channels are embarrassingly parallel — the SDR analogue of
  data parallel.  Collectives: none in steady state.
* axis "time": long signals are split into contiguous time blocks; streaming
  filters need the last K-1 samples of the previous block — the overlap-save
  halo — exchanged with `ppermute` (see halo.py).  This is the
  framework's sequence parallelism.

On several hosts, run `parallel.launch.initialize(...)` first.  The cards
of one host are joined all to all, so the mesh follows the algorithm
alone.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "channel_sharding", "P", "NamedSharding"]


def make_mesh(chan: Optional[int] = None, time: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ("chan", "time") mesh over the available devices.

    If chan is None, uses all devices on the channel axis.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if time < 1 or time > n:
        raise ValueError(f"time={time} axis does not fit the {n} "
                         f"available devices")
    if chan is None:
        if n % time:
            raise ValueError(
                f"time={time} does not divide the {n} devices — pass "
                f"chan explicitly to use a subset deliberately")
        chan = n // time
    need = chan * time
    if need > n:
        raise ValueError(
            f"chan*time={need} exceeds device count ({n})")
    arr = np.array(devices[:need]).reshape(chan, time)
    return Mesh(arr, ("chan", "time"))


def channel_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (channels, samples) arrays: channels over 'chan',
    samples over 'time'."""
    return NamedSharding(mesh, P("chan", "time"))
