"""Performance monitors: named scoped timers with call counts and
throughput, aggregated stats, jax.profiler integration.

Parity: MoniteurCpu / MoniteursStats, core/src/moniteur-cpu.cc:22-236,
core/include/tsd/moniteur-cpu.hpp:10-38.  The reference tracks per-thread
CPU time; here scopes measure wall time around device work (with
block_until_ready for honest accounting) and expose samples/s — the shape
of the `moniteurs()` API is preserved (SURVEY §5.1).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import jax

__all__ = ["Monitor", "Monitors", "profiler_trace"]


@dataclasses.dataclass
class MonitorStats:
    """Parity: MoniteurCpu::Stats."""
    name: str = ""
    total_s: float = 0.0
    count: int = 0
    samples: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    @property
    def samples_per_s(self) -> float:
        return self.samples / self.total_s if self.total_s > 0 else 0.0


class Monitor:
    """Named scoped timer (parity: MoniteurCpu: commence_op/fin_op)."""

    def __init__(self, name: str):
        self.stats = MonitorStats(name=name)
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, samples: int = 0):
        if self._t0 is None:
            return
        self.stats.total_s += time.perf_counter() - self._t0
        self.stats.count += 1
        self.stats.samples += samples
        self._t0 = None

    @contextlib.contextmanager
    def scope(self, samples: int = 0):
        """Context manager yielding a holder: call ``holder.sync(y)`` on
        the result produced INSIDE the scope to block_until_ready before
        the timer stops (honest device timing — without it, JAX's async
        dispatch returns immediately and the scope measures dispatch
        latency, not compute)."""
        class _Holder:
            _y = None

            def sync(self, y):
                self._y = y
                return y

        h = _Holder()
        self.start()
        try:
            yield h
        finally:
            if h._y is not None:
                jax.block_until_ready(h._y)
            self.stop(samples)


class Monitors:
    """Registry + aggregation (parity: MoniteursStats; e.g. the receiver's
    per-stage monitors "recepteur/ola", "recepteur/demod",
    recepteur.cc:83-85)."""

    def __init__(self):
        self._mons: Dict[str, Monitor] = {}

    def __getitem__(self, name: str) -> Monitor:
        if name not in self._mons:
            self._mons[name] = Monitor(name)
        return self._mons[name]

    def stats(self) -> Dict[str, MonitorStats]:
        return {k: m.stats for k, m in self._mons.items()}

    def report(self) -> str:
        total = sum(m.stats.total_s for m in self._mons.values()) or 1e-12
        lines = [f"{'scope':<30}{'calls':>8}{'total s':>12}{'%':>7}"
                 f"{'Msamp/s':>10}"]
        for k, m in sorted(self._mons.items()):
            s = m.stats
            lines.append(
                f"{k:<30}{s.count:>8}{s.total_s:>12.4f}"
                f"{100 * s.total_s / total:>6.1f}%"
                f"{s.samples_per_s / 1e6:>10.2f}")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """jax.profiler trace scope (device-level profiling; the device
    counterpart of the reference's CPU monitors)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
