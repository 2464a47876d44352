#!/usr/bin/env python
"""Throughput of the FIR + periodogram metric chain on one GPU.

The chain (``libtsd_jax.ops.chain.fir_periodogram4096``): a 256-tap FIR
over C = 256 channels of 4 Mi samples, then the summed power spectra of
4096-sample frames.  On the GPU it runs as one fused Pallas (Triton)
kernel; the plain XLA version of the same chain is timed beside it.
Ingest tiers: int16 (the headline, lossless ADC samples at 2 B/sample),
int8 and float32.

Timing: after a warm-up call, ITERS calls are chained on the device (each
call's taps depend on the previous result) and the host syncs once at
the end; best of REPS such runs.  One call moves 2 GiB of int16 and
takes milliseconds, so ITERS = 20 keeps the launch and sync cost a small
share of the run.

Prints the device and the card's name and power limit, then one JSON
line.  Fails when JAX finds no GPU.

Run: ``python bench.py``.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax
import jax.numpy as jnp

C = 256
N = 1 << 22
ITERS = 20
REPS = 3


def _measure(fn, h, x) -> float:
    """Msamples/s of ``fn(x, h)`` over a device-chained run."""
    @jax.jit
    def run(h, x):
        def body(i, carry):
            acc, hh = carry
            acc = acc + fn(x, hh)
            return acc, hh + jnp.mean(acc) * 1e-30
        acc, _ = jax.lax.fori_loop(
            0, ITERS, body, (jnp.zeros((C, 4096), jnp.float32), h))
        return jnp.sum(acc)

    run(h, x).block_until_ready()          # compile + warm-up
    best = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        run(h, x).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return C * N * ITERS / best / 1e6


def main():
    from libtsd_jax.ops import fir_design as FD
    from libtsd_jax.ops.chain import (fir_periodogram4096,
                                      fir_periodogram4096_plain)
    from libtsd_jax.platform import enable_compile_cache, gpu_card, on_gpu

    if not on_gpu():
        print("bench: no GPU found (jax.devices() = "
              f"{jax.devices()})", file=sys.stderr)
        sys.exit(1)
    enable_compile_cache()
    dev = jax.devices()[0]
    print(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())}")
    print(f"card: {gpu_card()}")

    h = jnp.asarray(FD.fir_lowpass(256, 0.2), jnp.float32)
    key = jax.random.PRNGKey(0)
    x16 = jax.jit(lambda k: jax.random.randint(
        k, (C, N), -2048, 2048, jnp.int16))(key)
    x8 = jax.jit(lambda k: jax.random.randint(
        k, (C, N), -127, 128, jnp.int8))(key)
    x32 = jax.jit(lambda k: jax.random.normal(k, (C, N), jnp.float32))(key)

    res = {
        "metric": "fir256+fft4k chain throughput (int16 ingest)",
        "value": _measure(fir_periodogram4096, h, x16),
        "unit": "Msamples/s",
        "int8_msps": _measure(fir_periodogram4096, h, x8),
        "f32_msps": _measure(fir_periodogram4096, h, x32),
        "plain_int16_msps": _measure(fir_periodogram4096_plain, h, x16),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(res))


if __name__ == "__main__":
    main()
