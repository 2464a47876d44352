#!/usr/bin/env python
"""IQ capture serving demo: file -> prefetching reader -> StreamRunner.

The production data path end-to-end: a raw cs16 SDR capture is read by the
native prefetching IqFileReader (disk IO on a background thread), converted
to complex floats, re-blocked, and served through a jitted channel-select
chain (baseband mix + lowpass + decimate) by StreamRunner with a bounded
async in-flight queue — disk, host, and device all overlap.

The capture is synthesized first: a strong tone at +0.08 and an
interferer at -0.23 of the sample rate; the chain selects the +0.08
channel, so the output must be a clean baseband tone.

Run:
    python examples/iq_stream_demo.py
"""
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax

import jax.numpy as jnp
from libtsd_jax import struct

from libtsd_jax.block import Block, chain
from libtsd_jax.io import IqFileReader, StreamRunner, cs16_to_cf32
from libtsd_jax.ops import fir_design as FD
from libtsd_jax.ops.filter_rt import FirDecim

F_WANTED, F_INTERF = 0.08, -0.23
DECIM = 8
N_IQ = 1 << 18
BLOCK = 1 << 14


class Mixer(Block):
    """Baseband transposition: multiply by exp(-2j pi f0 n) with phase
    carried across blocks (streaming NCO)."""
    f0: float = struct.field(pytree_node=False)

    def init(self):
        return jnp.zeros((), jnp.float32)

    def init_for(self, x):
        return self.init()

    @property
    def delay(self):
        return 0.0

    def step(self, state, x):
        n = x.shape[-1]
        ph = state + 2 * jnp.pi * self.f0 * jnp.arange(n, dtype=jnp.float32)
        y = x * jnp.exp(-1j * ph)
        return jnp.mod(state + 2 * jnp.pi * self.f0 * n, 2 * jnp.pi), y


def main():
    rng = np.random.default_rng(0)
    n = np.arange(N_IQ)
    band = (1.0 * np.exp(2j * np.pi * F_WANTED * n)
            + 0.8 * np.exp(2j * np.pi * F_INTERF * n)
            + 0.05 * (rng.standard_normal(N_IQ)
                      + 1j * rng.standard_normal(N_IQ)))
    raw = np.empty((N_IQ, 2), np.int16)
    raw[:, 0] = np.clip(band.real * 8192, -32768, 32767)
    raw[:, 1] = np.clip(band.imag * 8192, -32768, 32767)
    path = os.path.join(tempfile.gettempdir(), "demo_capture.cs16")
    raw.tofile(path)
    print(f"capture: {path} ({raw.nbytes / 1e6:.1f} MB cs16)")

    h = FD.fir_lowpass(127, 0.4 / DECIM)
    rx = chain(Mixer(f0=F_WANTED), FirDecim.create(h, DECIM))
    runner = StreamRunner(rx, block_len=BLOCK)

    with IqFileReader(path, "cs16", block_iq=BLOCK) as rd:
        out = runner.run(cs16_to_cf32(blk.reshape(-1)) for blk in rd)
    runner.drain()

    st = runner.monitor.stats
    print(f"served {st.samples} samples in {st.count} device blocks "
          f"({st.samples_per_s / 1e6:.1f} Msamp/s incl. host IO)")
    # the selected channel must be a clean baseband tone: spectrum peak
    # at DC and interferer suppressed
    X = np.fft.fftshift(np.abs(np.fft.fft(out[512:512 + 8192])))
    f = np.fft.fftshift(np.fft.fftfreq(8192))
    peak = f[np.argmax(X)]
    interf_bin = np.argmin(np.abs(f - (F_INTERF - F_WANTED) * DECIM))
    rej_db = 20 * np.log10(X.max() / max(X[interf_bin], 1e-9))
    print(f"channel peak at f={peak:+.4f} (expect 0), interferer rejection "
          f"{rej_db:.0f} dB")
    assert abs(peak) < 1e-3 and rej_db > 40
    print("OK")


if __name__ == "__main__":
    from libtsd_jax.platform import enable_compile_cache
    enable_compile_cache()
    main()
