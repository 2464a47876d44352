#!/usr/bin/env python
"""Multichannel QAM-16 serving demo: one device demodulating a fleet of
channels with the batched sub-block receiver (BASELINE config 5).

Flow: generate C independent QAM-16 streams (TX parity with the
reference's modulator), impair them (AWGN + fractional delay), then
demodulate ALL channels in one batched step:

  matched filter + AGC + timing/carrier loops + decisions, one scan over
  sub-blocks with the channels as the batch axis.

Run:  python examples/qam_serving.py [C]
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from libtsd_jax.models import waveform as WF
from libtsd_jax.models import ber as BER
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.models.demod_sb import DecisionDemodSB, SBDemodConfig
from libtsd_jax.models.modulator import ModConfig, Modulator
from libtsd_jax.ops.fft import delay_signal


def main():
    C = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    osf, nsym = 4, 2048
    print(f"backend={jax.default_backend()}  C={C}")

    wf = WF.wf_qam(16, WF.PulseShape.rcs(0.25))
    mod = Modulator.create(ModConfig(wf=wf, fe=float(osf), fsymb=1.0))
    dd = DecisionDemodSB.create(wf, SBDemodConfig(osf=osf, S=16))

    @jax.jit
    def tx(key):
        bits = randbits(key, 4 * nsym)
        x, _ = mod.modulate(bits)
        n = (x.shape[0] // 64) * 64
        x = x[:n]
        # per-channel impairments: distinct fractional delays + noise
        xs = jnp.stack([delay_signal(x, 0.3 + 0.001 * c)
                        for c in range(min(C, 8))])
        xs = jnp.tile(xs, (C // xs.shape[0] + 1, 1))[:C]
        nr, ni = jax.random.normal(key, (2, C, n), jnp.float32) * 0.02
        return bits, xs + (nr + 1j * ni).astype(jnp.complex64)

    bits, x = tx(jax.random.PRNGKey(0))
    st = jax.jit(dd.init_for)(x)
    step = jax.jit(dd.step)
    st, (rb, syms, mask, bmask) = step(st, x)

    # per-channel tail EVM, computed inside jit
    @jax.jit
    def tail_evm(w, s):
        sym = w.symbols
        t = s[:, s.shape[1] // 2:]
        d2 = jnp.min(jnp.abs(t[..., None] - sym) ** 2, axis=-1)
        return jnp.sqrt(jnp.mean(d2, axis=-1)
                        / jnp.mean(jnp.abs(sym) ** 2))
    ev = np.asarray(tail_evm(dd.wf, syms))
    print(f"tail EVM: mean={ev.mean():.4f} max={ev.max():.4f}")
    assert ev.max() < 0.2, ev.max()

    # full bit-exact decode check on sampled channels
    nerr = 0
    for c in range(0, C, max(C // 4, 1)):
        m = np.asarray(mask[c])
        sy = np.asarray(syms[c])[m]
        _, errs, _ = BER.cmp_bits_rot(bits[4 * 600:],
                                      jnp.asarray(sy[600:]), wf,
                                      max_lag=64)
        nerr += int(errs)
    print(f"steady-state bit errors over sampled channels: {nerr}")
    assert nerr == 0
    print("QAM serving demo OK")


if __name__ == "__main__":
    from libtsd_jax.platform import enable_compile_cache
    enable_compile_cache()
    main()
