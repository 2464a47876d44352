#!/usr/bin/env python
"""FM broadcast receiver demo — BASELINE config 4 end-to-end.

Synthesizes a multi-station FM band (three stations at different carrier
offsets, each modulated with a distinct audio tone mix), then runs the
streaming FM receiver chain per station — channelize (NCO mix + polyphase
lowpass-decimate) -> quadrature discriminator -> de-emphasis — batched
over stations in one jitted step, and writes the recovered audio to WAV
files plus an HTML report with the band PSD and recovered waveforms.

Parity anchor: the reference's FM demod chain
(/root/reference/core/src/telecom/analogique.cc:18-76,381-658); the
multi-station band + per-channel receive is the batched composition
(channels are the data-parallel axis).

Run:
    python examples/fm_demo.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import jax


import jax.numpy as jnp

from libtsd_jax.models.analog import fm_modulate
from libtsd_jax.ops.iir_design import design_lexp
from libtsd_jax.models.receivers import FmReceiver, FmReceiverConfig
from libtsd_jax.ops.psd import psd_welch
from libtsd_jax.utils.wav import wav_save
from libtsd_jax.viz import Figure
from libtsd_jax.viz.report import Report

FS = 1.0                  # normalized band sample rate
DECIM = 4
DEVIATION = 0.1           # at the decimated rate
STATIONS = [              # (carrier freq, audio tone freqs at decim rate)
    (0.10, (0.010, 0.023)),
    (0.22, (0.015,)),
    (0.36, (0.008, 0.031)),
]
N = 1 << 15               # band samples


def synth_band(key):
    """Sum of FM stations at their carriers + a little noise (host-side
    synthesis mirrors the reference's test signal generators)."""
    t = np.arange(N)
    band = np.zeros(N, np.complex64)
    audios = []
    for fc, tones in STATIONS:
        audio = sum(np.sin(2 * np.pi * f / DECIM * t) for f in tones)
        audio = (audio / max(len(tones), 1)).astype(np.float32)
        audios.append(audio[::DECIM])
        x = np.asarray(fm_modulate(jnp.asarray(audio),
                                   deviation=DEVIATION / DECIM))
        lo = np.exp(2j * np.pi * fc * t)
        band += (x * lo).astype(np.complex64)
    noise = np.random.default_rng(0).standard_normal(2 * N).view(
        np.complex128).astype(np.complex64) * 0.02
    return band + noise, audios


def main():
    band, audios_true = synth_band(0)
    outdir = "./build/report/fm_demo"
    os.makedirs(outdir, exist_ok=True)

    # one receiver per station, all driven in a single jitted step
    rxs = [FmReceiver.create(FmReceiverConfig(
        channel_freq=fc, decim=DECIM, deviation=DEVIATION,
        deemph_fc=0.02)) for fc, _ in STATIONS]

    bandj = jnp.asarray(band)

    @jax.jit
    def receive_all(rxs, x):
        outs = []
        for rx in rxs:
            st = rx.init_for(x)
            _, audio = rx.step(st, x)
            outs.append(audio)
        return jnp.stack(outs)

    audio = np.asarray(receive_all(rxs, bandj))

    rep = Report(outdir)
    rep.printf("FM broadcast receiver demo (config 4): three stations, "
               "channelize -> decimate -> quadrature demod -> de-emphasis")
    f = Figure()
    fr, pdb = jax.jit(lambda x: psd_welch(x, 2048))(bandj)
    f.plot(np.asarray(fr), np.asarray(pdb), "b-")
    f.titles("band PSD (3 FM stations)", "frequency", "dB")
    rep.add_figure(f, "band PSD")

    print(f"{'station':>8} {'carrier':>8} {'corr':>7}")
    for i, ((fc, _), aud) in enumerate(zip(STATIONS, audio)):
        # correlation against the true audio (skip filter transients,
        # compensate the channel filter group delay)
        d = int(rxs[i].chan_filt.delay)
        seg = aud[50:-50]
        # the receiver applies de-emphasis — apply the same first-order
        # IIR to the reference audio before comparing
        from scipy.signal import lfilter
        b, a = design_lexp(0.02)
        ref_f = lfilter(np.asarray(b, float), np.asarray(a, float),
                        audios_true[i].astype(float))
        ref = ref_f[50 - d: 50 - d + len(seg)]
        m = min(len(seg), len(ref))
        corr = float(np.corrcoef(seg[:m], ref[:m])[0, 1])
        print(f"{i:>8} {fc:>8.2f} {corr:>7.3f}")
        wav_save(os.path.join(outdir, f"station{i}.wav"),
                 np.asarray(aud / (np.max(np.abs(aud)) + 1e-9)), rate=8000)
        f = Figure()
        f.plot(np.asarray(seg[:1024]), "g-", label="recovered")
        f.plot(np.asarray(ref[:1024]), "r:", label="original")
        f.titles(f"station {i} @ {fc:.2f} (corr {corr:.3f})",
                 "sample", "audio")
        rep.add_figure(f, f"station {i}")
        assert corr > 0.97, (i, corr)

    rep.flush()
    print(f"report: {outdir}/index.html")


if __name__ == "__main__":
    from libtsd_jax.platform import enable_compile_cache
    enable_compile_cache()
    main()
