"""Test assertion helpers mirroring the reference's harness.

Parity: verifie_erreur_relative / vérifie_exception,
core/src/tests-gen.cc:29-61.
"""
from __future__ import annotations

import numpy as np

__all__ = ["check_relative_error", "check_max_error", "rms", "rms_db",
           "fir_periodogram_ref", "fm_receiver_ref", "rel_to_peak"]


def rms(x) -> float:
    x = np.asarray(x)
    return float(np.sqrt(np.mean(np.abs(x) ** 2)))


def rms_db(x, ref) -> float:
    """RMS error in dB relative to reference RMS."""
    e = rms(np.asarray(x) - np.asarray(ref))
    r = rms(ref)
    return 20.0 * np.log10(max(e, 1e-300) / max(r, 1e-300))


def check_relative_error(value, expected, tol_percent: float, msg: str = ""):
    """Assert |value-expected| / |expected| <= tol_percent / 100
    (parity: verifie_erreur_relative, tests-gen.cc:47-61)."""
    value = np.asarray(value, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    denom = np.maximum(np.abs(expected), 1e-300)
    err = np.max(np.abs(value - expected) / denom) * 100.0
    assert err <= tol_percent, (
        f"relative error {err:.4g}% > {tol_percent}% {msg}"
    )


def check_max_error(value, expected, tol: float, msg: str = ""):
    """Assert max |value - expected| <= tol (absolute)."""
    value = np.asarray(value)
    expected = np.asarray(expected)
    err = float(np.max(np.abs(value - expected)))
    assert err <= tol, f"max abs error {err:.4g} > {tol} {msg}"


# ---------------------------------------------- float64 NumPy/SciPy chains
# plain references for the device paths (tests and chip_smoke.py)

def fir_periodogram_ref(x, h, hist=None, nfft: int = 4096,
                        skip_first: bool = False) -> np.ndarray:
    """FIR (lfilter) then the sum over consecutive ``nfft``-sample frames
    of |FFT|^2, in float64.  ``hist`` (C, K-1) precedes x; ``skip_first``
    leaves out frame 0.  Reference of ops.chain.fir_periodogram4096."""
    from scipy.signal import lfilter
    x64 = np.asarray(x, np.float64)
    if hist is not None:
        x64 = np.concatenate([np.asarray(hist, np.float64), x64], axis=-1)
    y = lfilter(np.asarray(h, np.float64), 1.0, x64, axis=-1)
    if hist is not None:
        y = y[:, np.shape(hist)[-1]:]
    fr = y.reshape(np.shape(x)[0], -1, nfft)
    if skip_first:
        fr = fr[:, 1:]
    return np.sum(np.abs(np.fft.fft(fr, axis=-1)) ** 2, axis=1)


def fm_receiver_ref(rx, x) -> np.ndarray:
    """models.receivers.FmReceiver composed in float64: NCO mix, channel
    lowpass (the receiver's own design) + decimate, quadrature
    discriminator from a zero previous sample, de-emphasis."""
    from scipy.signal import lfilter
    from ..ops.fir_design import fir_design_windowed
    cfg = rx.cfg
    n = np.shape(x)[-1]
    xb = np.asarray(x, np.complex128) * np.exp(
        -2j * np.pi * cfg.channel_freq * np.arange(n))
    h = np.asarray(fir_design_windowed(cfg.chan_taps, "lp",
                                       0.4 / cfg.decim, "hn"), np.float64)
    xd = lfilter(h, 1.0, xb, axis=-1)[..., ::cfg.decim]
    prev = np.concatenate([np.zeros(xd.shape[:-1] + (1,)), xd[..., :-1]],
                          axis=-1)
    audio = np.angle(xd * np.conj(prev)) / (2 * np.pi * cfg.deviation)
    return lfilter(np.asarray(rx.deemph.b, np.float64),
                   np.asarray(rx.deemph.a, np.float64), audio, axis=-1)


def rel_to_peak(got, ref) -> float:
    """max |got - ref| / max |ref| (spectra are compared to their peak)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())
