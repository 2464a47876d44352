from . import (chain, corr, cqt, dwt, fft, filter_rt, fir_design,  # noqa: F401
               iir_design, poly, psd, resample, rng, signal, window)
