"""libtsd-jax: a DSP / software-radio framework in JAX (XLA, Pallas).

Brand-new design with the capabilities of tsdconseil/libtsd (C++/CPU reference
at /root/reference — see SURVEY.md): spectral analysis, FIR/IIR filter design
and streaming runtime, resampling, telecom modems with clock/carrier recovery,
Kalman/DOA applications, and host-side visualization/reporting.

Layout:
* ``libtsd_jax.ops``      — numerics: FFT/PSD/correlation, windows, filter
  design + runtime, resampling, the metric chain and its GPU kernel.
* ``libtsd_jax.models``   — telecom/SDR stack (waveforms, modems, receivers)
  and estimation apps (Kalman, DOA).
* ``libtsd_jax.parallel`` — mesh/sharding layer: channel + time-block
  sharding with overlap-save halo exchange (collectives over the mesh).
* ``libtsd_jax.utils``    — WAV I/O, time, geometry, monitors, test helpers.
* ``libtsd_jax.viz``      — figure/report sink (host-side).
"""

from . import config
from .block import Block, Chain, chain, Identity, stream, pad_to_multiple

__version__ = "0.1.0"
