"""NumPy float64 reference twins of every device op.

These mirror the algorithms of the upstream reference implementation
(reference ``processing.py`` / ``decoders/``) and serve three purposes:

1. Golden-comparison tests: device output must match the twin within -60 dB.
2. The warm-up mixer-sign probe runs on the twin on a CPU device, and holds
   the probe's CUDA kernel (``ops/mix_probe.py``) to it.
3. Documentation of the exact streaming-state semantics the device must keep.
"""

from .chain import (
    RefOscillator,
    RefOverlapSaveFIR,
    RefDecimator,
    RefQuadratureDemod,
    RefDeemphasis,
    RefDCBlocker,
    RefAGC,
    RefResampler,
    ref_demod_chain,
    choose_mix_sign,
)

__all__ = [
    "RefOscillator",
    "RefOverlapSaveFIR",
    "RefDecimator",
    "RefQuadratureDemod",
    "RefDeemphasis",
    "RefDCBlocker",
    "RefAGC",
    "RefResampler",
    "ref_demod_chain",
    "choose_mix_sign",
]
