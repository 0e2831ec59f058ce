"""iq-to-audio on PyTorch and CUDA: the port of ``iq_to_audio_tpu`` to an
NVIDIA Hopper card.

The pipeline streams a baseband IQ capture through one chunk step per
block for one to five target channels: the hand-written CUDA polyphase-FIR
channelizer (``csrc/poly_fir.cu``), the decimated-rate mixer, the NFM, AM
or USB/LSB demodulator (with the SSB feedback AGC), the 48 kHz polyphase
resampler and the s16 encode; runs can be cancelled, checkpointed and
resumed, slice the channel IQ instead of demodulating it
(``demod_mode="none"``), dump it beside the audio, plot the stages of the
first chunk and profile the chunk loop.  ``IQ2A_CHANNELIZER`` selects one
of the other channelizers (FFT bank, native C++ on the CPU).
``python -m iq_to_audio_torch`` is the command line (:mod:`.cli`).  Entry
points run on the card unless the caller asks for the CPU
(``ProcessingConfig(device="cpu")``, ``--device cpu``), where each kernel's
plain torch version runs instead.  The package imports neither JAX nor the
JAX package.
"""

from __future__ import annotations

__version__ = "0.1.0"

from .pipeline.config import ProcessingConfig  # noqa: E402
from .pipeline.pipeline import (  # noqa: E402
    ProcessingCancelled,
    ProcessingPipeline,
    ProcessingResult,
)

__all__ = [
    "__version__",
    "ProcessingCancelled",
    "ProcessingConfig",
    "ProcessingPipeline",
    "ProcessingResult",
]
