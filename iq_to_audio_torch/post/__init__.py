"""Post-processing: audio squelch/trim batch, digital-decoder hand-off (the
port's copy of the JAX package's ``post/``, host numpy only)."""

from .squelch import (
    AudioPostOptions,
    SquelchConfig,
    SquelchFileResult,
    SquelchSummary,
    apply_squelch,
    gather_audio_targets,
    process_audio_batch,
    process_audio_file,
)

__all__ = [
    "AudioPostOptions",
    "SquelchConfig",
    "SquelchFileResult",
    "SquelchSummary",
    "apply_squelch",
    "gather_audio_targets",
    "process_audio_batch",
    "process_audio_file",
]
