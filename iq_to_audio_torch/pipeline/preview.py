"""Short preview renders.

A preview is just a normal pipeline run over the first ``seconds`` of
the capture, written next to the real output with a ``_preview`` stem
suffix so the full-length file is never clobbered. Matches the behavior
of the reference preview runner (reference ``preview.py``): a missing
``--fc`` fails before any DSP starts.
"""

from __future__ import annotations

import logging
from collections.abc import Callable
from dataclasses import replace
from pathlib import Path

from ..utils import spans
from .capture import default_output_path
from .config import ProcessingConfig
from .pipeline import ProcessingPipeline, ProcessingResult
from .progress import ProgressSink

LOG = logging.getLogger(__name__)


@spans.job
def run_preview(
    config: ProcessingConfig,
    seconds: float,
    *,
    progress_sink: ProgressSink | None = None,
    on_pipeline: Callable[[ProcessingPipeline], None] | None = None,
) -> tuple[ProcessingResult, Path]:
    """Render the first ``seconds`` of ``config`` to a ``*_preview`` file.

    ``on_pipeline`` (optional) receives the constructed pipeline before it
    runs — front ends use it to grab a cancellation handle.

    Returns ``(result, preview_path)``.
    """
    if seconds <= 0:
        raise ValueError("Preview seconds must be positive.")

    # Destination: the configured output (or the default audio_<ft>_48k.wav
    # name) with "_preview" spliced in before the extension.
    base = config.output_path or default_output_path(config.in_path, max(config.target_freq, 0))
    dest = base.with_name(base.stem + "_preview" + base.suffix)
    dest.parent.mkdir(parents=True, exist_ok=True)

    # the run resolves the centre before any DSP: a missing --fc fails first
    pipeline = ProcessingPipeline(replace(config, output_path=dest, max_input_seconds=seconds))
    if on_pipeline is not None:
        try:
            on_pipeline(pipeline)
        except Exception as exc:  # pragma: no cover - defensive
            raise RuntimeError(f"Failed to initialize preview pipeline: {exc}") from exc

    result = pipeline.run(progress_sink=progress_sink)
    LOG.info("Preview DSP complete (%s)", dest)
    return result, dest
