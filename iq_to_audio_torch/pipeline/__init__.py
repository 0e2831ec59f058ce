"""Pipeline orchestration: config, filter design, the chunk step and loop."""

from .config import ProcessingConfig
from .pipeline import ProcessingCancelled, ProcessingPipeline, ProcessingResult

__all__ = ["ProcessingCancelled", "ProcessingConfig", "ProcessingPipeline", "ProcessingResult"]
