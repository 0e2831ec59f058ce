"""Pipeline orchestration: config, filter design, the chunk step and loop."""

from .config import ProcessingConfig
from .pipeline import ProcessingPipeline, ProcessingResult

__all__ = ["ProcessingConfig", "ProcessingPipeline", "ProcessingResult"]
