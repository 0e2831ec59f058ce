"""Host utilities: center-frequency detection, dBFS helpers."""

from .freq import (
    CenterFrequencyResult,
    detect_center_frequency,
    parse_center_frequency,
)

__all__ = [
    "CenterFrequencyResult",
    "detect_center_frequency",
    "parse_center_frequency",
]
