"""Session models shared between the GUI and the CLI driver (reference
``interactive/models.py``)."""

from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np

from ..analysis.spectrum import WaterfallResult
from ..pipeline.config import ProcessingConfig
from ..pipeline.progress import PhaseState, ProgressSink

#: cap on raw samples retained with a snapshot (~64 MB of complex64)
MAX_RETAINED_SAMPLES = 8_000_000


@dataclass
class SnapshotData:
    """Result of the spectrum snapshot pass over the first N seconds."""

    freqs: np.ndarray
    psd_db: np.ndarray
    waterfall: WaterfallResult
    frames: int
    sample_rate: float
    retained: np.ndarray  # first raw samples (<= MAX_RETAINED_SAMPLES)
    seconds: float


@dataclass
class InteractiveSessionResult:
    """What the GUI hands back to the CLI main loop."""

    configs: list[ProcessingConfig] = field(default_factory=list)
    progress_sink: ProgressSink | None = None
    #: burst mode chosen in the Channel panel: segment count for the
    #: heterogeneous executor (0 = serial streaming)
    burst_segments: int = 0


class StatusProgressSink(ProgressSink):
    """Adapts ProgressSink events to status-bar callbacks (reference
    ``models.py:52-120``)."""

    def __init__(
        self,
        status_cb: Callable[[str], None] | None = None,
        progress_cb: Callable[[float], None] | None = None,
    ):
        self._status_cb = status_cb
        self._progress_cb = progress_cb
        self._cancel_callback: Callable[[], None] | None = None

    @property
    def is_live(self) -> bool:
        """Whether anything observes this sink.  A callback-less sink (the
        Confirm & Run hand-off after the window closed) reports False so
        the CLI driver can substitute its tqdm sink instead of running a
        long job with zero progress output."""
        return self._status_cb is not None or self._progress_cb is not None

    def start(self, phases, *, overall_total: float) -> None:
        if self._progress_cb:
            self._progress_cb(0.0)

    def advance(
        self,
        phase: PhaseState,
        delta: float,
        *,
        overall_completed: float,
        overall_total: float,
    ) -> None:
        if self._progress_cb and overall_total > 0:
            self._progress_cb(min(overall_completed / overall_total, 1.0))

    def status(self, message: str) -> None:
        if self._status_cb:
            self._status_cb(message)

    def close(self) -> None:
        if self._progress_cb:
            self._progress_cb(1.0)

    def set_cancel_callback(self, callback: Callable[[], None]) -> None:
        self._cancel_callback = callback

    def request_cancel(self) -> None:
        if self._cancel_callback:
            self._cancel_callback()

    def cancel(self) -> None:
        if self._status_cb:
            self._status_cb("Cancelling…")
