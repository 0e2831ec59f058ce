"""Background workers (reference ``interactive/workers.py``).

``gather_snapshot``/``compute_full_psd`` are plain functions (testable
without Qt); the QRunnable wrappers route results back to the UI thread via
queued signals.  Port of the JAX package's ``interactive/workers.py``: the
snapshot and the full-capture PSD take ``device=`` and run their FFTs there
with ``torch.fft`` (``None`` means the card, as everywhere in the port),
where the JAX package runs them on the host with numpy.
"""

from __future__ import annotations

import logging
from collections.abc import Callable
from pathlib import Path

import numpy as np

from ..analysis.spectrum import streaming_waterfall
from ..io.formats import InputFormatSpec
from ..io.reader import IQReader
from ..pipeline.config import ProcessingConfig
from ..pipeline.pipeline import ProcessingCancelled, ProcessingPipeline
from ..pipeline.preview import run_preview
from .models import MAX_RETAINED_SAMPLES, SnapshotData

LOG = logging.getLogger(__name__)


def gather_snapshot(
    path: Path,
    spec: InputFormatSpec,
    sample_rate: float,
    seconds: float,
    *,
    iq_order: str = "iq",
    nfft: int = 262_144,
    max_slices: int = 400,
    progress_cb: Callable[[float], None] | None = None,
    cancelled: Callable[[], bool] | None = None,
    device=None,
) -> SnapshotData:
    """Stream the first ``seconds`` through the waterfall accumulator
    (reference ``workers.py:36-161``)."""
    total = max(1, int(seconds * sample_rate))
    chunk = max(nfft, 1 << 18)
    retained: list[np.ndarray] = []
    retained_count = 0
    consumed = 0

    def _chunks():
        nonlocal consumed, retained_count
        with IQReader(
            path,
            chunk,
            iq_order,
            spec,
            sample_rate=sample_rate if spec.container == "raw" else None,
        ) as reader:
            for block in reader:
                if cancelled and cancelled():
                    return
                remaining = total - consumed
                if remaining <= 0:
                    return
                if block.size > remaining:
                    block = block[:remaining]
                consumed += block.size
                if retained_count < MAX_RETAINED_SAMPLES:
                    take = min(block.size, MAX_RETAINED_SAMPLES - retained_count)
                    retained.append(block[:take].copy())
                    retained_count += take
                if progress_cb:
                    progress_cb(min(consumed / total, 1.0))
                yield block

    nfft_eff = min(nfft, total)
    freqs, avg_psd, waterfall, frames = streaming_waterfall(
        _chunks(), sample_rate, nfft=nfft_eff, max_slices=max_slices, device=device
    )
    return SnapshotData(
        freqs=freqs,
        psd_db=avg_psd,
        waterfall=waterfall,
        frames=frames,
        sample_rate=sample_rate,
        retained=np.concatenate(retained) if retained else np.empty(0, np.complex64),
        seconds=consumed / sample_rate if sample_rate > 0 else 0.0,
    )


def compute_full_psd(
    path: Path,
    spec: InputFormatSpec,
    sample_rate: float,
    *,
    iq_order: str = "iq",
    nfft: int = 262_144,
    progress_cb: Callable[[float], None] | None = None,
    cancelled: Callable[[], bool] | None = None,
    device=None,
):
    """Averaged PSD over the whole capture (reference ``workers.py:164-286``)."""
    consumed = 0
    with IQReader(
        path,
        max(nfft, 1 << 19),
        iq_order,
        spec,
        sample_rate=sample_rate if spec.container == "raw" else None,
    ) as reader:
        total = reader.total_frames
        # a capture shorter than the requested FFT still analyzes: clamp to
        # the capture length (matches gather_snapshot's nfft_eff)
        nfft_eff = min(nfft, total) if total else nfft

        def _chunks():
            nonlocal consumed
            for block in reader:
                if cancelled and cancelled():
                    return
                consumed += block.size
                if progress_cb and total:
                    progress_cb(min(consumed / total, 1.0))
                yield block

        freqs, avg_psd, _, frames = streaming_waterfall(
            _chunks(), sample_rate, nfft=nfft_eff, max_slices=1, device=device
        )
    return freqs, avg_psd, frames


def snapshot_from_retained(
    snap: SnapshotData,
    *,
    seconds: float | None = None,
    nfft: int = 262_144,
    max_slices: int = 400,
    device=None,
) -> SnapshotData | None:
    """Recompute a snapshot from its retained raw samples — no file IO.

    This is what ``SnapshotData.retained`` exists for: when the retained
    buffer covers the whole snapshot window (the common case — 2 s at
    2.5 MS/s is 5 M samples, under the 8 M cap), FFT-size / slice-count
    changes re-render instantly instead of re-streaming the capture.
    Returns None when the retained buffer is too short for the request
    (caller falls back to a fresh file pass).
    """
    want_seconds = snap.seconds if seconds is None else min(seconds, snap.seconds)
    want = int(want_seconds * snap.sample_rate)
    covered = int(round(snap.seconds * snap.sample_rate))
    if want <= 0 or snap.retained.size < min(want, covered):
        return None
    samples = snap.retained[:want] if snap.retained.size > want else snap.retained
    nfft_eff = min(nfft, samples.size)
    if nfft_eff < 2:
        return None
    freqs, avg_psd, waterfall, frames = streaming_waterfall(
        iter([samples]), snap.sample_rate, nfft=nfft_eff, max_slices=max_slices,
        device=device,
    )
    return SnapshotData(
        freqs=freqs,
        psd_db=avg_psd,
        waterfall=waterfall,
        frames=frames,
        sample_rate=snap.sample_rate,
        retained=snap.retained,
        seconds=samples.size / snap.sample_rate,
    )


# ---------------------------------------------------------------------------
# Qt runnables (import guarded: everything above is usable headless)
# ---------------------------------------------------------------------------

from ._qt import QObject, QRunnable, Signal, Slot

class _SnapshotSignals(QObject):
    finished = Signal(object)  # SnapshotData
    failed = Signal(str)
    progress = Signal(float)

class SnapshotWorker(QRunnable):
    """Gather a spectrum snapshot off the UI thread."""

    def __init__(self, path, spec, sample_rate, seconds, *, iq_order="iq", nfft=262_144,
                 max_slices=400, device=None):
        super().__init__()
        self.signals = _SnapshotSignals()
        self._args = (path, spec, sample_rate, seconds)
        self._kw = dict(iq_order=iq_order, nfft=nfft, max_slices=max_slices, device=device)
        self._cancelled = False

    def cancel(self):
        self._cancelled = True

    @Slot()
    def run(self):
        try:
            snap = gather_snapshot(
                *self._args,
                **self._kw,
                progress_cb=self.signals.progress.emit,
                cancelled=lambda: self._cancelled,
            )
            if not self._cancelled:
                self.signals.finished.emit(snap)
        except Exception as exc:  # surfaced in the status bar
            if self._cancelled:
                # a cancelled chunk generator can leave the stream shorter
                # than one FFT frame; that failure is self-inflicted and
                # must not clobber the replacement worker's status line
                return
            LOG.exception("Snapshot failed")
            self.signals.failed.emit(str(exc))

class _PreviewSignals(QObject):
    finished = Signal(list)  # [(config, result, path)]
    failed = Signal(str)
    status = Signal(str)
    progress = Signal(float)

class PreviewWorker(QRunnable):
    """Run preview DSP for the session configs (reference
    ``workers.py:348-410``)."""

    def __init__(self, configs: list[ProcessingConfig], seconds: float):
        super().__init__()
        self.signals = _PreviewSignals()
        self.configs = configs
        self.seconds = seconds
        self._pipelines: list[ProcessingPipeline] = []
        self._cancelled = False

    def cancel(self):
        self._cancelled = True
        for p in self._pipelines:
            p.cancel()

    @Slot()
    def run(self):
        from .models import StatusProgressSink

        results = []
        try:
            for config in self.configs:
                if self._cancelled:
                    return
                sink = StatusProgressSink(
                    self.signals.status.emit, self.signals.progress.emit
                )
                result, out_path = run_preview(
                    config,
                    self.seconds,
                    progress_sink=sink,
                    on_pipeline=self._pipelines.append,
                )
                results.append((config, result, out_path))
            self.signals.finished.emit(results)
        except ProcessingCancelled:
            self.signals.status.emit("Preview cancelled.")
        except Exception as exc:
            LOG.exception("Preview failed")
            self.signals.failed.emit(str(exc))

class _AudioPostSignals(QObject):
    finished = Signal(object)  # SquelchSummary
    failed = Signal(str)
    progress = Signal(int, int, str)

class AudioPostWorker(QRunnable):
    def __init__(self, targets, options):
        super().__init__()
        self.signals = _AudioPostSignals()
        self.targets = targets
        self.options = options

    @Slot()
    def run(self):
        from ..post.squelch import process_audio_batch

        try:
            summary = process_audio_batch(
                self.targets,
                self.options,
                progress_cb=lambda done, total, p: self.signals.progress.emit(
                    done, total, str(p)
                ),
            )
            self.signals.finished.emit(summary)
        except Exception as exc:
            LOG.exception("Audio post failed")
            self.signals.failed.emit(str(exc))

class _DockerSignals(QObject):
    log = Signal(str)
    finished = Signal(int)
    failed = Signal(str)

class DockerLaunchWorker(QRunnable):
    """Launch a backend decoder container and stream its logs
    (reference ``workers.py:452-525``).

    ``backend_or_factory`` may be a ready :class:`DockerBackend` or a
    zero-arg factory; with a factory, construction AND the connectivity
    check run on the pool thread — ``docker.from_env`` performs blocking
    engine HTTP calls that must never run on the GUI thread."""

    def __init__(self, backend_or_factory, request):
        super().__init__()
        self.signals = _DockerSignals()
        self.backend = backend_or_factory if not callable(backend_or_factory) else None
        self._factory = backend_or_factory if callable(backend_or_factory) else None
        self.request = request
        self._cancelled = False
        self._container_id = None

    def cancel(self):
        self._cancelled = True
        if self._container_id is not None and self.backend is not None:
            self.backend.kill_container(self._container_id)

    def _note_container(self, container_id: str):
        """run_and_stream hands the id over right after start; if Stop was
        already pressed, kill immediately instead of racing the stream."""
        self._container_id = container_id
        if self._cancelled:
            self.backend.kill_container(container_id)

    @Slot()
    def run(self):
        try:
            if self.backend is None:
                self.backend = self._factory()
                self.backend.ensure_connection()
            if self._cancelled:
                return
            code = self.backend.run_and_stream(
                self.request,
                log_callback=self.signals.log.emit,
                on_container=self._note_container,
            )
            self.signals.finished.emit(code)
        except Exception as exc:
            if not self._cancelled:
                self.signals.failed.emit(str(exc))

class _DockerProbeSignals(QObject):
    result = Signal(bool, str)

class DockerProbeWorker(QRunnable):
    def __init__(self, backend_factory):
        super().__init__()
        self.signals = _DockerProbeSignals()
        self.backend_factory = backend_factory

    @Slot()
    def run(self):
        try:
            backend = self.backend_factory()
            conn = backend.probe()
            if not conn.available:
                # don't let a failed image-info fetch mask the real
                # connectivity message
                self.signals.result.emit(False, conn.message)
                return
            info = backend.get_image_info()
            self.signals.result.emit(True, info.format_status())
        except Exception as exc:
            self.signals.result.emit(False, str(exc))

class DockerImageUpdateWorker(QRunnable):
    def __init__(self, backend_or_factory):
        super().__init__()
        self.signals = _DockerProbeSignals()
        self.backend = (
            backend_or_factory if not callable(backend_or_factory) else None
        )
        self._factory = backend_or_factory if callable(backend_or_factory) else None

    @Slot()
    def run(self):
        try:
            backend = self.backend if self.backend is not None else self._factory()
            backend.pull_image()
            info = backend.get_image_info()
            self.signals.result.emit(True, info.format_status())
        except Exception as exc:
            self.signals.result.emit(False, str(exc))
