"""Interactive main window (reference ``interactive/app.py``).

A three-page QMainWindow: Capture (spectrum picker), Audio Post (squelch
batch) and Digital Post (container decoders).  The capture page pairs a
fixed control column with an interactive matplotlib spectrum: hover cursor,
click-to-add targets, scroll zoom, drag-span bandwidth selection and a
synchronised waterfall window.  "Confirm & Run" hands the assembled
ProcessingConfigs back to the CLI main loop.

Port of the JAX package's ``interactive/app.py``.  The session's device is
``base_kwargs["device"]`` (the command line's ``--device``; absent or
None means the card): the snapshot, the full-capture PSD and the spectrum
re-render from retained samples run their FFTs there, and the configs the
window builds for the preview and the confirmed run carry it.
"""

from __future__ import annotations

import logging
import signal
import socket
from pathlib import Path

import numpy as np
from ._qt import (
    HEADLESS,
    FigureCanvas,
    Figure,
    QAction,
    QApplication,
    QFileDialog,
    QKeySequence,
    QLabel,
    QMainWindow,
    QObject,
    QScrollArea,
    QSocketNotifier,
    QStackedWidget,
    QStatusBar,
    QThreadPool,
    QTimer,
    QToolBar,
    QVBoxLayout,
    QWidget,
    Qt,
    Signal,
)

from ..io.formats import detect_input_format, resolve_input_format
from ..io.probe import probe_sample_rate
from ..utils.freq import detect_center_frequency
from .models import InteractiveSessionResult, SnapshotData, StatusProgressSink
from .panels import (
    ChannelPanel,
    DemodPanel,
    RecordingPanel,
    SpectrumOptionsPanel,
    StatusPanel,
    TargetsPanel,
    WaterfallOptionsPanel,
)
from .post import AudioPostPage, DigitalPostPage
from .state import SPECTRUM_THEMES, InteractiveState
from .styles import DARK_STYLESHEET, STYLESHEETS
from .widgets import LockedSplitter, SpanController, WaterfallWindow
from .workers import PreviewWorker, SnapshotWorker

LOG = logging.getLogger(__name__)

_CLICK_DRAG_THRESHOLD_PX = 5.0

#: snapshot FFT sizes above this are clamped (matches the largest
#: SpectrumOptionsPanel choice, reference state.py nfft range)
_MAX_SNAPSHOT_NFFT = 1 << 19


class _SigintRelay(QObject):
    """Relay SIGINT into the Qt event loop via a socketpair (reference
    ``app.py:135-178``)."""

    triggered = Signal()

    def __init__(self, app: QApplication):
        super().__init__()
        self._rsock, self._wsock = socket.socketpair()
        self._rsock.setblocking(False)
        self._wsock.setblocking(False)  # set_wakeup_fd requires non-blocking
        self._notifier = QSocketNotifier(self._rsock.fileno(), QSocketNotifier.Read)
        self._notifier.activated.connect(self._handle)
        self._old_handler = signal.signal(signal.SIGINT, self._signal_handler)
        self._old_wakeup = signal.set_wakeup_fd(self._wsock.fileno())
        self._app = app

    def _signal_handler(self, signum, frame):
        pass  # the wakeup fd write is enough

    def _handle(self):
        try:
            self._rsock.recv(1024)
        except OSError:
            pass
        self.triggered.emit()

    def restore(self):
        signal.signal(signal.SIGINT, self._old_handler)
        try:
            signal.set_wakeup_fd(self._old_wakeup)
        except ValueError:
            pass


class InteractiveWindow(QMainWindow):
    def __init__(
        self,
        base_kwargs: dict | None = None,
        input_path: Path | None = None,
        snapshot_seconds: float = 2.0,
    ):
        super().__init__()
        self.setWindowTitle("iq-to-audio-torch")
        self.resize(1280, 800)
        self.state = InteractiveState(base_kwargs=dict(base_kwargs or {}))
        self.state.snapshot_seconds = snapshot_seconds
        if base_kwargs:
            self.state.bandwidth = base_kwargs.get("bandwidth", self.state.bandwidth)
            self.state.demod_mode = base_kwargs.get("demod_mode", self.state.demod_mode)
            if base_kwargs.get("center_freq") is not None:
                # an explicit --fc pins the center; file metadata must not
                # overwrite it (reference honors kwargs center_freq/source)
                self.state.center_freq = float(base_kwargs["center_freq"])
                self.state.center_freq_source = (
                    base_kwargs.get("center_freq_source") or "cli"
                )
            for f in base_kwargs.get("target_freqs") or []:
                self.state.add_target(f)
        self.result = InteractiveSessionResult()
        self._pool = QThreadPool.globalInstance()
        self._snapshot: SnapshotData | None = None
        self._snapshot_nfft: int | None = None
        self._snapshot_worker = None
        self._preview_worker = None
        self._press_xy = None
        self._input_spec = None
        self._rendered = None  # (freqs, psd) of the plotted trace

        self._build_toolbar()
        self._build_pages()
        self.setStatusBar(QStatusBar())
        self._cursor_label = QLabel("")
        self.statusBar().addPermanentWidget(self._cursor_label)
        self._update_status_controls()

        if input_path is not None:
            QTimer.singleShot(0, lambda: self._load_file(Path(input_path)))

    # ------------------------------------------------------------------ UI

    def _build_toolbar(self):
        bar = QToolBar("Main")
        bar.setMovable(False)
        self.addToolBar(bar)

        def act(label, shortcut, slot):
            action = QAction(label, self)
            if shortcut:
                action.setShortcut(QKeySequence(shortcut))
            action.triggered.connect(slot)
            bar.addAction(action)
            return action

        act("Open", "Ctrl+O", lambda: self.recording_panel._browse())
        self.preview_action = act("Preview", "Ctrl+P", self._start_preview)
        self.run_action = act("Confirm && Run", "Ctrl+R", self._confirm_run)
        self.stop_action = act("Stop", "Esc", self._stop_workers)
        act("Export Spectrum", "Ctrl+E", self._export_spectrum)
        act("Capture", None, lambda: self.pages.setCurrentIndex(0))
        act("Audio Post", None, lambda: self.pages.setCurrentIndex(1))
        act("Digital Post", None, lambda: self.pages.setCurrentIndex(2))
        act("Close", "Ctrl+Q", self.close)

    def _build_pages(self):
        self.pages = QStackedWidget()
        self.setCentralWidget(self.pages)
        self.pages.addWidget(self._build_capture_page())
        self.audio_post_page = AudioPostPage()
        self.audio_post_page.status.connect(self._status)
        self.pages.addWidget(self.audio_post_page)
        self.digital_post_page = DigitalPostPage()
        self.digital_post_page.status.connect(self._status)
        self.pages.addWidget(self.digital_post_page)

    def _build_capture_page(self) -> QWidget:
        splitter = LockedSplitter(Qt.Horizontal, 360)

        column_host = QWidget()
        column = QVBoxLayout(column_host)
        column.setContentsMargins(4, 4, 4, 4)
        self.recording_panel = RecordingPanel(self.state)
        self.recording_panel.file_selected.connect(self._load_file)
        self.recording_panel.settings_changed.connect(self._schedule_snapshot)
        self.demod_panel = DemodPanel(self.state)
        self.channel_panel = ChannelPanel(self.state)
        self.channel_panel.changed.connect(self._selection_changed)
        self.targets_panel = TargetsPanel(self.state)
        self.targets_panel.changed.connect(self._targets_changed)
        self.status_panel = StatusPanel()
        self.status_panel.preview_requested.connect(self._start_preview)
        self.status_panel.run_requested.connect(self._confirm_run)
        self.status_panel.stop_requested.connect(self._stop_workers)
        self.spectrum_options = SpectrumOptionsPanel(self.state)
        self.spectrum_options.changed.connect(self._spectrum_settings_changed)
        self.spectrum_options.full_psd_btn.clicked.connect(self._analyze_full)
        self.spectrum_options.export_btn.clicked.connect(self._export_spectrum)
        self.waterfall_options = WaterfallOptionsPanel(self.state)
        self.waterfall_options.changed.connect(self._update_waterfall)
        self.waterfall_options.show_btn.clicked.connect(self._show_waterfall)
        for panel in (
            self.recording_panel,
            self.demod_panel,
            self.channel_panel,
            self.targets_panel,
            self.status_panel,
            self.spectrum_options,
            self.waterfall_options,
        ):
            column.addWidget(panel)
        column.addStretch(1)
        scroll = QScrollArea()
        scroll.setWidget(column_host)
        scroll.setWidgetResizable(True)
        scroll.setFixedWidth(360)
        splitter.addWidget(scroll)

        plot_host = QWidget()
        plot_layout = QVBoxLayout(plot_host)
        self.figure = Figure(layout="constrained")
        self.canvas = FigureCanvas(self.figure)
        self.ax = self.figure.add_subplot(111)
        plot_layout.addWidget(self.canvas)
        splitter.addWidget(plot_host)

        self.span = SpanController(self.ax, self._span_selected)
        self.canvas.mpl_connect("button_press_event", self._on_press)
        self.canvas.mpl_connect("button_release_event", self._on_release)
        self.canvas.mpl_connect("scroll_event", self._on_scroll)
        self.canvas.mpl_connect("motion_notify_event", self._on_motion)
        self._cursor_line = None
        self.waterfall_window = WaterfallWindow(self)
        self.waterfall_window.frequency_clicked.connect(self._retune_from_waterfall)
        return splitter

    # ------------------------------------------------------------- file flow

    def _load_file(self, path: Path):
        self.recording_panel.set_path(path)
        detection = detect_input_format(path)
        self._format_detection = detection
        if detection.ok:
            self._input_spec = detection.spec
        else:
            self._status(detection.error or "Unknown input format")
            self._input_spec = None
        self._refresh_format_status()
        probe = probe_sample_rate(path)
        try:
            self.state.sample_rate = probe.value
        except RuntimeError:
            self.state.sample_rate = None
        self.channel_panel.show_rate(self.state.effective_sample_rate)
        if self.state.center_freq_source == "cli" and self.state.center_freq:
            # --fc wins over whatever the file claims
            self.recording_panel.show_center(self.state.center_freq, "cli")
        else:
            freq = detect_center_frequency(path)
            if freq.value is not None:
                self.state.center_freq = freq.value
                self.state.center_freq_source = freq.source
                self.recording_panel.show_center(freq.value, freq.source)
        self._push_recent_outputs(selected_path=path)
        self._update_status_controls()
        self._schedule_snapshot()

    def _refresh_format_status(self):
        """Format summary under the Recording panel's combo: a manual
        override, the detection result, or the detection failure in the
        error color (reference app.py:953-963 keeps the same label)."""
        override = self.state.input_format_override
        detection = getattr(self, "_format_detection", None)
        if override:
            self.recording_panel.show_format_status(
                f"{override} (manual override)"
            )
        elif detection is None:
            self.recording_panel.show_format_status(
                "Select a recording to detect the input format."
            )
        elif detection.ok:
            label = detection.spec.label
            src = f" — {detection.source}" if detection.source else ""
            self.recording_panel.show_format_status(f"{label}{src}")
        else:
            self.recording_panel.show_format_status(
                detection.error or "Unknown input format", error=True
            )

    def _push_recent_outputs(
        self, *, selected_path: Path | None = None, output_dir: Path | None = None
    ):
        """Hand the latest capture/output location to the post pages so
        audio-post and digital hand-off default to what was just produced
        (reference app.py:893-919)."""
        selected = selected_path or self.state.input_path
        resolved = output_dir or self.state.output_dir
        if resolved is None and selected is not None:
            resolved = Path(selected).parent
        self.audio_post_page.update_recent_capture(
            selected_path=selected, output_dir=resolved
        )
        self.digital_post_page.update_recent_capture(output_dir=resolved)

    def _current_spec(self):
        """The effective input spec: the manual override when set (it wins
        even when detection failed), else the detection result."""
        if self.state.input_format_override and self.state.input_path is not None:
            spec, _ = resolve_input_format(
                self.state.input_path, requested=self.state.input_format_override
            )
            return spec
        return self._input_spec

    @property
    def _iq_order(self) -> str:
        """--iq-order rides base_kwargs; the display must mirror what the
        pipeline will actually process (else a qi capture renders
        frequency-flipped and clicked targets tune the wrong channel)."""
        return self.state.base_kwargs.get("iq_order") or "iq"

    @property
    def _device(self):
        """The session's torch device (None: the card)."""
        return self.state.base_kwargs.get("device")

    def _schedule_snapshot(self):
        self._refresh_format_status()  # override changes land here
        if self.state.input_path is None:
            return
        if self._input_spec is None and self.state.input_format_override is None:
            return
        rate = self.state.effective_sample_rate
        if not rate:
            self._status("Enter a sample rate to preview this capture.")
            return
        spec = self._current_spec()
        if self._snapshot_worker is not None:
            self._snapshot_worker.cancel()
        worker = SnapshotWorker(
            self.state.input_path,
            spec,
            rate,
            self.state.snapshot_seconds,
            iq_order=self._iq_order,
            nfft=min(self.state.spectrum_nfft, _MAX_SNAPSHOT_NFFT),
            max_slices=self.state.waterfall_slices,
            device=self._device,
        )
        worker.signals.finished.connect(self._snapshot_ready)
        worker.signals.failed.connect(self._status)
        worker.signals.progress.connect(self.status_panel.set_progress)
        self._snapshot_worker = worker
        self._snapshot_nfft = min(self.state.spectrum_nfft, _MAX_SNAPSHOT_NFFT)
        self._status("Gathering spectrum snapshot…")
        self._pool.start(worker)

    def _spectrum_settings_changed(self):
        """Spectrum-panel knob turned.  Smoothing/theme/range only need a
        redraw; an FFT-size change needs the PSD recomputed — from the
        snapshot's retained raw samples when they cover the window (no
        file IO), else by re-streaming the capture."""
        want_nfft = min(self.state.spectrum_nfft, _MAX_SNAPSHOT_NFFT)
        if self._snapshot is not None and want_nfft != getattr(
            self, "_snapshot_nfft", want_nfft
        ):
            from .workers import snapshot_from_retained

            snap = snapshot_from_retained(
                self._snapshot,
                nfft=want_nfft,
                max_slices=self.state.waterfall_slices,
                device=self._device,
            )
            if snap is None:
                self._schedule_snapshot()
                return
            self._snapshot = snap
            self._snapshot_nfft = want_nfft
            self._update_waterfall()
        self._render_snapshot()

    def _snapshot_ready(self, snap: SnapshotData):
        self._snapshot = snap
        self._status(
            f"Snapshot ready: {snap.frames} FFT frames over {snap.seconds:.2f} s."
        )
        self._render_snapshot()
        self._update_waterfall()

    # ----------------------------------------------------------- spectrum UI

    def _render_snapshot(self):
        if self._snapshot is None:
            return
        snap = self._snapshot
        theme = SPECTRUM_THEMES.get(self.state.spectrum_theme, SPECTRUM_THEMES["Night"])
        center = self.state.center_freq or 0.0
        psd = snap.psd_db
        k = max(1, int(self.state.spectrum_smoothing))
        if k > 1:
            kernel = np.ones(k) / k
            psd = np.convolve(psd, kernel, mode="same")
        self.ax.clear()
        self._cursor_line = None
        freqs = snap.freqs + center
        self.ax.plot(freqs, psd, color=theme["line"], lw=0.7)
        self._rendered = (freqs, psd)
        top = float(np.percentile(psd, 99.5)) + 5.0
        self.ax.set_ylim(top - self.state.spectrum_dynamic_range, top)
        self.ax.set_xlim(freqs[0], freqs[-1])
        self.ax.set_facecolor(theme["bg"])
        self.figure.set_facecolor(theme["bg"])
        self.ax.tick_params(colors=theme["fg"])
        for spine in self.ax.spines.values():
            spine.set_color(theme["grid"])
        self.ax.grid(
            True,
            color=theme["grid"],
            linestyle=theme.get("grid_style", ":"),
            alpha=0.5,
            lw=0.4,
        )
        self.ax.set_xlabel("Frequency (Hz)", color=theme["fg"])
        self.ax.set_ylabel("dBFS/Hz", color=theme["fg"])
        self.span.disconnect()
        self.span = SpanController(self.ax, self._span_selected)
        self._draw_targets()
        self.canvas.draw_idle()

    def _draw_targets(self):
        for freq in self.state.targets:
            self.ax.axvline(freq, color="#7cc379", lw=0.9, alpha=0.9)
        if self.state.targets:
            self.span.show_selection(self.state.targets[-1], self.state.bandwidth)

    def _update_waterfall(self):
        if self._snapshot is None or not self.waterfall_window.isVisible():
            return
        snap = self._snapshot
        self.waterfall_window.show_waterfall(
            snap.freqs,
            snap.waterfall.times,
            snap.waterfall.matrix,
            center_freq=self.state.center_freq or 0.0,
            floor_db=self.state.waterfall_floor_db,
            colormap=self.state.waterfall_colormap,
        )

    def _show_waterfall(self):
        self.waterfall_window.show()
        self._update_waterfall()

    def _analyze_full(self):
        """Average the ENTIRE capture into the spectrum (reference README
        'Analyze entire recording' toggle)."""
        if self.state.input_path is None:
            self._status("Open a recording first.")
            return
        spec = self._current_spec()
        if spec is None:
            self._status("Pick an input format override first — detection failed.")
            return
        rate = self.state.effective_sample_rate
        if not rate:
            self._status("Enter a sample rate first.")
            return
        from ._qt import QRunnable, QObject, Signal, Slot

        window = self
        iq_order = self._iq_order
        device = self._device

        class _FullPsdWorker(QRunnable):
            class Signals(QObject):
                finished = Signal(object)
                failed = Signal(str)
                progress = Signal(float)

            def __init__(self):
                super().__init__()
                self.signals = self.Signals()

            @Slot()
            def run(self):
                from .workers import compute_full_psd

                try:
                    result = compute_full_psd(
                        window.state.input_path,
                        spec,
                        rate,
                        iq_order=iq_order,
                        nfft=min(window.state.spectrum_nfft, _MAX_SNAPSHOT_NFFT),
                        progress_cb=self.signals.progress.emit,
                        device=device,
                    )
                    self.signals.finished.emit(result)
                except Exception as exc:
                    self.signals.failed.emit(str(exc))

        worker = _FullPsdWorker()
        # bound-method slot: emitted from the pool thread, queued to the
        # GUI thread (a closure connection would plot on the worker thread)
        worker.signals.finished.connect(self._on_full_psd)
        worker.signals.failed.connect(self._status)
        worker.signals.progress.connect(self.status_panel.set_progress)
        self._status("Averaging entire recording…")
        self._pool.start(worker)

    def _on_full_psd(self, result):
        freqs, psd, frames = result
        if self._snapshot is None:
            # no snapshot to attach to (e.g. detection failed and the user
            # supplied overrides, then analyzed directly): build a minimal
            # one so the averaged PSD actually renders instead of being
            # silently discarded behind a success message
            from ..analysis.spectrum import WaterfallResult
            from .models import SnapshotData

            empty = np.zeros(0, dtype=np.float64)
            self._snapshot = SnapshotData(
                freqs=freqs,
                psd_db=psd,
                waterfall=WaterfallResult(
                    freqs=freqs, times=empty, matrix=np.zeros((0, freqs.size))
                ),
                frames=frames,
                sample_rate=float(self.state.sample_rate or 0.0),
                retained=np.zeros(0, dtype=np.complex64),
                seconds=0.0,
            )
        else:
            self._snapshot.freqs = freqs
            self._snapshot.psd_db = psd
            self._snapshot.frames = frames
        self._status(f"Full-capture spectrum averaged over {frames} frames.")
        self._render_snapshot()

    def _retune_from_waterfall(self, freq: float):
        if self.state.add_target(freq):
            self.targets_panel.refresh()
            self._update_status_controls()
            self._render_snapshot()

    def _on_press(self, event):
        if event.inaxes is self.ax and event.button == 1:
            self._press_xy = (event.x, event.y)

    def _on_release(self, event):
        """Click (not drag) adds a target (reference ``app.py:1829-1856``)."""
        if (
            self._press_xy is None
            or event.inaxes is not self.ax
            or event.button != 1
            or event.xdata is None
        ):
            self._press_xy = None
            return
        dx = abs(event.x - self._press_xy[0])
        dy = abs(event.y - self._press_xy[1])
        self._press_xy = None
        if max(dx, dy) > _CLICK_DRAG_THRESHOLD_PX:
            return  # drag: handled by the span selector
        if self.state.add_target(float(event.xdata)):
            self.targets_panel.refresh()
            self._update_status_controls()
            self._render_snapshot()
            self._status(f"Added target {event.xdata / 1e6:.6f} MHz")

    def _on_scroll(self, event):
        """Zoom around the cursor, clamped to the capture span (reference
        ``app.py:1858-1904``)."""
        if event.inaxes is not self.ax or self._snapshot is None:
            return
        center = self.state.center_freq or 0.0
        full_lo = self._snapshot.freqs[0] + center
        full_hi = self._snapshot.freqs[-1] + center
        lo, hi = self.ax.get_xlim()
        factor = 0.8 if event.button == "up" else 1.25
        x = event.xdata if event.xdata is not None else 0.5 * (lo + hi)
        new_lo = x - (x - lo) * factor
        new_hi = x + (hi - x) * factor
        new_lo = max(new_lo, full_lo)
        new_hi = min(new_hi, full_hi)
        if new_hi - new_lo < 100.0:
            return
        self.ax.set_xlim(new_lo, new_hi)
        self.canvas.draw_idle()

    def _on_motion(self, event):
        if event.inaxes is not self.ax or event.xdata is None:
            return
        if self._cursor_line is None:
            self._cursor_line = self.ax.axvline(
                event.xdata, color="#9aa3b5", lw=0.5, alpha=0.6
            )
        else:
            self._cursor_line.set_xdata([event.xdata, event.xdata])
        if self._rendered is not None:
            freqs, psd = self._rendered
            k = int(np.searchsorted(freqs, event.xdata))
            k = min(max(k, 0), len(psd) - 1)
            self._cursor_label.setText(
                f"{event.xdata / 1e6:.6f} MHz · {psd[k]:.1f} dBFS/Hz"
            )
        self.canvas.draw_idle()

    def _span_selected(self, center: float, bandwidth: float):
        self.state.bandwidth = bandwidth
        self.channel_panel.set_bandwidth(bandwidth)
        if self.state.add_target(center):
            self.targets_panel.refresh()
            self._update_status_controls()
        self.span.show_selection(center, bandwidth)
        self._status(
            f"Selection {center / 1e6:.6f} MHz, bandwidth {bandwidth / 1e3:.2f} kHz"
        )

    def _selection_changed(self):
        self.channel_panel.show_rate(self.state.effective_sample_rate)

    def _targets_changed(self):
        """Target removed/cleared from the panel: redraw markers + re-gate."""
        self._update_status_controls()
        self._render_snapshot()

    def _update_status_controls(self):
        """Preview/Run are actionable only with a recording and >=1 target
        (reference ``_update_status_controls``); toolbar actions mirror the
        Status-panel buttons."""
        ready = self.state.input_path is not None and bool(self.state.targets)
        self.status_panel.set_ready(ready)
        self.preview_action.setEnabled(ready)
        self.run_action.setEnabled(ready)

    # --------------------------------------------------------------- actions

    def _start_preview(self):
        configs = self.state.build_configs()
        if not configs:
            self._status("Pick a recording and at least one target first.")
            return
        worker = PreviewWorker(configs, max(self.state.snapshot_seconds, 2.0))
        worker.signals.status.connect(self._status)
        worker.signals.progress.connect(self.status_panel.set_progress)
        worker.signals.finished.connect(self._preview_done)
        worker.signals.failed.connect(self._preview_failed)
        self._preview_worker = worker
        self.status_panel.set_busy(True)
        self._status("Preview DSP running…")
        self._pool.start(worker)

    def _preview_done(self, results):
        self.status_panel.set_busy(False)
        if results:
            paths = ", ".join(str(p) for _, _, p in results)
            self._status(f"Preview written: {paths}")
            self._push_recent_outputs(output_dir=Path(results[0][2]).parent)

    def _preview_failed(self, message: str):
        self.status_panel.set_busy(False)
        self._status(f"Preview failed: {message}")

    def _confirm_run(self):
        configs = self.state.build_configs()
        if not configs:
            self._status("Pick a recording and at least one target first.")
            return
        self.result.configs = configs
        self.result.progress_sink = StatusProgressSink()
        self.result.burst_segments = self.state.burst_segments
        self.close()

    def _stop_workers(self):
        if self._preview_worker is not None:
            self._preview_worker.cancel()
        if self._snapshot_worker is not None:
            self._snapshot_worker.cancel()
        self.status_panel.set_busy(False)
        self._status("Stopped.")

    def _export_spectrum(self):
        """Save the current spectrum figure to a PNG the user picks."""
        if self._snapshot is None:
            self._status("Load a recording first — nothing to export.")
            return
        path, _ = QFileDialog.getSaveFileName(
            self, "Export spectrum", "spectrum.png", "PNG image (*.png)"
        )
        if not path:
            return
        self.figure.savefig(path, dpi=150)
        self._status(f"Spectrum exported: {path}")

    def _status(self, message: str):
        self.status_panel.set_status(message)
        self.statusBar().showMessage(message, 5000)

    def closeEvent(self, event):  # noqa: N802 - Qt naming
        """Cancel any in-flight workers before the window goes away
        (reference ``app.py:2164-2166``) so background previews don't
        outlive the session."""
        self._stop_workers()
        event.accept()

    def run(self) -> InteractiveSessionResult:
        return self.result


def launch_interactive_session(
    input_path: Path | None = None,
    base_kwargs: dict | None = None,
    snapshot_seconds: float = 2.0,
) -> InteractiveSessionResult:
    """Run the GUI event loop and return the configured session (reference
    ``app.py:2435-2486``)."""
    import os

    if HEADLESS and os.environ.get("IQ2A_QT", "").lower() != "headless":
        raise RuntimeError(
            "Interactive mode needs PySide6 (pip install 'iq-to-audio-tpu[gui]') "
            "— or set IQ2A_QT=headless to drive the UI programmatically."
        )
    app = QApplication.instance() or QApplication([])
    theme = os.environ.get("IQ2A_THEME", "dark").lower()
    app.setStyleSheet(STYLESHEETS.get(theme, DARK_STYLESHEET))
    window = InteractiveWindow(
        base_kwargs=base_kwargs, input_path=input_path, snapshot_seconds=snapshot_seconds
    )
    relay = _SigintRelay(app)
    relay.triggered.connect(window.close)
    window.show()
    try:
        app.exec()
    finally:
        relay.restore()
    return window.run()


def interactive_select(*args, **kwargs):
    """Backwards-compatible shim (reference ``app.py:2488-2523``): returns
    (configs, progress_sink)."""
    session = launch_interactive_session(*args, **kwargs)
    return session.configs, session.progress_sink
