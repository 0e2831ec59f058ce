"""Control panels for the capture page (reference ``interactive/panels.py``)."""

from __future__ import annotations

from pathlib import Path

from ._qt import (
    QCheckBox,
    QComboBox,
    QDoubleSpinBox,
    QFileDialog,
    QGridLayout,
    QHBoxLayout,
    QLabel,
    QLineEdit,
    QProgressBar,
    QPushButton,
    QSpinBox,
    QWidget,
    Qt,
    Signal,
)

from .state import SPECTRUM_THEMES, WATERFALL_COLORMAPS, InteractiveState, MAX_TARGETS
from .widgets import PanelGroup

_FORMAT_CHOICES = [
    ("Auto-detect", None),
    ("WAV 8-bit", "wav-u8"),
    ("WAV 16-bit", "wav-s16"),
    ("WAV float32", "wav-f32"),
    ("RAW cu8", "raw-cu8"),
    ("RAW cs16", "raw-cs16"),
    ("RAW cf32", "raw-cf32"),
]


def repolish(widget) -> None:
    """Re-apply the stylesheet after a dynamic property change.  Qt caches
    the resolved QSS per widget; without unpolish/polish a toggled
    ``[dim]``/``[error]`` selector never changes the rendered color."""
    style = getattr(widget, "style", None)
    if not callable(style):
        return
    s = style()
    if s is not None and hasattr(s, "unpolish"):
        s.unpolish(widget)
        s.polish(widget)


class RecordingPanel(PanelGroup):
    """File / format / center-frequency / snapshot / output controls."""

    file_selected = Signal(Path)
    settings_changed = Signal()

    def __init__(self, state: InteractiveState, parent=None):
        super().__init__("Recording", parent)
        self.state = state

        row = QHBoxLayout()
        self.path_label = QLabel("No file selected")
        self.path_label.setProperty("dim", True)
        browse = QPushButton("Open…")
        browse.clicked.connect(self._browse)
        row.addWidget(self.path_label, 1)
        row.addWidget(browse)
        self.add_layout(row)

        # persisted recent captures: one click reopens yesterday's file
        from .recent import RecentFiles

        self._recent = RecentFiles()
        recent_row = QHBoxLayout()
        recent_row.addWidget(QLabel("Recent"))
        self.recent_combo = QComboBox()
        self.recent_combo.currentIndexChanged.connect(self._recent_chosen)
        recent_row.addWidget(self.recent_combo, 1)
        self.add_layout(recent_row)
        self._reload_recent()

        grid = QGridLayout()
        grid.addWidget(QLabel("Format"), 0, 0)
        self.format_combo = QComboBox()
        for label, _ in _FORMAT_CHOICES:
            self.format_combo.addItem(label)
        self.format_combo.currentIndexChanged.connect(self._format_changed)
        grid.addWidget(self.format_combo, 0, 1)

        # detection/override status under the combo (reference keeps a
        # colored format_status_label in its Recording panel,
        # reference app.py:953-963)
        self.format_status = QLabel("Select a recording to detect the input format.")
        self.format_status.setProperty("dim", True)
        grid.addWidget(self.format_status, 1, 1)

        grid.addWidget(QLabel("Center (Hz)"), 2, 0)
        self.center_edit = QLineEdit()
        self.center_edit.setPlaceholderText("auto-detected")
        self.center_edit.editingFinished.connect(self._center_changed)
        grid.addWidget(self.center_edit, 2, 1)
        self.center_source = QLabel("")
        self.center_source.setProperty("dim", True)
        grid.addWidget(self.center_source, 3, 1)

        grid.addWidget(QLabel("Snapshot (s)"), 4, 0)
        self.snapshot_spin = QDoubleSpinBox()
        self.snapshot_spin.setRange(0.1, 60.0)
        self.snapshot_spin.setValue(state.snapshot_seconds)
        self.snapshot_spin.valueChanged.connect(self._snapshot_changed)
        grid.addWidget(self.snapshot_spin, 4, 1)

        grid.addWidget(QLabel("Output dir"), 5, 0)
        out_row = QHBoxLayout()
        self.output_label = QLabel("(alongside input)")
        self.output_label.setProperty("dim", True)
        out_btn = QPushButton("…")
        out_btn.setFixedWidth(28)
        out_btn.clicked.connect(self._pick_output)
        out_row.addWidget(self.output_label, 1)
        out_row.addWidget(out_btn)
        grid.addLayout(out_row, 5, 1)
        self.add_layout(grid)

    def show_format_status(self, text: str, *, error: bool = False) -> None:
        """Detection/override summary under the format combo; error rows
        pick up the stylesheet's ``QLabel[error="true"]`` color."""
        self.format_status.setText(text)
        self.format_status.setProperty("dim", not error)
        self.format_status.setProperty("error", error)
        repolish(self.format_status)

    def _browse(self):
        path, _ = QFileDialog.getOpenFileName(
            self,
            "Open IQ recording",
            "",
            "IQ recordings (*.wav *.wave *.rf64 *.cu8 *.cs16 *.cf32 *.iq *.raw);;All files (*)",
        )
        if path:
            self.set_path(Path(path))
            self.file_selected.emit(Path(path))

    def set_path(self, path: Path):
        self.state.input_path = path
        self.path_label.setText(path.name)
        self.path_label.setToolTip(str(path))
        self._recent.add(path)
        self._reload_recent()

    def _reload_recent(self):
        entries = self._recent.load()
        self.recent_combo.blockSignals(True)
        self.recent_combo.clear()
        self.recent_combo.addItem(
            "(recent captures)" if entries else "(none yet)", None
        )
        for p in entries:
            self.recent_combo.addItem(p.name, p)
        self.recent_combo.setCurrentIndex(0)
        self.recent_combo.blockSignals(False)
        self.recent_combo.setEnabled(bool(entries))

    def _recent_chosen(self, index: int):
        path = self.recent_combo.itemData(index)
        if path is None:
            return
        self.recent_combo.blockSignals(True)
        self.recent_combo.setCurrentIndex(0)
        self.recent_combo.blockSignals(False)
        if Path(path) != self.state.input_path:
            self.set_path(Path(path))
            self.file_selected.emit(Path(path))

    def show_center(self, freq: float | None, source: str):
        if freq:
            self.center_edit.setText(f"{freq:.0f}")
        self.center_source.setText(f"source: {source}")

    def _center_changed(self):
        text = self.center_edit.text().strip()
        try:
            self.state.center_freq = float(text) if text else None
            self.state.center_freq_source = "gui"
        except ValueError:
            return
        self.settings_changed.emit()

    def _format_changed(self, index: int):
        self.state.input_format_override = _FORMAT_CHOICES[index][1]
        self.settings_changed.emit()

    def _snapshot_changed(self, value: float):
        self.state.snapshot_seconds = float(value)

    def _pick_output(self):
        path = QFileDialog.getExistingDirectory(self, "Output directory")
        if path:
            self.state.output_dir = Path(path)
            self.output_label.setText(path)


class DemodPanel(PanelGroup):
    """Demodulator selection + AGC toggle (reference ``panels.py`` Demod)."""

    changed = Signal()

    _MODES = [
        ("nfm", "Narrowband FM", "Quadrature discriminator with de-emphasis."),
        ("am", "AM envelope", "Envelope detector with DC blocking."),
        ("usb", "USB (SSB)", "Upper sideband with optional feedback AGC."),
        ("lsb", "LSB (SSB)", "Lower sideband with optional feedback AGC."),
        ("none", "IQ pass-through", "Write the tuned/decimated IQ slice as-is."),
    ]

    def __init__(self, state: InteractiveState, parent=None):
        super().__init__("Demodulator", parent)
        self.state = state
        self.combo = QComboBox()
        for key, label, _ in self._MODES:
            self.combo.addItem(label, key)
        # reflect the CLI's --demod before wiring the change handler — the
        # panel must show what will actually run, not always the first mode
        keys = [key for key, _, _ in self._MODES]
        mode = {"ssb": "usb", "fm": "nfm"}.get(state.demod_mode, state.demod_mode)
        initial = keys.index(mode) if mode in keys else 0
        self.combo.setCurrentIndex(initial)
        self.combo.currentIndexChanged.connect(self._mode_changed)
        self.add(self.combo)
        self.description = QLabel(self._MODES[initial][2])
        self.description.setWordWrap(True)
        self.description.setProperty("dim", True)
        self.add(self.description)
        self.agc_check = QCheckBox("Automatic gain control")
        self.agc_check.setChecked(state.agc_enabled)
        self.agc_check.toggled.connect(self._agc_toggled)
        self.add(self.agc_check)
        self._sync_agc()

    def _mode_changed(self, index: int):
        key = self._MODES[index][0]
        self.state.set_demod(key)
        self.description.setText(self._MODES[index][2])
        self._sync_agc()
        self.changed.emit()

    def _agc_toggled(self, checked: bool):
        self.state.agc_enabled = checked
        self.changed.emit()

    def _sync_agc(self):
        applicable = self.state.agc_applicable
        self.agc_check.setEnabled(applicable)
        if applicable:
            self.agc_check.setChecked(self.state.agc_enabled)


class ChannelPanel(PanelGroup):
    """Sample rate display/override + bandwidth (reference Channel panel)."""

    changed = Signal()

    def __init__(self, state: InteractiveState, parent=None):
        super().__init__("Channel", parent)
        self.state = state
        grid = QGridLayout()
        grid.addWidget(QLabel("Sample rate"), 0, 0)
        self.rate_label = QLabel("unknown")
        grid.addWidget(self.rate_label, 0, 1)
        grid.addWidget(QLabel("Override (Hz)"), 1, 0)
        self.rate_edit = QLineEdit()
        self.rate_edit.setPlaceholderText("use detected")
        self.rate_edit.editingFinished.connect(self._rate_changed)
        grid.addWidget(self.rate_edit, 1, 1)
        grid.addWidget(QLabel("Bandwidth (Hz)"), 2, 0)
        self.bw_spin = QDoubleSpinBox()
        self.bw_spin.setRange(100.0, 5_000_000.0)
        self.bw_spin.setDecimals(0)
        self.bw_spin.setValue(state.bandwidth)
        self.bw_spin.valueChanged.connect(self._bw_changed)
        grid.addWidget(self.bw_spin, 2, 1)
        # burst mode: split the confirmed run into N concurrent segments
        # (device stream + host-CPU workers — pipeline/hetero.py); 0 = off
        grid.addWidget(QLabel("Burst segments"), 3, 0)
        self.burst_spin = QSpinBox()
        self.burst_spin.setRange(0, 64)
        self.burst_spin.setSpecialValueText("off")
        self.burst_spin.setValue(state.burst_segments)
        self.burst_spin.setToolTip(
            "Split the confirmed run into this many frame-aligned segments "
            "processed concurrently by the device stream and host-CPU "
            "workers (burst mode); 0 = serial streaming."
        )
        self.burst_spin.valueChanged.connect(self._burst_changed)
        grid.addWidget(self.burst_spin, 3, 1)
        self.add_layout(grid)

    def show_rate(self, rate: float | None):
        self.rate_label.setText(f"{rate:,.0f} Hz" if rate else "unknown")

    def set_bandwidth(self, bw: float):
        self.bw_spin.setValue(bw)

    def _rate_changed(self):
        text = self.rate_edit.text().strip()
        try:
            self.state.sample_rate_override = float(text) if text else None
        except ValueError:
            return
        self.changed.emit()

    def _bw_changed(self, value: float):
        self.state.bandwidth = float(value)
        self.changed.emit()

    def _burst_changed(self, value: int):
        self.state.burst_segments = int(value)
        self.changed.emit()


class TargetsPanel(PanelGroup):
    """Up to five target frequency slots (reference Targets panel)."""

    changed = Signal()

    def __init__(self, state: InteractiveState, parent=None):
        super().__init__("Targets (click spectrum to add)", parent)
        self.state = state
        self._rows: list[tuple[QLabel, QPushButton]] = []
        grid = QGridLayout()
        for i in range(MAX_TARGETS):
            label = QLabel("—")
            label.setProperty("dim", True)
            remove = QPushButton("✕")
            remove.setFixedWidth(26)
            remove.clicked.connect(lambda _=False, idx=i: self._remove(idx))
            grid.addWidget(QLabel(f"{i + 1}."), i, 0)
            grid.addWidget(label, i, 1)
            grid.addWidget(remove, i, 2)
            self._rows.append((label, remove))
        self.add_layout(grid)
        clear = QPushButton("Clear all")
        clear.clicked.connect(self._clear)
        self.add(clear)
        self.refresh()

    def _remove(self, index: int):
        self.state.remove_target(index)
        self.refresh()
        self.changed.emit()

    def _clear(self):
        self.state.clear_targets()
        self.refresh()
        self.changed.emit()

    def refresh(self):
        for i, (label, remove) in enumerate(self._rows):
            if i < len(self.state.targets):
                label.setText(f"{self.state.targets[i] / 1e6:.6f} MHz")
                label.setProperty("dim", False)
                remove.setEnabled(True)
            else:
                label.setText("—")
                label.setProperty("dim", True)
                remove.setEnabled(False)
            repolish(label)


class StatusPanel(PanelGroup):
    """Status label + progress bar + action buttons (reference Status panel)."""

    preview_requested = Signal()
    run_requested = Signal()
    stop_requested = Signal()

    def __init__(self, parent=None):
        super().__init__("Status", parent)
        self._busy = False
        self._ready = False
        self.status_label = QLabel("Select a recording to begin.")
        self.status_label.setWordWrap(True)
        self.add(self.status_label)
        self.progress = QProgressBar()
        self.progress.setRange(0, 1000)
        self.add(self.progress)
        row = QHBoxLayout()
        self.preview_btn = QPushButton("Preview DSP")
        self.run_btn = QPushButton("Confirm && Run")
        self.stop_btn = QPushButton("Stop")
        self._refresh_buttons()
        self.preview_btn.clicked.connect(self.preview_requested.emit)
        self.run_btn.clicked.connect(self.run_requested.emit)
        self.stop_btn.clicked.connect(self.stop_requested.emit)
        row.addWidget(self.preview_btn)
        row.addWidget(self.run_btn)
        row.addWidget(self.stop_btn)
        self.add_layout(row)

    def set_status(self, text: str):
        self.status_label.setText(text)

    def set_progress(self, fraction: float):
        self.progress.setValue(int(max(0.0, min(fraction, 1.0)) * 1000))

    def set_busy(self, busy: bool):
        self._busy = busy
        self._refresh_buttons()

    def set_ready(self, ready: bool):
        """Gate Preview/Run on an actionable session (recording + >=1 target),
        the reference's ``_update_status_controls`` contract."""
        self._ready = ready
        self._refresh_buttons()

    def _refresh_buttons(self):
        idle_ok = self._ready and not self._busy
        self.preview_btn.setEnabled(idle_ok)
        self.run_btn.setEnabled(idle_ok)
        self.stop_btn.setEnabled(self._busy)


class SpectrumOptionsPanel(PanelGroup):
    """FFT size / smoothing / dynamic range / theme (reference panel)."""

    changed = Signal()

    _NFFTS = [65_536, 131_072, 262_144, 524_288]

    def __init__(self, state: InteractiveState, parent=None):
        super().__init__("Spectrum display", parent)
        self.state = state
        grid = QGridLayout()
        grid.addWidget(QLabel("FFT size"), 0, 0)
        self.nfft_combo = QComboBox()
        for n in self._NFFTS:
            self.nfft_combo.addItem(f"{n:,}", n)
        self.nfft_combo.setCurrentIndex(self._NFFTS.index(state.spectrum_nfft))
        self.nfft_combo.currentIndexChanged.connect(self._apply)
        grid.addWidget(self.nfft_combo, 0, 1)
        grid.addWidget(QLabel("Smoothing"), 1, 0)
        self.smooth_spin = QSpinBox()
        self.smooth_spin.setRange(1, 25)
        self.smooth_spin.setValue(state.spectrum_smoothing)
        self.smooth_spin.valueChanged.connect(self._apply)
        grid.addWidget(self.smooth_spin, 1, 1)
        grid.addWidget(QLabel("Range (dB)"), 2, 0)
        self.range_spin = QDoubleSpinBox()
        self.range_spin.setRange(20.0, 160.0)
        self.range_spin.setValue(state.spectrum_dynamic_range)
        self.range_spin.valueChanged.connect(self._apply)
        grid.addWidget(self.range_spin, 2, 1)
        grid.addWidget(QLabel("Theme"), 3, 0)
        self.theme_combo = QComboBox()
        for name in SPECTRUM_THEMES:
            self.theme_combo.addItem(name)
        self.theme_combo.setCurrentText(state.spectrum_theme)
        self.theme_combo.currentIndexChanged.connect(self._apply)
        grid.addWidget(self.theme_combo, 3, 1)
        self.add_layout(grid)
        self.export_btn = QPushButton("Export spectrum PNG…")
        self.add(self.export_btn)
        self.full_psd_btn = QPushButton("Analyze entire recording")
        self.full_psd_btn.setToolTip(
            "Average the full capture into the spectrum (maximum frequency resolution)."
        )
        self.add(self.full_psd_btn)

    def _apply(self, *_):
        self.state.spectrum_nfft = self.nfft_combo.currentData()
        self.state.spectrum_smoothing = self.smooth_spin.value()
        self.state.spectrum_dynamic_range = self.range_spin.value()
        self.state.spectrum_theme = self.theme_combo.currentText()
        self.changed.emit()


class WaterfallOptionsPanel(PanelGroup):
    """Waterfall slices / floor / colormap (reference panel)."""

    changed = Signal()

    def __init__(self, state: InteractiveState, parent=None):
        super().__init__("Waterfall", parent)
        self.state = state
        grid = QGridLayout()
        grid.addWidget(QLabel("Max slices"), 0, 0)
        self.slices_spin = QSpinBox()
        self.slices_spin.setRange(50, 1000)
        self.slices_spin.setValue(state.waterfall_slices)
        self.slices_spin.valueChanged.connect(self._apply)
        grid.addWidget(self.slices_spin, 0, 1)
        grid.addWidget(QLabel("Floor (dB)"), 1, 0)
        self.floor_spin = QDoubleSpinBox()
        self.floor_spin.setRange(-160.0, -40.0)
        self.floor_spin.setValue(state.waterfall_floor_db)
        self.floor_spin.valueChanged.connect(self._apply)
        grid.addWidget(self.floor_spin, 1, 1)
        grid.addWidget(QLabel("Colormap"), 2, 0)
        self.cmap_combo = QComboBox()
        for name in WATERFALL_COLORMAPS:
            self.cmap_combo.addItem(name)
        self.cmap_combo.setCurrentText(state.waterfall_colormap)
        self.cmap_combo.currentIndexChanged.connect(self._apply)
        grid.addWidget(self.cmap_combo, 2, 1)
        self.add_layout(grid)
        self.show_btn = QPushButton("Show waterfall window")
        self.add(self.show_btn)

    def _apply(self, *_):
        self.state.waterfall_slices = self.slices_spin.value()
        self.state.waterfall_floor_db = self.floor_spin.value()
        self.state.waterfall_colormap = self.cmap_combo.currentText()
        self.changed.emit()
