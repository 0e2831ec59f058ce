"""Audio-post and digital-post pages (reference ``interactive/post.py``)."""

from __future__ import annotations

import logging
import shlex
from pathlib import Path

from ._qt import (
    QCheckBox,
    QComboBox,
    QDoubleSpinBox,
    QFileDialog,
    QFormLayout,
    QGridLayout,
    QHBoxLayout,
    QLabel,
    QLineEdit,
    QProgressBar,
    QPushButton,
    QSpinBox,
    QStackedWidget,
    QTableWidget,
    QTableWidgetItem,
    QThreadPool,
    QVBoxLayout,
    QWidget,
    Qt,
    Signal,
)

from ..post.squelch import AudioPostOptions, SquelchConfig, gather_audio_targets
from .widgets import PanelGroup

LOG = logging.getLogger(__name__)


class AudioPostPage(QWidget):
    """Squelch batch processing page (reference ``post.py:16-613``)."""

    status = Signal(str)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._pool = QThreadPool.globalInstance()
        layout = QVBoxLayout(self)

        source = PanelGroup("Source")
        row = QHBoxLayout()
        self.path_label = QLabel("No file or folder selected")
        self.path_label.setProperty("dim", True)
        pick_file = QPushButton("File…")
        pick_dir = QPushButton("Folder…")
        pick_file.clicked.connect(self._pick_file)
        pick_dir.clicked.connect(self._pick_dir)
        row.addWidget(self.path_label, 1)
        row.addWidget(pick_file)
        row.addWidget(pick_dir)
        source.add_layout(row)
        # latest-capture hand-off (reference post.py:322-328): the main
        # window pushes the most recent capture/output dir here so one
        # click points the batch at what was just demodulated
        recent_row = QHBoxLayout()
        self.recent_hint = QLabel("No capture processed this session yet.")
        self.recent_hint.setProperty("dim", True)
        self.use_recent_btn = QPushButton("Use latest output")
        self.use_recent_btn.setEnabled(False)
        self.use_recent_btn.clicked.connect(self._use_recent)
        recent_row.addWidget(self.recent_hint, 1)
        recent_row.addWidget(self.use_recent_btn)
        source.add_layout(recent_row)
        layout.addWidget(source)
        self._recent_output_dir: Path | None = None

        opts = PanelGroup("Squelch")
        grid = QGridLayout()
        grid.addWidget(QLabel("Method"), 0, 0)
        self.method_combo = QComboBox()
        for m in ("adaptive", "static", "transient"):
            self.method_combo.addItem(m)
        grid.addWidget(self.method_combo, 0, 1)
        grid.addWidget(QLabel("Noise floor (dB)"), 1, 0)
        self.floor_spin = QDoubleSpinBox()
        self.floor_spin.setRange(-140.0, 0.0)
        self.floor_spin.setValue(-60.0)
        self.floor_spin.setEnabled(False)
        grid.addWidget(self.floor_spin, 1, 1)
        self.auto_floor = QCheckBox("Auto noise floor")
        self.auto_floor.setChecked(True)
        self.auto_floor.toggled.connect(lambda on: self.floor_spin.setEnabled(not on))
        grid.addWidget(self.auto_floor, 1, 2)
        grid.addWidget(QLabel("Margin (dB)"), 2, 0)
        self.margin_spin = QDoubleSpinBox()
        self.margin_spin.setRange(0.0, 40.0)
        self.margin_spin.setValue(6.0)
        grid.addWidget(self.margin_spin, 2, 1)
        self.trim_check = QCheckBox("Trim lead/trail silence")
        self.trim_check.setChecked(True)
        grid.addWidget(self.trim_check, 3, 0, 1, 2)
        self.overwrite_check = QCheckBox("Overwrite originals")
        grid.addWidget(self.overwrite_check, 4, 0, 1, 2)
        opts.add_layout(grid)
        run_btn = QPushButton("Process")
        run_btn.clicked.connect(self._run)
        opts.add(run_btn)
        layout.addWidget(opts)

        self.progress = QProgressBar()
        self.progress.setRange(0, 1000)
        layout.addWidget(self.progress)

        self.table = QTableWidget(0, 5)
        self.table.setHorizontalHeaderLabels(
            ["File", "Kept %", "Floor dB", "Threshold dB", "Output"]
        )
        self.table.horizontalHeader().setStretchLastSection(True)
        layout.addWidget(self.table, 1)

        self._path: Path | None = None

    def _pick_file(self):
        path, _ = QFileDialog.getOpenFileName(self, "Audio file", "", "Audio (*.wav)")
        if path:
            self._set_path(Path(path))

    def _pick_dir(self):
        path = QFileDialog.getExistingDirectory(self, "Audio folder")
        if path:
            self._set_path(Path(path))

    def _set_path(self, path: Path):
        self._path = path
        self.path_label.setText(str(path))

    def update_recent_capture(
        self, *, selected_path: Path | None, output_dir: Path | None
    ) -> None:
        """Remember the session's most recent capture outputs (called by the
        main window after loads and session completions)."""
        if output_dir is None and selected_path is not None:
            output_dir = Path(selected_path).parent
        self._recent_output_dir = output_dir
        if output_dir is not None:
            self.recent_hint.setText(f"Latest capture outputs: {output_dir}")
            self.use_recent_btn.setEnabled(True)

    def _use_recent(self):
        if self._recent_output_dir is not None:
            self._set_path(self._recent_output_dir)

    def _options(self) -> AudioPostOptions:
        config = SquelchConfig(
            method=self.method_combo.currentText(),
            auto_noise_floor=self.auto_floor.isChecked(),
            manual_noise_floor_db=(
                None if self.auto_floor.isChecked() else self.floor_spin.value()
            ),
            threshold_margin_db=self.margin_spin.value(),
            trim_silence=self.trim_check.isChecked(),
        )
        return AudioPostOptions(config=config, overwrite=self.overwrite_check.isChecked())

    def _run(self):
        if self._path is None:
            self.status.emit("Select an audio file or folder first.")
            return
        options = self._options()
        try:
            targets = gather_audio_targets(self._path, options)
        except OSError as exc:
            self.status.emit(str(exc))
            return
        if not targets:
            self.status.emit("No .wav files found.")
            return
        from .workers import AudioPostWorker

        worker = AudioPostWorker(targets, options)
        # bound-method slots only: the worker emits from a pool thread, and
        # a lambda connection would execute there (mutating widgets off the
        # GUI thread); a QObject-bound method is queued to the GUI thread
        worker.signals.progress.connect(self._on_batch_progress)
        worker.signals.finished.connect(self._show_summary)
        worker.signals.failed.connect(self.status.emit)
        self.table.setRowCount(0)
        self.status.emit(f"Processing {len(targets)} file(s)…")
        self._pool.start(worker)

    def _on_batch_progress(self, done, total, _path):
        self.progress.setValue(int(done / max(total, 1) * 1000))

    def _show_summary(self, summary):
        self.table.setRowCount(len(summary.results))
        for row, res in enumerate(summary.results):
            items = [
                res.input_path.name,
                f"{res.retained_ratio * 100:.1f}",
                f"{res.noise_floor_db:.1f}",
                f"{res.threshold_db:.1f}",
                str(res.output_path),
            ]
            for col, text in enumerate(items):
                item = QTableWidgetItem(text)
                item.setFlags(item.flags() & ~Qt.ItemIsEditable)
                self.table.setItem(row, col, item)
        self.status.emit(
            f"Audio post complete: {summary.processed} processed, {summary.failed} failed."
        )


#: per-tool option -> container-command composition (the reference's option
#: stacks, ``post.py:950-1021``, are display-only placeholders; here they
#: drive the actual launch command).  Flags are the upstream tools' own:
#: dsd-fme ``-f?``/``-T``/``-w``, multimon-ng ``-a``/``-v``/``--timestamp``,
#: WSJT-X jt9 ``-8``/``-5``/``-d``.
DSD_PROTOCOLS = {
    "Auto detect": ("-fa",),
    "P25 Phase 1": ("-f1",),
    "DMR": ("-fs",),
    "NXDN48": ("-fi",),
    "YSF": ("-fy",),
}

MULTIMON_MODES = ("POCSAG512", "POCSAG1200", "POCSAG2400", "FLEX", "AFSK1200", "DTMF")

FT_MODES = {"FT8": ("-8",), "FT4": ("-5",)}


def build_decoder_args(key: str, opts: dict) -> tuple[str, ...]:
    """Compose per-tool command arguments from the option-stack values.

    Pure and UI-free so the composition is unit-testable; unknown keys
    compose to no extra arguments (preset default command applies).
    """
    if key == "dsd-fme":
        args = list(DSD_PROTOCOLS.get(opts.get("protocol", "Auto detect"), ("-fa",)))
        if opts.get("trunk_follow"):
            args.append("-T")
        if opts.get("record_wav"):
            args += ["-w", "/workspace/audio/decoded.wav"]
        return ("dsd-fme", *args)
    if key == "multimon-ng":
        args = ["-a", opts.get("mode", "POCSAG1200"), "-t", "wav"]
        level = int(opts.get("verbosity", 0))
        if level:
            args += ["-v", str(level)]
        if opts.get("timestamp"):
            args.append("--timestamp")
        return ("multimon-ng", *args)
    if key == "ft8":
        args = list(FT_MODES.get(opts.get("mode", "FT8"), ("-8",)))
        depth = int(opts.get("depth", 2))
        args += ["-d", str(depth)]
        return ("jt9", *args)
    return ()


class DigitalPostPage(QWidget):
    """Digital decoder hand-off page (reference ``post.py:743-1021``)."""

    status = Signal(str)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._pool = QThreadPool.globalInstance()
        self._console = None
        self._worker = None
        layout = QVBoxLayout(self)

        decoder_panel = PanelGroup("Decoder")
        grid = QGridLayout()
        grid.addWidget(QLabel("Preset"), 0, 0)
        self.decoder_combo = QComboBox()
        from ..post.digital import DIGITAL_DECODERS

        for dec in DIGITAL_DECODERS:
            self.decoder_combo.addItem(dec.label, dec.key)
        self.decoder_combo.currentIndexChanged.connect(self._describe)
        grid.addWidget(self.decoder_combo, 0, 1)
        self.description = QLabel(DIGITAL_DECODERS[0].description)
        self.description.setWordWrap(True)
        self.description.setProperty("dim", True)
        grid.addWidget(self.description, 1, 0, 1, 2)
        decoder_panel.add_layout(grid)

        # per-tool option stacks, switched with the preset combo
        self.option_stack = QStackedWidget()
        self.option_stack.addWidget(self._build_dsd_fme_options())
        self.option_stack.addWidget(self._build_multimon_options())
        self.option_stack.addWidget(self._build_ft_options())
        self.decoder_combo.currentIndexChanged.connect(
            self.option_stack.setCurrentIndex
        )
        decoder_panel.add(self.option_stack)

        cmd_row = QGridLayout()
        cmd_row.addWidget(QLabel("Command"), 0, 0)
        self.command_edit = QLineEdit()
        self.command_edit.setPlaceholderText(" ".join(self.composed_command()))
        cmd_row.addWidget(self.command_edit, 0, 1)
        decoder_panel.add_layout(cmd_row)
        layout.addWidget(decoder_panel)

        audio_panel = PanelGroup("Audio directory")
        row = QHBoxLayout()
        self.dir_label = QLabel("No directory selected")
        self.dir_label.setProperty("dim", True)
        pick = QPushButton("Folder…")
        pick.clicked.connect(self._pick_dir)
        row.addWidget(self.dir_label, 1)
        row.addWidget(pick)
        audio_panel.add_layout(row)
        self.source_hint = QLabel(
            "Select the directory of channelized audio for external decoders."
        )
        self.source_hint.setProperty("dim", True)
        self.source_hint.setWordWrap(True)
        audio_panel.add(self.source_hint)
        layout.addWidget(audio_panel)
        self._recent_output_dir: Path | None = None

        docker_panel = PanelGroup("Docker backend")
        row2 = QHBoxLayout()
        self.docker_status = QLabel("Docker status unknown")
        self.docker_status.setProperty("dim", True)
        probe_btn = QPushButton("Check")
        probe_btn.clicked.connect(self._probe)
        update_btn = QPushButton("Update image")
        update_btn.clicked.connect(self._update_image)
        row2.addWidget(self.docker_status, 1)
        row2.addWidget(probe_btn)
        row2.addWidget(update_btn)
        docker_panel.add_layout(row2)
        launch_btn = QPushButton("Launch decoder")
        launch_btn.clicked.connect(self._launch)
        docker_panel.add(launch_btn)
        layout.addWidget(docker_panel)
        layout.addStretch(1)

        self._dir: Path | None = None

    # -- per-tool option stacks (reference ``post.py:950-1021``) -------------

    def _build_dsd_fme_options(self) -> QWidget:
        widget = QWidget()
        form = QFormLayout(widget)
        self.dsd_protocol_combo = QComboBox()
        for name in DSD_PROTOCOLS:
            self.dsd_protocol_combo.addItem(name)
        form.addRow(QLabel("Input protocol"), self.dsd_protocol_combo)
        self.dsd_trunk_check = QCheckBox("Follow trunking control channel")
        form.addRow(QLabel(""), self.dsd_trunk_check)
        self.dsd_record_check = QCheckBox("Capture decoded voice audio")
        form.addRow(QLabel(""), self.dsd_record_check)
        for w in (self.dsd_protocol_combo, self.dsd_trunk_check, self.dsd_record_check):
            self._watch(w)
        return widget

    def _build_multimon_options(self) -> QWidget:
        widget = QWidget()
        form = QFormLayout(widget)
        self.multimon_mode_combo = QComboBox()
        for name in MULTIMON_MODES:
            self.multimon_mode_combo.addItem(name)
        self.multimon_mode_combo.setCurrentText("POCSAG1200")
        form.addRow(QLabel("Decoder mode"), self.multimon_mode_combo)
        self.multimon_verbose_spin = QSpinBox()
        self.multimon_verbose_spin.setRange(0, 10)
        form.addRow(QLabel("Verbosity"), self.multimon_verbose_spin)
        self.multimon_timestamp_check = QCheckBox("Timestamp decoded packets")
        form.addRow(QLabel(""), self.multimon_timestamp_check)
        for w in (
            self.multimon_mode_combo,
            self.multimon_verbose_spin,
            self.multimon_timestamp_check,
        ):
            self._watch(w)
        return widget

    def _build_ft_options(self) -> QWidget:
        widget = QWidget()
        form = QFormLayout(widget)
        self.ft_mode_combo = QComboBox()
        for name in FT_MODES:
            self.ft_mode_combo.addItem(name)
        form.addRow(QLabel("Mode"), self.ft_mode_combo)
        self.ft_depth_spin = QSpinBox()
        self.ft_depth_spin.setRange(1, 3)
        self.ft_depth_spin.setValue(2)
        form.addRow(QLabel("Decode depth"), self.ft_depth_spin)
        for w in (self.ft_mode_combo, self.ft_depth_spin):
            self._watch(w)
        return widget

    def _watch(self, widget) -> None:
        """Refresh the command preview whenever an option changes."""
        for sig in ("currentIndexChanged", "valueChanged", "toggled"):
            signal = getattr(widget, sig, None)
            if signal is not None:
                signal.connect(self._refresh_command_preview)
                return

    def current_options(self) -> dict:
        key = self.decoder_combo.currentData()
        if key == "dsd-fme":
            return {
                "protocol": self.dsd_protocol_combo.currentText(),
                "trunk_follow": self.dsd_trunk_check.isChecked(),
                "record_wav": self.dsd_record_check.isChecked(),
            }
        if key == "multimon-ng":
            return {
                "mode": self.multimon_mode_combo.currentText(),
                "verbosity": self.multimon_verbose_spin.value(),
                "timestamp": self.multimon_timestamp_check.isChecked(),
            }
        if key == "ft8":
            return {
                "mode": self.ft_mode_combo.currentText(),
                "depth": self.ft_depth_spin.value(),
            }
        return {}

    def composed_command(self) -> tuple[str, ...]:
        """The launch command implied by the option stacks (used unless the
        user types an explicit command)."""
        key = self.decoder_combo.currentData()
        composed = build_decoder_args(key, self.current_options())
        if composed:
            return composed
        from ..post.digital import get_decoder

        return get_decoder(key).default_command

    def _refresh_command_preview(self, *_):
        self.command_edit.setPlaceholderText(" ".join(self.composed_command()))

    def _describe(self, index: int):
        from ..post.digital import DIGITAL_DECODERS

        self.description.setText(DIGITAL_DECODERS[index].description)
        self._refresh_command_preview()

    def _pick_dir(self):
        path = QFileDialog.getExistingDirectory(self, "Audio directory")
        if path:
            self._dir = Path(path)
            self.dir_label.setText(path)

    def update_recent_capture(self, *, output_dir: Path | None) -> None:
        """Default the decoder source to the latest capture outputs
        (reference post.py:1023-1036)."""
        self._recent_output_dir = output_dir
        if output_dir is not None:
            self.source_hint.setText(
                f"Defaulting to latest capture outputs: {output_dir}"
            )
            if self._dir is None:
                self._dir = output_dir
                self.dir_label.setText(str(output_dir))

    def _backend(self):
        from ..post.docker_backend import DockerBackend

        return DockerBackend()

    def _set_docker_status(self, _ok, msg):
        """Bound-method slot: queued to the GUI thread (workers emit from
        the pool thread — lambda connections would run there)."""
        self.docker_status.setText(msg)

    def _probe(self):
        from .workers import DockerProbeWorker

        worker = DockerProbeWorker(self._backend)
        worker.signals.result.connect(self._set_docker_status)
        self._pool.start(worker)

    def _update_image(self):
        from .workers import DockerImageUpdateWorker

        self.docker_status.setText("Pulling backend image…")
        # factory form: docker.from_env's blocking engine HTTP happens on
        # the pool thread, never in this click handler
        worker = DockerImageUpdateWorker(self._backend)
        worker.signals.result.connect(self._set_docker_status)
        self._pool.start(worker)

    def _launch(self):
        if self._dir is None:
            self.status.emit("Select an audio directory first.")
            return
        from ..post.digital import get_decoder
        from ..post.docker_backend import DockerLaunchRequest
        from .docker_console import DockerConsole
        from .workers import DockerLaunchWorker

        key = self.decoder_combo.currentData()
        get_decoder(key)  # validate the preset key early
        custom = self.command_edit.text().strip()
        try:
            command = tuple(shlex.split(custom)) if custom else self.composed_command()
        except ValueError as exc:  # unbalanced quotes in the free-form args
            self.status.emit(f"Bad command syntax: {exc}")
            return
        request = DockerLaunchRequest(
            command=command, audio_dir=self._dir, decoder_key=key
        )
        console = DockerConsole(f"Decoder: {key}", self)
        # factory form: backend construction + ensure_connection run on the
        # pool thread (docker.from_env blocks on engine HTTP — an
        # unreachable DOCKER_HOST must not freeze the GUI for its timeout)
        worker = DockerLaunchWorker(self._backend, request)
        worker.signals.log.connect(console.append_log)
        worker.signals.finished.connect(console.mark_finished)
        worker.signals.failed.connect(console.append_error)
        console.cancel_requested.connect(worker.cancel)
        self._console = console
        self._worker = worker
        console.show()
        self._pool.start(worker)
