"""Log-tailing dialog for backend container runs (reference
``interactive/docker_console.py``)."""

from __future__ import annotations

from ._qt import (
    QDialog,
    QHBoxLayout,
    QPlainTextEdit,
    QPushButton,
    QVBoxLayout,
    Signal,
)


class DockerConsole(QDialog):
    """Streams container logs with a Stop Container button."""

    cancel_requested = Signal()

    def __init__(self, title: str, parent=None):
        super().__init__(parent)
        self.setWindowTitle(title)
        self.resize(720, 420)
        layout = QVBoxLayout(self)
        self.log_view = QPlainTextEdit()
        self.log_view.setReadOnly(True)
        self.log_view.setMaximumBlockCount(5000)
        layout.addWidget(self.log_view)
        row = QHBoxLayout()
        row.addStretch(1)
        self.stop_btn = QPushButton("Stop Container")
        self.stop_btn.clicked.connect(self._stop)
        self.close_btn = QPushButton("Close")
        self.close_btn.clicked.connect(self.accept)
        row.addWidget(self.stop_btn)
        row.addWidget(self.close_btn)
        layout.addLayout(row)

    def append_log(self, text: str):
        self.log_view.appendPlainText(text.rstrip("\n"))

    def append_error(self, message: str):
        """Bound-method slot for worker failure signals (queued to the GUI
        thread; a lambda connection would run on the worker's thread)."""
        self.append_log(f"ERROR: {message}")
        self.stop_btn.setEnabled(False)

    def mark_finished(self, exit_code: int):
        self.append_log(f"--- container exited with status {exit_code} ---")
        self.stop_btn.setEnabled(False)

    def _stop(self):
        self.stop_btn.setEnabled(False)
        self.cancel_requested.emit()
