"""Reusable interactive widgets (reference ``interactive/widgets.py``)."""

from __future__ import annotations

import numpy as np
from matplotlib.widgets import SpanSelector

from ._qt import (
    FigureCanvas,
    Figure,
    QGroupBox,
    QMainWindow,
    QSplitter,
    QVBoxLayout,
    QWidget,
    Qt,
    Signal,
)


class PanelGroup(QGroupBox):
    """Titled framed panel (reference ``widgets.py:198-216``)."""

    def __init__(self, title: str, parent=None):
        super().__init__(title, parent)
        self._layout = QVBoxLayout(self)
        self._layout.setContentsMargins(8, 10, 8, 8)
        self._layout.setSpacing(6)

    def add(self, widget: QWidget):
        self._layout.addWidget(widget)
        return widget

    def add_layout(self, layout):
        self._layout.addLayout(layout)
        return layout


class LockedSplitter(QSplitter):
    """Splitter that keeps the first pane at a fixed width
    (reference ``widgets.py:219-235``)."""

    def __init__(self, orientation, fixed_first: int):
        super().__init__(orientation)
        self._fixed_first = fixed_first
        self.setChildrenCollapsible(False)

    def resizeEvent(self, event):  # noqa: N802 - Qt naming
        super().resizeEvent(event)
        sizes = self.sizes()
        if len(sizes) >= 2:
            total = sum(sizes)
            self.setSizes([self._fixed_first, max(total - self._fixed_first, 100)])


class SpanController:
    """Wraps a matplotlib SpanSelector with center/edge guide lines driving
    the selected bandwidth (reference ``widgets.py:136-195``)."""

    def __init__(self, ax, on_select):
        self.ax = ax
        self._on_select = on_select
        self._center_line = None
        self._edge_lines: list = []
        self.selector = SpanSelector(
            ax,
            self._handle,
            "horizontal",
            useblit=True,
            props={"alpha": 0.25, "facecolor": "#4f9dff"},
            interactive=True,
            drag_from_anywhere=True,
        )

    def _handle(self, xmin: float, xmax: float):
        if xmax - xmin <= 0:
            return
        center = 0.5 * (xmin + xmax)
        self._on_select(center, xmax - xmin)

    def disconnect(self) -> None:
        """Detach from the canvas.  SpanSelector registers mpl *canvas*
        callbacks that survive ``ax.clear()`` — a replaced controller must
        drop them or every re-render stacks another live selector."""
        self._on_select = lambda center, bandwidth: None
        try:
            self.selector.set_active(False)
            self.selector.disconnect_events()
        except Exception:  # headless canvases may lack the event machinery
            pass

    def show_selection(self, center_hz: float, bandwidth_hz: float):
        for ln in self._edge_lines:
            ln.remove()
        self._edge_lines.clear()
        if self._center_line is not None:
            self._center_line.remove()
            self._center_line = None
        half = bandwidth_hz / 2.0
        self._center_line = self.ax.axvline(center_hz, color="#e0b04c", lw=1.0)
        for x in (center_hz - half, center_hz + half):
            self._edge_lines.append(
                self.ax.axvline(x, color="#e0b04c", lw=0.7, ls="--", alpha=0.7)
            )
        self.ax.figure.canvas.draw_idle()

    def clear(self):
        for ln in self._edge_lines:
            ln.remove()
        self._edge_lines.clear()
        if self._center_line is not None:
            self._center_line.remove()
            self._center_line = None


class WaterfallWindow(QMainWindow):
    """Secondary waterfall window; clicking retunes the main selection
    (reference ``widgets.py:32-133``)."""

    frequency_clicked = Signal(float)

    def __init__(self, parent=None):
        super().__init__(parent)
        self.setWindowTitle("Waterfall")
        self.resize(820, 480)
        central = QWidget()
        layout = QVBoxLayout(central)
        self.figure = Figure(figsize=(8, 4.5), layout="constrained")
        self.canvas = FigureCanvas(self.figure)
        layout.addWidget(self.canvas)
        self.setCentralWidget(central)
        self.ax = self.figure.add_subplot(111)
        self._image = None
        self.canvas.mpl_connect("button_press_event", self._on_click)

    def _on_click(self, event):
        if event.inaxes is self.ax and event.xdata is not None:
            self.frequency_clicked.emit(float(event.xdata))

    def show_waterfall(
        self,
        freqs: np.ndarray,
        times: np.ndarray,
        matrix: np.ndarray,
        *,
        center_freq: float = 0.0,
        floor_db: float = -110.0,
        colormap: str = "viridis",
    ):
        self.ax.clear()
        if matrix.size == 0:
            self.canvas.draw_idle()
            return
        abs_freqs = freqs + center_freq
        extent = [abs_freqs[0], abs_freqs[-1], times[-1] if times.size else 0.0, 0.0]
        data = np.clip(matrix, floor_db, None)
        self._image = self.ax.imshow(
            data,
            aspect="auto",
            extent=extent,
            cmap=colormap,
            interpolation="nearest",
        )
        self.ax.set_xlabel("Frequency (Hz)")
        self.ax.set_ylabel("Time (s)")
        self.canvas.draw_idle()

    def closeEvent(self, event):  # noqa: N802 - Qt naming
        event.accept()
