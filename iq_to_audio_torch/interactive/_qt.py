"""Qt binding resolution for the interactive package (port of the JAX
package's ``interactive/_qt.py``).

All interactive modules import their Qt names from here.  Resolution order:

* ``IQ2A_QT=pyside6`` — require real PySide6 (raise if missing).
* ``IQ2A_QT=headless`` — force the first-party headless toolkit
  (:mod:`.headless_qt`) even when PySide6 is available.
* default (``auto``) — PySide6 when importable, headless otherwise.

``HEADLESS`` tells callers which backend is live; the GUI launcher refuses
to start an interactive session headlessly unless explicitly asked
(``IQ2A_QT=headless``), because there is nothing to interact *with* — the
headless toolkit exists so the GUI code constructs, wires and executes in
display-less environments (tests, CI, SSH), the equivalent of the
reference's offscreen/xvfb Qt testing (reference ``ci.yml:66-80``).

``FigureCanvas`` resolves to the QtAgg matplotlib canvas under PySide6 and
to an Agg-backed canvas that is also a headless ``QWidget`` otherwise, so
spectrum/waterfall rendering and matplotlib event routing (SpanSelector,
click-to-tune) genuinely run either way.  ``Figure`` and ``FigureCanvas``
are resolved lazily, so this module imports without matplotlib.
"""

from __future__ import annotations

import os

_mode = os.environ.get("IQ2A_QT", "auto").lower()
HEADLESS = False

if _mode not in ("auto", "pyside6", "headless"):
    raise ValueError(f"IQ2A_QT must be auto|pyside6|headless, got {_mode!r}")

if _mode in ("auto", "pyside6"):
    try:
        from PySide6.QtCore import (  # noqa: F401
            QObject,
            QRunnable,
            QSocketNotifier,
            QThreadPool,
            QTimer,
            Qt,
            Signal,
            Slot,
        )
        from PySide6.QtGui import QAction, QKeySequence  # noqa: F401
        from PySide6.QtWidgets import (  # noqa: F401
            QApplication,
            QCheckBox,
            QComboBox,
            QDialog,
            QDoubleSpinBox,
            QFileDialog,
            QFormLayout,
            QGridLayout,
            QGroupBox,
            QHBoxLayout,
            QLabel,
            QLineEdit,
            QMainWindow,
            QPlainTextEdit,
            QProgressBar,
            QPushButton,
            QScrollArea,
            QSpinBox,
            QSplitter,
            QStackedWidget,
            QStatusBar,
            QTableWidget,
            QTableWidgetItem,
            QToolBar,
            QVBoxLayout,
            QWidget,
        )
    except ImportError:
        if _mode == "pyside6":
            raise
        _mode = "headless"

if _mode == "headless":
    HEADLESS = True
    from .headless_qt import (  # noqa: F401
        QApplication,
        QAction,
        QCheckBox,
        QComboBox,
        QDialog,
        QDoubleSpinBox,
        QFileDialog,
        QFormLayout,
        QGridLayout,
        QGroupBox,
        QHBoxLayout,
        QKeySequence,
        QLabel,
        QLineEdit,
        QMainWindow,
        QObject,
        QPlainTextEdit,
        QProgressBar,
        QPushButton,
        QRunnable,
        QScrollArea,
        QSocketNotifier,
        QSpinBox,
        QSplitter,
        QStackedWidget,
        QStatusBar,
        QTableWidget,
        QTableWidgetItem,
        QThreadPool,
        QTimer,
        QToolBar,
        QVBoxLayout,
        QWidget,
        Qt,
        Signal,
        Slot,
    )


# -- matplotlib canvas -------------------------------------------------------
#
# ``Figure`` and ``FigureCanvas`` resolve on first use (module ``__getattr__``),
# not at import: the workers, models, state and the headless pool import this
# module, and they run without matplotlib.  Only the window needs it.


def _figure_canvas():
    if not HEADLESS:
        from matplotlib.backends.backend_qtagg import FigureCanvasQTAgg

        return FigureCanvasQTAgg
    from matplotlib.backends.backend_agg import FigureCanvasAgg as _FigureCanvasAgg

    class FigureCanvas(_FigureCanvasAgg, QWidget):
        """Agg canvas that is also a headless QWidget: draws offscreen and
        routes matplotlib events (mpl_connect / SpanSelector) normally."""

        def __init__(self, figure=None):
            QWidget.__init__(self)
            _FigureCanvasAgg.__init__(self, figure)

    return FigureCanvas


def __getattr__(name: str):
    if name == "Figure":
        from matplotlib.figure import Figure

        value = Figure
    elif name == "FigureCanvas":
        value = _figure_canvas()
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value  # resolved once
    return value
