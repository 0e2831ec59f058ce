"""First-party headless Qt-compatible widget toolkit.

A pure-Python implementation of the (small) PySide6 surface the interactive
package uses, so the GUI executes — constructed, wired, signal-routed and
driven — in environments without Qt: offscreen CI, SSH sessions, and the
test suite (the reference runs its Qt tests under xvfb/offscreen,
reference ``.github/workflows/ci.yml:66-80``; this toolkit is the
no-display equivalent).

Semantics follow Qt where the interactive package depends on them:

* ``Signal`` descriptors bind per instance; ``emit`` trims arguments to
  each slot's accepted arity (Qt allows connecting slots with fewer
  parameters than the signal carries).
* Value setters (``setChecked``, ``setValue``, ``setCurrentIndex``…) emit
  their change signals exactly when the value actually changes.
* ``QThreadPool.start`` runs runnables synchronously by default —
  deterministic for tests.  ``IQ2A_SHIM_ASYNC=1`` (or
  ``QThreadPool.set_async(True)``) switches to REAL worker threads with
  Qt's queued-connection semantics: a signal emitted off the main thread
  is queued and delivered by ``processEvents``/``exec`` on the main
  thread, so worker-concurrency behavior (signal ordering, re-entrancy)
  is testable without PySide6.
* ``QApplication.processEvents`` drains single-shot timers and polls
  ``QSocketNotifier`` file descriptors, so the SIGINT relay genuinely
  works headlessly.

Only the API the package uses is implemented; unknown attributes raise
``AttributeError`` loudly rather than no-op silently.
"""

from __future__ import annotations

import inspect
import os
import select
import threading
import time

#: the Qt "GUI thread": whichever thread imported the toolkit (the test
#: process main thread).  Cross-thread signal emissions queue to it.
_MAIN_THREAD = threading.current_thread()


# ---------------------------------------------------------------------------
# QtCore
# ---------------------------------------------------------------------------


class Qt:
    """Enum namespace (only the members the package touches)."""

    Horizontal = 0x1
    Vertical = 0x2
    ItemIsSelectable = 0x1
    ItemIsEditable = 0x2
    ItemIsEnabled = 0x20


class _BoundSignal:
    def __init__(self, name: str, owner=None):
        self._name = name
        self._owner = owner
        self._slots: list = []

    def connect(self, slot):
        self._slots.append(slot)

    def disconnect(self, slot=None):
        if slot is None:
            self._slots.clear()
        else:
            self._slots.remove(slot)

    @staticmethod
    def _arity(slot):
        try:
            sig = inspect.signature(slot)
        except (TypeError, ValueError):
            return None  # builtins etc.: pass everything
        count = 0
        for p in sig.parameters.values():
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
                count += 1
            elif p.kind == p.VAR_POSITIONAL:
                return None
        return count

    def emit(self, *args):
        if self._owner is not None and getattr(self._owner, "_signals_blocked", False):
            return
        if threading.current_thread() is not _MAIN_THREAD:
            # Qt queued-connection semantics: a cross-thread emit is
            # delivered on the main thread by the event loop
            QApplication._pending.append(lambda: self._deliver(args))
            return
        self._deliver(args)

    def _deliver(self, args):
        for slot in list(self._slots):
            arity = self._arity(slot)
            slot(*(args if arity is None else args[:arity]))


class Signal:
    """Class-level descriptor -> per-instance :class:`_BoundSignal`."""

    _counter = 0

    def __init__(self, *types):
        self._types = types
        Signal._counter += 1
        self._key = f"__signal_{Signal._counter}"

    def __set_name__(self, owner, name):
        self._key = f"__signal_{name}"

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        bound = obj.__dict__.get(self._key)
        if bound is None:
            bound = _BoundSignal(self._key, owner=obj)
            obj.__dict__[self._key] = bound
        return bound


def Slot(*args, **kwargs):  # noqa: N802 - Qt naming
    def decorate(fn):
        return fn

    if len(args) == 1 and callable(args[0]) and not kwargs:
        return args[0]
    return decorate


class QObject:
    def __init__(self, parent=None):
        self._parent = parent

    def parent(self):
        return self._parent

    def blockSignals(self, blocked):  # noqa: N802
        """Qt semantics: while blocked, the object's signals do not emit;
        returns the previous state."""
        prev = getattr(self, "_signals_blocked", False)
        self._signals_blocked = bool(blocked)
        return prev

    def signalsBlocked(self):  # noqa: N802
        return getattr(self, "_signals_blocked", False)

    def deleteLater(self):  # noqa: N802
        pass


class QRunnable:
    def __init__(self):
        pass

    def run(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def setAutoDelete(self, value):  # noqa: N802
        pass


class QThreadPool(QObject):
    _global = None
    #: class-wide async switch (also honoured from IQ2A_SHIM_ASYNC=1)
    _async = False

    @classmethod
    def globalInstance(cls):  # noqa: N802
        if cls._global is None:
            cls._global = cls()
        return cls._global

    @classmethod
    def set_async(cls, enabled: bool) -> None:
        """Run subsequent runnables on real worker threads (queued-signal
        delivery via processEvents) instead of synchronously."""
        cls._async = bool(enabled)

    def __init__(self, parent=None):
        super().__init__(parent)
        self._threads: list[threading.Thread] = []

    def start(self, runnable):
        if QThreadPool._async or os.environ.get("IQ2A_SHIM_ASYNC") == "1":
            t = threading.Thread(target=runnable.run, daemon=True)
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            t.start()
            return
        runnable.run()  # synchronous: deterministic headless execution

    def waitForDone(self, msecs: int = -1) -> bool:  # noqa: N802
        deadline = None if msecs < 0 else time.monotonic() + msecs / 1000.0
        for t in self._threads:
            t.join(None if deadline is None
                   else max(0.0, deadline - time.monotonic()))
        self._threads = [t for t in self._threads if t.is_alive()]
        return not self._threads

    def activeThreadCount(self):  # noqa: N802
        self._threads = [t for t in self._threads if t.is_alive()]
        return len(self._threads)

    def setMaxThreadCount(self, n):  # noqa: N802
        pass


class QTimer(QObject):
    timeout = Signal()

    def __init__(self, parent=None):
        super().__init__(parent)
        self._interval = 0
        self._single = False
        self._active = False

    @staticmethod
    def singleShot(ms, fn):  # noqa: N802
        QApplication._pending.append(fn)

    def setInterval(self, ms):  # noqa: N802
        self._interval = ms

    def setSingleShot(self, single):  # noqa: N802
        self._single = single

    def start(self, ms=None):
        if ms is not None:
            self._interval = ms
        self._active = True
        QApplication._pending.append(self._fire)

    def stop(self):
        self._active = False

    def _fire(self):
        if self._active:
            self.timeout.emit()
            if self._single:
                self._active = False


class QSocketNotifier(QObject):
    Read = 0
    Write = 1
    Exception = 2

    activated = Signal(int)

    def __init__(self, fd, kind, parent=None):
        super().__init__(parent)
        self._fd = fd
        self._kind = kind
        self._enabled = True
        QApplication._notifiers.append(self)

    def setEnabled(self, enabled):  # noqa: N802
        self._enabled = enabled

    def _poll(self):
        if not self._enabled or self._kind != QSocketNotifier.Read:
            return
        readable, _, _ = select.select([self._fd], [], [], 0)
        if readable:
            self.activated.emit(self._fd)


# ---------------------------------------------------------------------------
# QtGui
# ---------------------------------------------------------------------------


class QKeySequence:
    def __init__(self, sequence=""):
        self._sequence = str(sequence)

    def toString(self):  # noqa: N802
        return self._sequence


class QAction(QObject):
    triggered = Signal(bool)

    def __init__(self, text="", parent=None):
        super().__init__(parent)
        self._text = text
        self._shortcut = None
        self._enabled = True

    def setShortcut(self, shortcut):  # noqa: N802
        self._shortcut = shortcut

    def shortcut(self):
        return self._shortcut

    def setEnabled(self, enabled):  # noqa: N802
        self._enabled = enabled

    def isEnabled(self):  # noqa: N802
        return self._enabled

    def setText(self, text):  # noqa: N802
        self._text = text

    def text(self):
        return self._text

    def trigger(self):
        if self._enabled:
            self.triggered.emit(False)


# ---------------------------------------------------------------------------
# QtWidgets: layouts
# ---------------------------------------------------------------------------


class _Layout:
    def __init__(self, parent=None):
        self._items: list = []
        if parent is not None:
            parent.setLayout(self)

    def addWidget(self, widget, *args, **kwargs):  # noqa: N802
        self._items.append(widget)

    def addLayout(self, layout, *args, **kwargs):  # noqa: N802
        self._items.append(layout)

    def addStretch(self, stretch=0):  # noqa: N802
        pass

    def setContentsMargins(self, *m):  # noqa: N802
        pass

    def setSpacing(self, s):  # noqa: N802
        pass

    def count(self):
        return len(self._items)

    def itemAt(self, i):  # noqa: N802
        return self._items[i] if 0 <= i < len(self._items) else None

    def widgets(self):
        """Headless helper: flat list of widgets in this layout subtree."""
        out = []
        for item in self._items:
            if isinstance(item, _Layout):
                out.extend(item.widgets())
            else:
                out.append(item)
        return out


class QVBoxLayout(_Layout):
    pass


class QHBoxLayout(_Layout):
    pass


class QGridLayout(_Layout):
    pass


class QFormLayout(_Layout):
    def addRow(self, label, widget=None):  # noqa: N802
        self._items.append(label)
        if widget is not None:
            self._items.append(widget)


# ---------------------------------------------------------------------------
# QtWidgets: widgets
# ---------------------------------------------------------------------------


class QWidget(QObject):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._visible = False
        self._enabled = True
        self._layout = None
        self._tooltip = ""
        self._stylesheet = ""
        self._properties: dict = {}
        self._window_title = ""
        self._size = (640, 480)
        self._closed = False

    # visibility -----------------------------------------------------------
    def show(self):
        self._visible = True
        QApplication._shown.append(self)

    def hide(self):
        self._visible = False

    def setVisible(self, visible):  # noqa: N802
        self._visible = bool(visible)

    def isVisible(self):  # noqa: N802
        return self._visible

    def close(self):
        event = _CloseEvent()
        self.closeEvent(event)
        if event._accepted:
            self._visible = False
            self._closed = True
            app = QApplication.instance()
            if app is not None:
                app._window_closed(self)
        return event._accepted

    def closeEvent(self, event):  # noqa: N802
        event.accept()

    # geometry ---------------------------------------------------------------
    def resize(self, w, h):
        self._size = (w, h)
        self.resizeEvent(_ResizeEvent(w, h))

    def resizeEvent(self, event):  # noqa: N802
        pass

    def size(self):
        return self._size

    def setFixedWidth(self, w):  # noqa: N802
        self._size = (w, self._size[1])

    def setFixedHeight(self, h):  # noqa: N802
        self._size = (self._size[0], h)

    def setMinimumWidth(self, w):  # noqa: N802
        pass

    def setMinimumHeight(self, h):  # noqa: N802
        pass

    def setMinimumSize(self, w, h):  # noqa: N802
        pass

    # state -------------------------------------------------------------------
    def setEnabled(self, enabled):  # noqa: N802
        self._enabled = bool(enabled)

    def isEnabled(self):  # noqa: N802
        return self._enabled

    def setLayout(self, layout):  # noqa: N802
        self._layout = layout

    def layout(self):
        return self._layout

    def setToolTip(self, tip):  # noqa: N802
        self._tooltip = tip

    def toolTip(self):  # noqa: N802
        return self._tooltip

    def setStyleSheet(self, sheet):  # noqa: N802
        self._stylesheet = sheet

    def styleSheet(self):  # noqa: N802
        return self._stylesheet

    def setProperty(self, name, value):  # noqa: N802
        self._properties[name] = value

    def property(self, name):
        return self._properties.get(name)

    def setWindowTitle(self, title):  # noqa: N802
        self._window_title = title

    def windowTitle(self):  # noqa: N802
        return self._window_title

    def setFocus(self):  # noqa: N802
        pass

    def update(self):
        pass


class _CloseEvent:
    def __init__(self):
        self._accepted = False

    def accept(self):
        self._accepted = True

    def ignore(self):
        self._accepted = False


class _ResizeEvent:
    def __init__(self, w, h):
        self._size = (w, h)

    def size(self):
        return self._size


class QLabel(QWidget):
    def __init__(self, text="", parent=None):
        super().__init__(parent)
        self._text = text
        self._wrap = False

    def setText(self, text):  # noqa: N802
        self._text = text

    def text(self):
        return self._text

    def setWordWrap(self, wrap):  # noqa: N802
        self._wrap = wrap


class QPushButton(QWidget):
    clicked = Signal(bool)

    def __init__(self, text="", parent=None):
        super().__init__(parent)
        self._text = text

    def setText(self, text):  # noqa: N802
        self._text = text

    def text(self):
        return self._text

    def click(self):
        if self._enabled:
            self.clicked.emit(False)


class QCheckBox(QWidget):
    toggled = Signal(bool)
    stateChanged = Signal(int)  # noqa: N815 - Qt naming

    def __init__(self, text="", parent=None):
        super().__init__(parent)
        self._text = text
        self._checked = False

    def setChecked(self, checked):  # noqa: N802
        checked = bool(checked)
        if checked != self._checked:
            self._checked = checked
            self.toggled.emit(checked)
            self.stateChanged.emit(2 if checked else 0)

    def isChecked(self):  # noqa: N802
        return self._checked

    def toggle(self):
        self.setChecked(not self._checked)


class QComboBox(QWidget):
    currentIndexChanged = Signal(int)  # noqa: N815
    currentTextChanged = Signal(str)  # noqa: N815

    def __init__(self, parent=None):
        super().__init__(parent)
        self._items: list[tuple[str, object]] = []
        self._index = -1

    def addItem(self, label, data=None):  # noqa: N802
        self._items.append((label, data))
        if self._index < 0:
            self._index = 0

    def clear(self):
        self._items.clear()
        self._index = -1

    def addItems(self, labels):  # noqa: N802
        for label in labels:
            self.addItem(label)

    def count(self):
        return len(self._items)

    def setCurrentIndex(self, index):  # noqa: N802
        if 0 <= index < len(self._items) and index != self._index:
            self._index = index
            self.currentIndexChanged.emit(index)
            self.currentTextChanged.emit(self._items[index][0])

    def currentIndex(self):  # noqa: N802
        return self._index

    def currentText(self):  # noqa: N802
        return self._items[self._index][0] if self._index >= 0 else ""

    def setCurrentText(self, text):  # noqa: N802
        for i, (label, _) in enumerate(self._items):
            if label == text:
                self.setCurrentIndex(i)
                return

    def currentData(self):  # noqa: N802
        return self._items[self._index][1] if self._index >= 0 else None

    def itemData(self, index):  # noqa: N802
        return self._items[index][1]

    def itemText(self, index):  # noqa: N802
        return self._items[index][0]

    def findData(self, data):  # noqa: N802
        for i, (_, d) in enumerate(self._items):
            if d == data:
                return i
        return -1


class QLineEdit(QWidget):
    textChanged = Signal(str)  # noqa: N815
    editingFinished = Signal()  # noqa: N815

    def __init__(self, text="", parent=None):
        super().__init__(parent)
        self._text = text
        self._placeholder = ""
        self._readonly = False

    def setText(self, text):  # noqa: N802
        if text != self._text:
            self._text = text
            self.textChanged.emit(text)

    def text(self):
        return self._text

    def setPlaceholderText(self, text):  # noqa: N802
        self._placeholder = text

    def placeholderText(self):  # noqa: N802
        return self._placeholder

    def setReadOnly(self, ro):  # noqa: N802
        self._readonly = ro

    def clear(self):
        self.setText("")


class _SpinBase(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._min = 0.0
        self._max = 99.0
        self._value = 0.0
        self._step = 1.0
        self._suffix = ""

    def setRange(self, lo, hi):  # noqa: N802
        self._min, self._max = lo, hi
        self._assign(min(max(self._value, lo), hi))

    def minimum(self):
        return self._min

    def maximum(self):
        return self._max

    def setSingleStep(self, step):  # noqa: N802
        self._step = step

    def setSuffix(self, suffix):  # noqa: N802
        self._suffix = suffix

    def setSpecialValueText(self, text):  # noqa: N802
        # display-only in real Qt (shown when value == minimum)
        self._special_value_text = text

    def setValue(self, value):  # noqa: N802
        self._assign(min(max(value, self._min), self._max))

    def _assign(self, value):
        if value != self._value:
            self._value = value
            self.valueChanged.emit(self._coerce(value))

    def value(self):
        return self._coerce(self._value)


class QSpinBox(_SpinBase):
    valueChanged = Signal(int)  # noqa: N815

    @staticmethod
    def _coerce(value):
        return int(value)


class QDoubleSpinBox(_SpinBase):
    valueChanged = Signal(float)  # noqa: N815

    def __init__(self, parent=None):
        super().__init__(parent)
        self._decimals = 2

    def setDecimals(self, d):  # noqa: N802
        self._decimals = d

    @staticmethod
    def _coerce(value):
        return float(value)


class QProgressBar(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._min, self._max = 0, 100
        self._value = 0
        self._format = ""

    def setRange(self, lo, hi):  # noqa: N802
        self._min, self._max = lo, hi

    def setValue(self, value):  # noqa: N802
        self._value = value

    def value(self):
        return self._value

    def setFormat(self, fmt):  # noqa: N802
        self._format = fmt

    def reset(self):
        self._value = self._min


class QPlainTextEdit(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._lines: list[str] = []
        self._readonly = False
        self._max_blocks = None

    def appendPlainText(self, text):  # noqa: N802
        self._lines.extend(str(text).split("\n"))
        if self._max_blocks:
            self._lines = self._lines[-self._max_blocks :]

    def setPlainText(self, text):  # noqa: N802
        self._lines = str(text).split("\n") if text else []

    def toPlainText(self):  # noqa: N802
        return "\n".join(self._lines)

    def setReadOnly(self, ro):  # noqa: N802
        self._readonly = ro

    def setMaximumBlockCount(self, n):  # noqa: N802
        self._max_blocks = n

    def clear(self):
        self._lines = []


class QTableWidgetItem:
    def __init__(self, text=""):
        self._text = str(text)
        self._flags = Qt.ItemIsSelectable | Qt.ItemIsEditable | Qt.ItemIsEnabled

    def text(self):
        return self._text

    def setText(self, text):  # noqa: N802
        self._text = str(text)

    def flags(self):
        return self._flags

    def setFlags(self, flags):  # noqa: N802
        self._flags = flags


class _HeaderView:
    def setStretchLastSection(self, stretch):  # noqa: N802
        pass

    def setSectionResizeMode(self, *args):  # noqa: N802
        pass


class QTableWidget(QWidget):
    cellClicked = Signal(int, int)  # noqa: N815

    def __init__(self, rows=0, columns=0, parent=None):
        super().__init__(parent)
        self._rows = rows
        self._cols = columns
        self._cells: dict[tuple[int, int], QTableWidgetItem] = {}
        self._header_labels: list[str] = []
        self._header = _HeaderView()

    def setRowCount(self, rows):  # noqa: N802
        self._rows = rows
        self._cells = {k: v for k, v in self._cells.items() if k[0] < rows}

    def rowCount(self):  # noqa: N802
        return self._rows

    def setColumnCount(self, cols):  # noqa: N802
        self._cols = cols

    def columnCount(self):  # noqa: N802
        return self._cols

    def setHorizontalHeaderLabels(self, labels):  # noqa: N802
        self._header_labels = list(labels)

    def horizontalHeader(self):  # noqa: N802
        return self._header

    def setItem(self, row, col, item):  # noqa: N802
        self._cells[(row, col)] = item

    def item(self, row, col):
        return self._cells.get((row, col))

    def clearContents(self):  # noqa: N802
        self._cells = {}


class QGroupBox(QWidget):
    def __init__(self, title="", parent=None):
        super().__init__(parent)
        self._title = title

    def setTitle(self, title):  # noqa: N802
        self._title = title

    def title(self):
        return self._title


class QScrollArea(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._widget = None

    def setWidget(self, widget):  # noqa: N802
        self._widget = widget

    def widget(self):
        return self._widget

    def setWidgetResizable(self, resizable):  # noqa: N802
        pass


class QSplitter(QWidget):
    def __init__(self, orientation=Qt.Horizontal, parent=None):
        super().__init__(parent)
        self._orientation = orientation
        self._widgets: list[QWidget] = []
        self._sizes: list[int] = []

    def addWidget(self, widget):  # noqa: N802
        self._widgets.append(widget)
        self._sizes.append(max(100, 1280 // max(len(self._widgets), 1)))

    def widget(self, i):
        return self._widgets[i]

    def count(self):
        return len(self._widgets)

    def sizes(self):
        return list(self._sizes)

    def setSizes(self, sizes):  # noqa: N802
        self._sizes = list(sizes)

    def setChildrenCollapsible(self, collapsible):  # noqa: N802
        pass

    def setStretchFactor(self, index, factor):  # noqa: N802
        pass


class QStackedWidget(QWidget):
    currentChanged = Signal(int)  # noqa: N815

    def __init__(self, parent=None):
        super().__init__(parent)
        self._widgets: list[QWidget] = []
        self._index = -1

    def addWidget(self, widget):  # noqa: N802
        self._widgets.append(widget)
        if self._index < 0:
            self._index = 0
        return len(self._widgets) - 1

    def setCurrentIndex(self, index):  # noqa: N802
        if 0 <= index < len(self._widgets) and index != self._index:
            self._index = index
            self.currentChanged.emit(index)

    def currentIndex(self):  # noqa: N802
        return self._index

    def currentWidget(self):  # noqa: N802
        return self._widgets[self._index] if self._index >= 0 else None

    def widget(self, i):
        return self._widgets[i]

    def count(self):
        return len(self._widgets)


class QToolBar(QWidget):
    def __init__(self, title="", parent=None):
        super().__init__(parent)
        self._title = title
        self._actions: list[QAction] = []

    def setMovable(self, movable):  # noqa: N802
        pass

    def addAction(self, action):  # noqa: N802
        self._actions.append(action)
        return action

    def addWidget(self, widget):  # noqa: N802
        self._actions.append(widget)

    def addSeparator(self):  # noqa: N802
        pass

    def actions(self):
        return list(self._actions)


class QStatusBar(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._message = ""
        self._permanent: list[QWidget] = []

    def addPermanentWidget(self, widget, stretch=0):  # noqa: N802
        self._permanent.append(widget)

    def showMessage(self, message, timeout=0):  # noqa: N802
        self._message = message

    def currentMessage(self):  # noqa: N802
        return self._message

    def clearMessage(self):  # noqa: N802
        self._message = ""


class QMainWindow(QWidget):
    def __init__(self, parent=None):
        super().__init__(parent)
        self._central = None
        self._toolbars: list[QToolBar] = []
        self._statusbar = None

    def setCentralWidget(self, widget):  # noqa: N802
        self._central = widget

    def centralWidget(self):  # noqa: N802
        return self._central

    def addToolBar(self, toolbar):  # noqa: N802
        self._toolbars.append(toolbar)
        return toolbar

    def toolBars(self):  # noqa: N802 - headless helper
        return list(self._toolbars)

    def setStatusBar(self, bar):  # noqa: N802
        self._statusbar = bar

    def statusBar(self):  # noqa: N802
        if self._statusbar is None:
            self._statusbar = QStatusBar()
        return self._statusbar


class QDialog(QWidget):
    finished = Signal(int)

    Accepted = 1
    Rejected = 0

    def __init__(self, parent=None):
        super().__init__(parent)
        self._result = None

    def accept(self):
        self._result = QDialog.Accepted
        self.finished.emit(QDialog.Accepted)
        self.hide()

    def reject(self):
        self._result = QDialog.Rejected
        self.finished.emit(QDialog.Rejected)
        self.hide()

    def result(self):
        return self._result

    def exec(self):
        self.show()
        return self._result if self._result is not None else QDialog.Rejected


class QFileDialog:
    """Static pickers return empty selections headlessly (no display to ask
    on); tests monkeypatch these, exactly as the reference suite does."""

    @staticmethod
    def getOpenFileName(parent=None, caption="", dir="", filter=""):  # noqa: N802,A002
        return "", ""

    @staticmethod
    def getSaveFileName(parent=None, caption="", dir="", filter=""):  # noqa: N802,A002
        return "", ""

    @staticmethod
    def getExistingDirectory(parent=None, caption="", dir=""):  # noqa: N802,A002
        return ""


class QApplication(QObject):
    _instance = None
    _pending: list = []
    _notifiers: list = []
    _shown: list = []

    def __init__(self, argv=None):
        super().__init__()
        QApplication._instance = self
        self._quit = False
        self._stylesheet = ""

    @classmethod
    def instance(cls):
        return cls._instance

    def setStyleSheet(self, sheet):  # noqa: N802
        self._stylesheet = sheet

    def styleSheet(self):  # noqa: N802
        return self._stylesheet

    def quit(self):
        self._quit = True

    def _window_closed(self, window):
        if window in QApplication._shown:
            QApplication._shown.remove(window)
        if not any(w.isVisible() for w in QApplication._shown):
            self._quit = True

    @staticmethod
    def processEvents():  # noqa: N802
        pending, QApplication._pending = QApplication._pending, []
        for fn in pending:
            fn()
        for notifier in list(QApplication._notifiers):
            notifier._poll()

    def exec(self, max_seconds: float = 60.0):
        """Headless event loop: drain timers + socket notifiers until
        ``quit()`` or the last shown window closes.  Bounded so a headless
        session can never hang forever."""
        deadline = time.monotonic() + max_seconds
        while not self._quit and time.monotonic() < deadline:
            QApplication.processEvents()
            if not QApplication._shown:
                break
            time.sleep(0.01)
        return 0

    exec_ = exec
