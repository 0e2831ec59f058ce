"""Interactive Qt GUI (port of the JAX package's ``interactive/``).

The window needs matplotlib, and PySide6 for a display; without PySide6 the
first-party headless toolkit (:mod:`.headless_qt`) stands in.  Importing
:mod:`.app` raises ImportError without matplotlib, and the command line then
falls back to terminal mode.  :mod:`.state` (session state), :mod:`.models`
(snapshot/session dataclasses) and :mod:`.workers` (the worker functions and
their runnables) import without matplotlib: :mod:`._qt` resolves the
matplotlib canvas on first use.
"""

from __future__ import annotations

from .models import InteractiveSessionResult, SnapshotData, StatusProgressSink
from .state import InteractiveState


def launch_interactive_session(*args, **kwargs):
    """Start the GUI session (requires PySide6; see :mod:`.app`)."""
    from .app import launch_interactive_session as _launch

    return _launch(*args, **kwargs)


def interactive_select(*args, **kwargs):
    from .app import interactive_select as _select

    return _select(*args, **kwargs)


__all__ = [
    "InteractiveSessionResult",
    "SnapshotData",
    "StatusProgressSink",
    "InteractiveState",
    "launch_interactive_session",
    "interactive_select",
]
