"""Persistent recent-captures list.

The reference GUI remembers only the current session's latest capture
(app.py:893-919, pushed to the post pages); here the list also survives
restarts in a small JSON file so reopening yesterday's recording is one
click.  Storage lives under ``$IQ2A_CONFIG_DIR`` (default
``~/.config/iq-to-audio-torch``); missing files are pruned on load.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

LOG = logging.getLogger(__name__)

_LIMIT = 8


def _default_store() -> Path:
    base = os.environ.get("IQ2A_CONFIG_DIR")
    root = Path(base) if base else Path.home() / ".config" / "iq-to-audio-torch"
    return root / "recent.json"


class RecentFiles:
    """Most-recent-first capture paths with bounded length."""

    def __init__(self, store: Path | None = None, limit: int = _LIMIT):
        self.store = store or _default_store()
        self.limit = limit

    def load(self) -> list[Path]:
        try:
            raw = json.loads(self.store.read_text())
        except (OSError, ValueError):
            return []
        paths = [Path(p) for p in raw if isinstance(p, str)]
        return [p for p in paths if p.is_file()][: self.limit]

    def add(self, path: Path) -> list[Path]:
        """Record ``path`` as most recent; returns the updated list."""
        path = Path(path)
        entries = [p for p in self.load() if p != path]
        entries.insert(0, path)
        entries = entries[: self.limit]
        try:
            self.store.parent.mkdir(parents=True, exist_ok=True)
            tmp = self.store.with_suffix(".json.tmp")
            tmp.write_text(json.dumps([str(p) for p in entries], indent=0))
            tmp.replace(self.store)
        except OSError as exc:  # non-fatal: the list is a convenience
            LOG.debug("recent-files store not writable (%s): %s", self.store, exc)
        return entries
