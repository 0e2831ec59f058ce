"""Phase-based progress reporting (copy of the JAX package's
``pipeline/progress.py``, which imports no JAX; kept here so the port
imports nothing of that package).

The pipeline reports work through a small event protocol: a
:class:`ProgressTracker` owns a set of :class:`PhaseState` records
(ingest, DSP, encode, ...), clamps every advance to the declared
totals, and forwards the clamped deltas to a pluggable
:class:`ProgressSink`. Front ends written against the reference's
progress model (reference ``progress.py``) drop in unchanged: the
class names, method names and keyword signatures are the same.

Sinks shipped here:

* :class:`NullProgressSink` — swallows everything (library use).
* :class:`TqdmProgressSink` — one aggregate bar plus one bar per phase.

GUI front ends implement :class:`ProgressSink` themselves.
"""

from __future__ import annotations

import threading
from collections.abc import Callable, Iterable
from dataclasses import dataclass, replace

try:
    from tqdm import tqdm as _tqdm
except ImportError:  # pragma: no cover - optional dependency
    _tqdm = None

_STATUS_WIDTH = 48


def _squash_status(text: str) -> str:
    """Collapse whitespace and hard-cap status text at ``_STATUS_WIDTH``."""
    flat = " ".join(str(text).split())
    return flat if len(flat) <= _STATUS_WIDTH else flat[: _STATUS_WIDTH - 1] + "…"


@dataclass
class PhaseState:
    """Progress bookkeeping for one named processing phase."""

    key: str
    label: str
    total: float
    unit: str = "samples"
    completed: float = 0.0

    def remaining(self) -> float:
        return max(self.total - self.completed, 0.0)


class ProgressSink:
    """Receiver protocol for progress events.

    ``start`` is called once with the full phase list, ``advance`` with
    already-clamped deltas, ``status`` with short free-text updates and
    ``close`` exactly once at teardown. ``set_cancel_callback`` hands the
    sink a function it may invoke (e.g. from a Ctrl-C handler) to request
    cooperative cancellation; ``cancel`` notifies the sink the run is
    being torn down early.
    """

    def start(self, phases: Iterable[PhaseState], *, overall_total: float) -> None:
        raise NotImplementedError

    def advance(
        self,
        phase: PhaseState,
        delta: float,
        *,
        overall_completed: float,
        overall_total: float,
    ) -> None:
        raise NotImplementedError

    def status(self, message: str) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError

    def cancel(self) -> None:
        raise NotImplementedError

    def set_cancel_callback(self, callback: Callable[[], None]) -> None:
        return


class NullProgressSink(ProgressSink):
    """Discard every event; used when no sink is supplied."""

    def start(self, phases, *, overall_total):
        pass

    def advance(self, phase, delta, *, overall_completed, overall_total):
        pass

    def status(self, message):
        pass

    def close(self):
        pass

    def cancel(self):
        pass


class TqdmProgressSink(ProgressSink):
    """Terminal rendering: a "Total" bar on row 0, one bar per phase below."""

    def __init__(self):
        if _tqdm is None:
            raise RuntimeError(
                "tqdm is required for progress reporting but is not installed."
            )
        self._bars: dict[str, object] = {}
        self._total_bar = None
        self._last_status: str | None = None
        self._on_cancel: Callable[[], None] | None = None

    def _make_bar(self, *, total, desc, unit, row, leave=True):
        return _tqdm(
            total=total if total and total > 0 else None,
            desc=desc,
            unit=unit,
            position=row,
            leave=leave,
        )

    def start(self, phases, *, overall_total):
        self._total_bar = self._make_bar(
            total=overall_total, desc="Total", unit="samples", row=0
        )
        for row, ph in enumerate(phases, start=1):
            self._bars[ph.key] = self._make_bar(
                total=ph.total, desc=ph.label, unit=ph.unit, row=row
            )

    def advance(self, phase, delta, *, overall_completed, overall_total):
        if delta <= 0:
            return
        if self._total_bar is not None:
            self._total_bar.update(delta)
            if self._last_status and overall_total > 0:
                frac = min(overall_completed / overall_total, 1.0)
                self._total_bar.set_postfix_str(
                    f"{self._last_status} ({100.0 * frac:5.1f}%)"
                )
        bar = self._bars.get(phase.key)
        if bar is None:
            return
        bar.update(delta)
        if phase.total > 0:
            frac = min(phase.completed / phase.total, 1.0)
            bar.set_postfix_str(f"{100.0 * frac:5.1f}%")

    def status(self, message):
        self._last_status = message
        if self._total_bar is not None:
            self._total_bar.set_postfix_str(message)

    def cancel(self):
        if self._total_bar is not None:
            self._total_bar.set_postfix_str("Cancelled")

    def set_cancel_callback(self, callback):
        self._on_cancel = callback

    def close(self):
        for bar in (self._total_bar, *self._bars.values()):
            if bar is not None:
                bar.close()
        self._total_bar = None
        self._bars = {}
        self._on_cancel = None


class ProgressTracker:
    """Own the phase table; clamp advances; fan events out to one sink.

    Semantics (matching the reference tracker):

    * ``advance`` on an unknown key, a non-positive amount, before
      ``start`` or after ``cancel`` is a no-op.
    * Per-phase completion never exceeds the phase total, and the
      aggregate never exceeds the sum of totals — the sink only ever
      sees the clamped delta.
    * ``cancel`` is idempotent and notifies the sink at most once.
    """

    def __init__(self, sink: ProgressSink | None = None):
        self._sink: ProgressSink = sink if sink is not None else NullProgressSink()
        self._table: dict[str, PhaseState] = {}
        self._sum_total = 0.0
        self._sum_done = 0.0
        self._live = False
        self._cancelled = False
        self._cancel_sent = False
        # burst-mode workers advance concurrently from several threads;
        # the read-modify-write of phase.completed/_sum_done (and the
        # sink's own rendering) must not interleave.  Reentrant: a sink's
        # advance may invoke the cancel callback, which legitimately calls
        # back into status()/cancel() on this same tracker
        self._lock = threading.RLock()

    @property
    def cancelled(self) -> bool:
        return self._cancelled

    def start(self, phases: Iterable[PhaseState]) -> None:
        if self._live:
            return
        # private copies: callers may keep mutating their PhaseState objects
        self._table = {p.key: replace(p) for p in phases}
        self._sum_total = sum(p.total for p in self._table.values())
        self._sum_done = 0.0
        self._cancelled = self._cancel_sent = False
        self._sink.start(self._table.values(), overall_total=self._sum_total)
        self._live = True

    def advance(self, key: str, amount: float) -> None:
        with self._lock:
            if not self._live or self._cancelled or amount <= 0:
                return
            phase = self._table.get(key)
            if phase is None:
                return
            before = phase.completed
            phase.completed = min(before + amount, phase.total)
            clamped = phase.completed - before
            if clamped <= 0:
                return
            self._sum_done = min(self._sum_done + clamped, self._sum_total)
            self._sink.advance(
                phase,
                clamped,
                overall_completed=self._sum_done,
                overall_total=max(self._sum_total, 1e-9),
            )

    def status(self, message: str) -> None:
        with self._lock:
            if self._live:
                self._sink.status(_squash_status(message))

    def cancel(self) -> None:
        if self._cancelled:
            return
        self._cancelled = True
        if self._cancel_sent:
            return
        try:
            self._sink.cancel()
        except NotImplementedError:
            pass
        finally:
            self._cancel_sent = True

    def close(self) -> None:
        self._sink.close()
        self._live = False
        self._cancelled = self._cancel_sent = False
