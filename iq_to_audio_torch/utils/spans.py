"""Named spans and counters of the port, on the profiler's clock.

A span is recorded only while ``torch.profiler`` records
(``torch.autograd._profiler_enabled()``); there is no other switch.  Off,
:func:`span` returns one shared null context and :func:`count` returns at
once, so instrumented code pays one check per span.  On, a span enters
``torch.profiler.record_function(name)``, so it lands in the profiler's
trace beside the device's kernels and copies, and appends a :class:`Record`
to an in-process list that :func:`records` returns until :func:`reset`.

Parents come from a stack per thread.  The root span ``iq2a.job`` (the
:func:`job` decorator) takes a process-wide sequence number, the job id,
which every span nested under it on the same thread carries; a span opened
outside any job has job id ``None``.

The profiler records on the thread that started it.  A worker thread that
works for a job takes up that thread's state with :func:`carry` (on the
job's thread) and :func:`adopt` (on the worker): its spans then record
while the job's thread recorded when the worker started, and carry the
job's id.  They are roots on the worker's own stack.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field

import torch

JOB = "iq2a.job"

_OFF = contextlib.nullcontext()
_enabled = torch.autograd._profiler_enabled
_lock = threading.Lock()
_local = threading.local()
_records: list[Record] = []
_job_ids = itertools.count()


@dataclass(slots=True)
class Record:
    name: str
    #: ``time.perf_counter_ns()`` at entry and exit (0 while open)
    start_ns: int
    end_ns: int
    #: index in :func:`records` of the enclosing span on this thread
    parent: int | None
    job: int | None
    thread: int
    counters: dict[str, int] = field(default_factory=dict)


def _stack() -> list[tuple[int, Record]]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("_name", "_new_job", "_fn", "_rec")

    def __init__(self, name: str, new_job: bool = False):
        self._name = name
        self._new_job = new_job

    def __enter__(self) -> _Span:
        self._fn = torch.profiler.record_function(self._name)
        self._fn.__enter__()
        stack = _stack()
        parent, up = stack[-1] if stack else (None, None)
        with _lock:
            if self._new_job:
                job_id = next(_job_ids)
            else:
                job_id = up.job if up else getattr(_local, "job", None)
            index = len(_records)
            self._rec = Record(
                self._name, time.perf_counter_ns(), 0, parent, job_id, threading.get_ident()
            )
            _records.append(self._rec)
        stack.append((index, self._rec))
        return self

    def __exit__(self, *exc) -> None:
        self._rec.end_ns = time.perf_counter_ns()
        _stack().pop()
        self._fn.__exit__(*exc)


def _recording() -> bool:
    return _enabled() or getattr(_local, "on", False)


def span(name: str):
    """A context manager that records ``name`` while the profiler records."""
    if not _recording():
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span on this
    thread (nothing outside a span, or while the profiler is off)."""
    if not _recording():
        return
    stack = _stack()
    if stack:
        counters = stack[-1][1].counters
        counters[name] = counters.get(name, 0) + n


def job(fn):
    """Decorator: each call of ``fn`` is one job, the root span ``iq2a.job``,
    unless a job is already open on this thread (a run inside a preview)."""

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if not _enabled():
            return fn(*args, **kwargs)
        stack = _stack()
        if stack and stack[-1][1].job is not None:
            return fn(*args, **kwargs)
        with _Span(JOB, new_job=True):
            return fn(*args, **kwargs)

    return call


def carry() -> tuple[bool, int | None]:
    """This thread's recording state, for a worker thread to :func:`adopt`:
    whether its spans record, and the id of its innermost open job."""
    if not _enabled():
        return False, None
    stack = _stack()
    return True, stack[-1][1].job if stack else None


def adopt(carried: tuple[bool, int | None]) -> None:
    """On a worker thread, record as :func:`carry`'s thread did when it was
    called: spans record (or not) whatever the profiler does on this
    thread, and spans opened with no parent carry that thread's job id."""
    _local.on, _local.job = carried


def records() -> list[Record]:
    """Every record since the last :func:`reset`, in order of entry."""
    with _lock:
        return list(_records)


def reset() -> None:
    """Forget every record (call with no span open)."""
    with _lock:
        _records.clear()


def self_ns(recs: list[Record]) -> list[int]:
    """Each record's self time: its duration less its children's (a span's
    children run on its thread, one after another)."""
    own = [r.end_ns - r.start_ns for r in recs]
    for r in recs:
        if r.parent is not None:
            own[r.parent] -= r.end_ns - r.start_ns
    return own
