"""The traced run's reading of an in-memory ``torch.profiler`` trace.

Device time is the union of every device interval (kernels, copies, sets)
inside the window, the span the harness records around its jobs.  Idle gaps
are the window's stretches outside that union, each labelled with the
innermost host operation in flight on the harness's thread at the gap's
middle (an ``aten::`` op or a CUDA runtime call), or ``no host op``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

WINDOW_SPAN = "portbench.window"
JOB_SPAN = "portbench.job"
#: device rows that are no device work: annotations and synchronisation
_NOT_WORK = ("Sync", "portbench.")


@dataclass
class Event:
    name: str
    device: bool
    start_ns: int
    end_ns: int
    thread: int = 0
    annotation: bool = False


@dataclass
class Trace:
    window_s: float
    busy_s: float
    #: kernel name -> [launches, device seconds]
    ops: dict = field(default_factory=dict)
    #: host label -> [gaps, seconds]
    gaps: dict = field(default_factory=dict)
    n_events: int = 0

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1][1])[:top]
        return {
            "device_ops": [[name[:160], v[1]] for name, v in ops],
            "idle_gaps": [[name[:160], v[1]] for name, v in gaps],
        }


def events_of(prof) -> list[Event]:
    """The profiler's raw Kineto events, without building its
    ``FunctionEvent`` tree (which takes minutes over a window of hundreds of
    thousands of ops)."""
    return [
        Event(
            e.name(), "CUDA" in str(e.device_type()), e.start_ns(), e.end_ns(),
            e.start_thread_id(), e.is_user_annotation(),
        )
        for e in prof.profiler.kineto_results.events()
    ]


def merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def gaps_in(busy: list[tuple[int, int]], lo: int, hi: int) -> list[tuple[int, int]]:
    """Stretches of ``[lo, hi)`` outside the merged, sorted ``busy``."""
    out, cur = [], lo
    for s, e in busy:
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def innermost(host: list[Event], times: list[int]) -> list[str]:
    """For each of the sorted ``times``, the name of the innermost ``host``
    event (properly nested, one thread) that contains it."""
    host = sorted(host, key=lambda e: (e.start_ns, -e.end_ns))
    labels, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i].start_ns <= t:
            ev = host[i]
            while stack and stack[-1].end_ns <= ev.start_ns:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1].end_ns <= t:
            stack.pop()
        labels.append(stack[-1].name if stack else "no host op")
    return labels


def analyse(events: list[Event]) -> Trace:
    windows = [e for e in events if not e.device and e.name == WINDOW_SPAN]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    win = windows[0]
    lo, hi = win.start_ns, win.end_ns
    dev = [
        e for e in events
        if e.device and not e.annotation and not any(t in e.name for t in _NOT_WORK)
        and e.end_ns > lo and e.start_ns < hi
    ]
    busy = merge([(max(e.start_ns, lo), min(e.end_ns, hi)) for e in dev])
    ops: dict = defaultdict(lambda: [0, 0.0])
    for e in dev:
        ops[e.name][0] += 1
        ops[e.name][1] += (e.end_ns - e.start_ns) * 1e-9
    host = [
        e for e in events
        if not e.device and e.thread == win.thread and not e.name.startswith("portbench.")
        and e.end_ns > lo and e.start_ns < hi
    ]
    gap_list = gaps_in(busy, lo, hi)
    mids = [(s + e) // 2 for s, e in gap_list]
    gaps: dict = defaultdict(lambda: [0, 0.0])
    for (s, e), label in zip(gap_list, innermost(host, mids)):
        gaps[label][0] += 1
        gaps[label][1] += (e - s) * 1e-9
    return Trace(
        window_s=(hi - lo) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        ops=dict(ops), gaps=dict(gaps), n_events=len(events),
    )


def kernel_seconds(trace: Trace, names: tuple[str, ...]) -> tuple[int, float]:
    """Launches and device seconds of the kernels whose name contains any
    of ``names``."""
    n, s = 0, 0.0
    for name, (count, secs) in trace.ops.items():
        if any(k in name for k in names):
            n += count
            s += secs
    return n, s


__all__ = ["Event", "Trace", "analyse", "events_of", "gaps_in", "innermost", "kernel_seconds", "merge"]


def idle_percent(trace: Trace | None) -> float | None:
    """Share of the traced window in which nothing ran on the device."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
