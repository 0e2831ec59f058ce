"""The traced run's reading of the program's own spans and counters
(``iq_to_audio_torch.utils.spans``).

The program records a span only while the profiler records, and the
warm-up job runs before the profiler starts, so the window's records are
the last ones in the process.  One process may hold several traced windows
(the tests run one cell after another), so a reader keeps the records that
start within ``window_s`` of the last record's end: the window lasted
``window_s`` and ended with its last job, and a warm-up job and a capture
lie between it and any earlier window.  A program without that module, or
a run that recorded nothing, gives None.  A span's self time is its
duration less its child spans'.
"""

from __future__ import annotations

import statistics

NS_PER_MS = 1e6
#: idle gaps under these labels have no span of their own: the harness's
#: code between jobs, and the job's and loop's own code between their spans
UNNAMED = ("no host op", "iq2a.job", "iq2a.loop")


def _records(run):
    """(records, self times in ns) of the run's traced window, or None."""
    try:
        from iq_to_audio_torch.utils import spans
    except ImportError:
        return None
    recs = spans.records()
    if not recs:
        return None
    own = spans.self_ns(recs)
    since = max(r.end_ns for r in recs) - int(run.window_s * 1e9)
    kept = [(r, s) for r, s in zip(recs, own) if r.start_ns >= since]
    return [r for r, _ in kept], [s for _, s in kept]


def per_chunk_ms(run, name: str, own: bool = True) -> float | None:
    """Σ self time (or, with ``own=False``, duration) of the spans called
    ``name``, over Σ of the ``chunks`` counter: ms per chunk step."""
    got = _records(run)
    if got is None:
        return None
    recs, self_ns = got
    chunks = sum(r.counters.get("chunks", 0) for r in recs)
    if chunks == 0:
        return None
    total = sum(
        s if own else r.end_ns - r.start_ns for r, s in zip(recs, self_ns) if r.name == name
    )
    return total / NS_PER_MS / chunks


def per_job_ms(run, name: str, own: bool = True) -> float | None:
    """Median over the jobs (root spans ``iq2a.job``) of the Σ self time
    (or duration) of each job's spans called ``name``."""
    got = _records(run)
    if got is None:
        return None
    recs, self_ns = got
    jobs = {r.job: 0 for r in recs if r.name == "iq2a.job"}
    if not jobs:
        return None
    for r, s in zip(recs, self_ns):
        if r.name == name and r.job in jobs:
            jobs[r.job] += s if own else r.end_ns - r.start_ns
    return statistics.median(jobs.values()) / NS_PER_MS


def counter_ratio(run, num: str, den: str) -> float | None:
    """Σ counter ``num`` over Σ counter ``den``, over every span."""
    got = _records(run)
    if got is None:
        return None
    recs, _ = got
    d = sum(r.counters.get(den, 0) for r in recs)
    if d == 0:
        return None
    return sum(r.counters.get(num, 0) for r in recs) / d


def unnamed_idle_percent(trace) -> float | None:
    """Device-idle time that no span of the program's and no torch op
    names (the gaps labelled with one of ``UNNAMED``), as a share of the
    traced window."""
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * sum(trace.gaps.get(k, (0, 0.0))[1] for k in UNNAMED) / trace.window_s
