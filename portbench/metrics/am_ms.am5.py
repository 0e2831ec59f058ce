"""Host milliseconds per chunk step enqueueing the AM chain (envelope, DC
blocker): Σ self time of ``iq2a.am`` over Σ ``chunks``.  None where the
window holds no such span (a program without it)."""

from portbench.harness.spans import _records, per_chunk_ms

NAME = "iq2a.am"


def read(run):
    got = _records(run)
    if got is None or not any(r.name == NAME for r in got[0]):
        return None
    return per_chunk_ms(run, NAME)
