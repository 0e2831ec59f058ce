"""Host milliseconds per chunk step blocked on the device: Σ ``iq2a.wait``
(a pinned slot whose copy has not finished) over Σ ``chunks``."""

from portbench.harness.spans import per_chunk_ms


def read(run):
    return per_chunk_ms(run, "iq2a.wait", own=False)
