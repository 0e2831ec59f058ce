"""Host milliseconds per chunk step enqueueing it: Σ self time of
``iq2a.step`` (the call of the compiled chunk step, which queues its
kernels) over Σ ``chunks``."""

from portbench.harness.spans import per_chunk_ms


def read(run):
    return per_chunk_ms(run, "iq2a.step")
