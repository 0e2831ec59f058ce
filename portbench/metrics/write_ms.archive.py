"""Host milliseconds per chunk step writing audio: Σ self time of
``iq2a.write`` (every writer call, the end-of-file flush included) over
Σ ``chunks``."""

from portbench.harness.spans import per_chunk_ms


def read(run):
    return per_chunk_ms(run, "iq2a.write")
