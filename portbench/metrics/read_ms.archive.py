"""Host milliseconds per chunk step reading the capture: Σ self time of
the program's ``iq2a.read`` spans (the set-up's first block included) over
Σ ``chunks``."""

from portbench.harness.spans import per_chunk_ms


def read(run):
    return per_chunk_ms(run, "iq2a.read")
