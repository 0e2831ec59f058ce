"""Host milliseconds per chunk step staging input: Σ self time of
``iq2a.stage`` (filling a pinned upload slot and issuing its host-to-device
copy; a wait for the slot is ``wait_ms``) over Σ ``chunks``."""

from portbench.harness.spans import per_chunk_ms


def read(run):
    return per_chunk_ms(run, "iq2a.stage")
