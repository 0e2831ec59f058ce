"""Median over the window's jobs of the self time of ``iq2a.flush``:
after the chunk loop, the decoder's finalize and every writer's close."""

from portbench.harness.spans import per_job_ms


def read(run):
    return per_job_ms(run, "iq2a.flush")
