"""Median over the window's jobs of ``iq2a.alloc``: the device
accumulators and the pinned upload and download rings, allocated per job
inside the chunk loop."""

from portbench.harness.spans import per_job_ms


def read(run):
    return per_job_ms(run, "iq2a.alloc", own=False)
