"""Median over the window's jobs of Σ ``iq2a.setup.probe``: the input's
format, sample rate and centre frequency, and the reader's open."""

from portbench.harness.spans import per_job_ms


def read(run):
    return per_job_ms(run, "iq2a.setup.probe", own=False)
