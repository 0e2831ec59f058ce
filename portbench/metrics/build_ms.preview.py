"""Median over the window's jobs of the self time of
``iq2a.setup.build``: filter design, plans, checkpoint handling, writer
open, decoder set-up, kernel pack and the chunk step's build."""

from portbench.harness.spans import per_job_ms


def read(run):
    return per_job_ms(run, "iq2a.setup.build")
