"""Median over the window's jobs of the self time of
``iq2a.setup.mix_sign``: the float64 mixer-sign probe on the first block
(the block's read, an ``iq2a.read`` inside it, is left out)."""

from portbench.harness.spans import per_job_ms


def read(run):
    return per_job_ms(run, "iq2a.setup.mix_sign")
