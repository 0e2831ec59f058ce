"""Median over the window's jobs of the time outside the chunk loop (job
wall minus ``ProcessingResult.loop_seconds``)."""

import statistics


def read(run):
    if not run.jobs:
        return None
    return statistics.median((j.wall_s - j.loop_s) * 1e3 for j in run.jobs)
