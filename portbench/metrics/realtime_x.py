"""Capture seconds of every job completed in the window (once per job,
whatever its channels) over the window's wall seconds."""


def read(run):
    if not run.jobs:
        return None
    return sum(j.capture_s for j in run.jobs) / run.window_s
