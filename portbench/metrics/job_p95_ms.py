"""95th percentile of every job's wall time in the window, call to return
with its WAV closed."""

import statistics


def read(run):
    walls = [j.wall_s * 1e3 for j in run.jobs]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=20, method="inclusive")[18]
