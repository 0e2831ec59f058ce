"""Per-capture set-up and flush (``ProcessingPipeline.run`` outside
``_ChunkLoop.run``: probe, filter design, mixer-sign probe, step build,
writer close) as a share of the jobs' wall time."""


def read(run):
    wall = sum(j.wall_s for j in run.jobs)
    if wall <= 0:
        return None
    return 100.0 * sum(j.wall_s - j.loop_s for j in run.jobs) / wall
