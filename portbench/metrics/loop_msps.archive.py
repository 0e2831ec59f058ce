"""Input samples the chunk loops consumed per second of chunk loop (host
clock around ``_ChunkLoop.run``), in millions."""


def read(run):
    loop = sum(j.loop_s for j in run.jobs)
    if loop <= 0:
        return None
    return sum(j.input_samples for j in run.jobs) / loop / 1e6
