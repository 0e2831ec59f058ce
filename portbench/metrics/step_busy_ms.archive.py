"""Device-busy milliseconds (the union of device intervals in the traced
window) per chunk step dispatched."""


def read(run):
    t = run.trace
    chunks = sum(j.dispatched_chunks for j in run.jobs)
    if t is None or chunks == 0 or t.busy_s <= 0:
        return None
    return 1e3 * t.busy_s / chunks
