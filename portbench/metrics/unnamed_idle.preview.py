"""Share of the traced window in which the device idled while the job's
thread ran code that no span of the program's and no torch op names: the
job's and the chunk loop's own code between their spans, and the harness's
between jobs (the reading is shared by the cells' unnamed-idle metrics)."""

from portbench.harness.spans import unnamed_idle_percent


def read(run):
    return unnamed_idle_percent(run.trace)
