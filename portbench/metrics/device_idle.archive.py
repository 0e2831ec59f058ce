"""Share of the traced window in which no kernel, copy or set ran on the
device (the reading is shared by the cells' idle metrics)."""

from portbench.harness.tracing import idle_percent


def read(run):
    return idle_percent(run.trace)
