"""Share of the dispatch groups that the read-ahead worker had filled
before the chunk loop asked for them, in %: 100 x Σ ``ahead_ready`` over
Σ ``ahead_groups`` (one of each per ``iq2a.take`` span, on the loop's
thread).  The first group of each job is filled on the loop's thread and
is not counted.  A program without the counters gives None."""

from portbench.harness.spans import counter_ratio


def read(run):
    share = counter_ratio(run, "ahead_ready", "ahead_groups")
    return None if share is None else 100.0 * share
