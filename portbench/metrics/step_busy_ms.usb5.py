"""Device-busy milliseconds per chunk step in the SSB cell, the SSB chain's
DC blocker and AGC and the channelizer at K = 275 included: the reader of
``step_busy_ms.archive``, loaded from its file, over this cell's run."""

from portbench.harness.spec import BENCH_DIR, _load_module


def read(run):
    return _load_module(BENCH_DIR / "metrics" / "step_busy_ms.archive.py", "step_busy_ms.archive").read(run)
