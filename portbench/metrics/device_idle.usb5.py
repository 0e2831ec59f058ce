"""Share of the SSB cell's traced window in which nothing ran on the device:
the reader of ``device_idle.archive``, loaded from its file, over this
cell's run."""

from portbench.harness.spec import BENCH_DIR, _load_module


def read(run):
    return _load_module(BENCH_DIR / "metrics" / "device_idle.archive.py", "device_idle.archive").read(run)
