"""The channelizer kernel's share of its roofline in the airband cell (20
MS/s, D = 208, K = 62 taps per phase, five channels, 20,000 output rows a
chunk): the reader of ``chan_roofline.archive``, loaded from its file, over
this cell's run."""

from portbench.harness.spec import BENCH_DIR, _load_module


def read(run):
    return _load_module(BENCH_DIR / "metrics" / "chan_roofline.archive.py", "chan_roofline.archive").read(run)
