"""Host milliseconds per chunk step enqueueing it in the SSB cell, Σ self
time of ``iq2a.step`` over Σ ``chunks``: the SSB chain's span
``iq2a.ssb`` is its child, read by ``ssb_ms.usb5``, and not counted here.
The reader of ``enqueue_ms.archive``, loaded from its file, over this
cell's run."""

from portbench.harness.spec import BENCH_DIR, _load_module


def read(run):
    return _load_module(BENCH_DIR / "metrics" / "enqueue_ms.archive.py", "enqueue_ms.archive").read(run)
