"""``direct_share.archive``, the share of the capture bytes that the chunk
loop read straight into a pinned upload slot: on hand-built records, against
a program without the counter, and in a traced run of its cell on the CPU."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import runner
from portbench.harness.spec import Bench

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000
NAME = "direct_share.archive"


def records(earlier=False, direct=True):
    """One job of three loop blocks, the first copied in from the warm-up's
    read and the other two read in place; with ``earlier`` one more job in
    the traced window of a cell run before in the same process, all of whose
    bytes were read in place."""
    from iq_to_audio_torch.utils.spans import Record

    rows = []

    def job(t, job_id, direct_bytes):
        base = len(rows)

        def add(name, start, end, parent=None, **counters):
            rows.append(Record(
                name, int((t + start) * MS), int((t + end) * MS),
                None if parent is None else base + parent, job_id, 1, counters,
            ))

        add("iq2a.job", 0, 100)                                        # 0
        add("iq2a.setup.mix_sign", 1, 10, 0)                           # 1
        add("iq2a.read", 2, 4, 1)                                      # 2
        add("iq2a.loop", 20, 90, 0)                                    # 3
        add("iq2a.stage", 21, 40, 3, h2d_bytes=120, input_bytes=100)   # 4
        for k, n in enumerate(direct_bytes):
            extra = {"direct_bytes": n} if direct else {}
            add("iq2a.read", 22 + 4 * k, 25 + 4 * k, 4, **extra)
        add("iq2a.pad", 34, 35, 4)
        add("iq2a.step", 40, 45, 3, chunks=3)

    if earlier:
        job(-10_000, 3, [50, 40, 30])
    job(0, 5, [40, 25])
    return rows


def run_of():
    return SimpleNamespace(trace=None, jobs=[], window_s=2.0)


@pytest.mark.parametrize("earlier", [False, True], ids=["one window", "after another window"])
def test_direct_share_on_hand_built_records(bench, monkeypatch, earlier):
    from iq_to_audio_torch.utils import spans

    rows = records(earlier)
    monkeypatch.setattr(spans, "records", lambda: list(rows))
    # the earlier window's bytes are left out: (40 + 25) of 100
    assert bench.metric(NAME).read(run_of()) == pytest.approx(65.0)


@pytest.mark.parametrize("nothing", ["no direct_bytes", "no records", "no spans module"])
def test_direct_share_reads_none_without_its_counter(bench, monkeypatch, nothing):
    """A program older than the counter counts input bytes and no direct
    ones; one older than its spans has no records or no module."""
    from iq_to_audio_torch.utils import spans

    if nothing == "no direct_bytes":
        rows = records(direct=False)
        monkeypatch.setattr(spans, "records", lambda: list(rows))
        assert bench.metric("upload_ratio.preview").read(run_of()) == pytest.approx(1.2)
    elif nothing == "no records":
        monkeypatch.setattr(spans, "records", lambda: [])
    else:
        monkeypatch.setitem(sys.modules, "iq_to_audio_torch.utils.spans", None)
    assert bench.metric(NAME).read(run_of()) is None


def test_a_traced_cpu_run_reports_direct_share(conv_channelizer):
    from iq_to_audio_torch.utils import spans

    bench = Bench(ROOT)
    assert NAME in {m["name"] for m in bench.cell("nfm5.archive").per_layer}
    spans.reset()
    try:
        result = runner.run_cell(
            bench, "nfm5.archive", 2**31 + 43, 0.05, True, device="cpu", capture_seconds=0.6
        )
    finally:
        recs = spans.records()
        spans.reset()
    assert result["correct"] and recs
    # every loop block but the warm-up's first is read in place
    direct = sum(r.counters.get("direct_bytes", 0) for r in recs)
    used = sum(r.counters.get("input_bytes", 0) for r in recs)
    assert 0 < direct < used
    assert 0 < result["metrics"][NAME]["value"] < 100
