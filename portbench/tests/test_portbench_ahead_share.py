"""``ahead_share.archive``, the share of the dispatch groups that the
read-ahead worker had filled before the chunk loop asked for them: on
hand-built records, in one traced window and after another, and against a
program without the counters."""

import sys
from types import SimpleNamespace

import pytest

MS = 1_000_000
NAME = "ahead_share.archive"


def records(earlier=False, counted=True):
    """One job of four groups: the first filled on the loop's thread, the
    other three by the worker, two of them ready when taken; with
    ``earlier`` one more job in the traced window of a cell run before in
    the same process, none of whose groups was ready."""
    from iq_to_audio_torch.utils.spans import Record

    rows = []

    def job(t, job_id, ready):
        base = len(rows)

        def add(name, start, end, parent=None, thread=1, **counters):
            rows.append(Record(
                name, int((t + start) * MS), int((t + end) * MS),
                None if parent is None else base + parent, job_id, thread, counters,
            ))

        add("iq2a.job", 0, 100)                                          # 0
        add("iq2a.loop", 10, 90, 0)                                      # 1
        add("iq2a.stage", 11, 15, 1, h2d_bytes=120, input_bytes=100)     # 2
        add("iq2a.read", 12, 14, 2, direct_bytes=50)                     # 3
        add("iq2a.step", 15, 20, 1, chunks=2)                            # 4
        for k, r in enumerate(ready):
            at = 20 + 15 * k
            stage = len(rows) - base
            add("iq2a.stage", at, at + 5, 1, h2d_bytes=120, input_bytes=100)
            extra = {"ahead_groups": 1, "ahead_ready": r} if counted else {}
            add("iq2a.take", at + 1, at + 4, stage, **extra)
            add("iq2a.step", at + 5, at + 10, 1, chunks=2)
            fill = len(rows) - base
            add("iq2a.fill", at - 12, at - 2, None, thread=2)
            add("iq2a.read", at - 11, at - 3, fill, thread=2, direct_bytes=100)

    if earlier:
        job(-10_000, 3, [0, 0, 0, 0])
    job(0, 5, [1, 0, 1])
    return rows


def run_of():
    return SimpleNamespace(trace=None, jobs=[], window_s=2.0)


@pytest.mark.parametrize("earlier", [False, True], ids=["one window", "after another window"])
def test_ahead_share_on_hand_built_records(bench, monkeypatch, earlier):
    from iq_to_audio_torch.utils import spans

    rows = records(earlier)
    monkeypatch.setattr(spans, "records", lambda: list(rows))
    # the earlier window's groups are left out: 2 of 3
    assert bench.metric(NAME).read(run_of()) == pytest.approx(200.0 / 3.0)


def test_ahead_share_reads_zero_when_no_group_was_ready(bench, monkeypatch):
    from iq_to_audio_torch.utils import spans

    rows = [r for r in records(True) if r.job == 3]
    monkeypatch.setattr(spans, "records", lambda: list(rows))
    assert bench.metric(NAME).read(run_of()) == 0.0


@pytest.mark.parametrize("nothing", ["no counters", "no records", "no spans module"])
def test_ahead_share_reads_none_without_its_counters(bench, monkeypatch, nothing):
    """A program older than the read-ahead worker takes no groups; one older
    than its spans has no records or no module."""
    from iq_to_audio_torch.utils import spans

    if nothing == "no counters":
        rows = records(counted=False)
        monkeypatch.setattr(spans, "records", lambda: list(rows))
        assert bench.metric("read_ms.archive").read(run_of()) is not None
    elif nothing == "no records":
        monkeypatch.setattr(spans, "records", lambda: [])
    else:
        monkeypatch.setitem(sys.modules, "iq_to_audio_torch.utils.spans", None)
    assert bench.metric(NAME).read(run_of()) is None
