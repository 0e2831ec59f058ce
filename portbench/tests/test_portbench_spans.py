"""The readers of the program's spans and counters, on hand-built records
and a hand-built trace, and in a traced run of each cell on the CPU."""

import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import runner, tracing
from portbench.harness.spec import Bench

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000


def records(earlier=False):
    """Two jobs, and with ``earlier`` one more in the traced window of a cell
    run before in the same process.  Each row: name, start and end (ms),
    parent row, counters."""
    from iq_to_audio_torch.utils.spans import Record

    rows = []

    def job(t, job_id, scale):
        base = len(rows)

        def add(name, start, end, parent=None, **counters):
            rows.append(Record(
                name, int((t + start) * MS), int((t + end) * MS),
                None if parent is None else base + parent, job_id, 1, counters,
            ))

        add("iq2a.job", 0, 100)                                     # 0
        add("iq2a.setup.probe", 0, 2 * scale, 0)                    # 1
        add("iq2a.setup.probe", 2 * scale, 3 * scale, 0)            # 2
        add("iq2a.setup.mix_sign", 3 * scale, 13 * scale, 0)        # 3
        add("iq2a.read", 3 * scale, 5 * scale, 3)                   # 4
        add("iq2a.setup.build", 13 * scale, 20 * scale, 0)          # 5
        add("iq2a.loop", 20 * scale, 60, 0)                         # 6
        add("iq2a.alloc", 20 * scale, 20.5 * scale, 6)              # 7
        add("iq2a.read", 41, 43, 6)                                 # 8
        add("iq2a.stage", 43, 47, 6, h2d_bytes=80, input_bytes=50)  # 9
        add("iq2a.wait", 44, 45, 9)                                 # 10
        add("iq2a.step", 47, 50, 6, chunks=2)                       # 11
        add("iq2a.fetch", 50, 51, 6)                                # 12
        add("iq2a.drain", 51, 58, 6)                                # 13
        add("iq2a.wait", 51, 52, 13)                                # 14
        add("iq2a.write", 52, 55, 13)                               # 15
        add("iq2a.write", 55, 56, 13)                               # 16
        add("iq2a.flush", 60, 60 + 4 * scale, 0)                    # 17

    if earlier:
        job(-10_000, 3, 1)
        rows[9].counters["h2d_bytes"] = 500
    job(0, 5, 1)
    job(1000, 6, 2)
    return rows


# per chunk: Σ over both jobs / 4 chunks; per job: the median of two jobs is their mean
EXPECTED = {
    "read_ms.archive": (2 + 2 + 2 + 4) / 4,
    "stage_ms.archive": (3 + 3) / 4,
    "enqueue_ms.archive": (3 + 3) / 4,
    "wait_ms.archive": (2 + 2) / 4,
    "write_ms.archive": (4 + 4) / 4,
    "probe_ms.preview": (3 + 6) / 2,
    "mixsign_ms.preview": (8 + 16) / 2,
    "build_ms.preview": (7 + 14) / 2,
    "alloc_ms.preview": (0.5 + 1) / 2,
    "flush_ms.preview": (4 + 8) / 2,
    "upload_ratio.preview": 160 / 100,
}
IDLE = ("unnamed_idle.archive", "unnamed_idle.preview")


@pytest.fixture(params=[False, True], ids=["one window", "after another window"])
def recorded(monkeypatch, request):
    from iq_to_audio_torch.utils import spans

    rows = records(request.param)
    monkeypatch.setattr(spans, "records", lambda: list(rows))
    return rows


def trace(gaps):
    return tracing.Trace(window_s=2.0, busy_s=0.1, gaps=gaps)


def run_of(gaps):
    return SimpleNamespace(trace=trace(gaps), jobs=[], window_s=2.0)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_span_reader_on_hand_built_records(bench, recorded, name):
    assert bench.metric(name).read(run_of({})) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", IDLE)
@pytest.mark.parametrize(
    "gaps, share",
    [
        ({"no host op": [3, 0.05], "iq2a.read": [2, 1.2]}, 2.5),
        ({"iq2a.job": [1, 0.02], "iq2a.loop": [4, 0.03], "iq2a.stage": [2, 0.5]}, 2.5),
        ({"no host op": [1, 0.01], "iq2a.job": [1, 0.02], "iq2a.loop": [4, 0.07]}, 5.0),
        ({"iq2a.read": [2, 1.2], "aten::mul": [1, 0.3]}, 0.0),
    ],
)
def test_unnamed_idle_reader_on_a_hand_built_trace(bench, name, gaps, share):
    assert bench.metric(name).read(run_of(gaps)) == pytest.approx(share)
    assert bench.metric(name).read(SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
@pytest.mark.parametrize("nothing", ["no records", "no spans module"])
def test_span_reader_without_records_reads_none(bench, monkeypatch, name, nothing):
    from iq_to_audio_torch.utils import spans

    if nothing == "no records":
        monkeypatch.setattr(spans, "records", lambda: [])
    else:  # a program older than its spans
        monkeypatch.setitem(sys.modules, "iq_to_audio_torch.utils.spans", None)
    assert bench.metric(name).read(run_of({})) is None


@pytest.mark.parametrize("cell", ["nfm5.archive", "nfm1.preview"])
def test_a_traced_cpu_run_reports_every_new_metric(conv_channelizer, cell):
    from iq_to_audio_torch.utils import spans

    bench = Bench(ROOT)
    spans.reset()
    try:
        result = runner.run_cell(
            bench, cell, 2**31 + 41, 0.05, True, device="cpu", capture_seconds=0.6
        )
    finally:
        n_records = len(spans.records())
        spans.reset()
    assert result["correct"] and n_records > 0
    mine = [n for n in list(EXPECTED) + list(IDLE) if n.endswith(cell.split(".")[1])]
    assert len(mine) == {"nfm5.archive": 6, "nfm1.preview": 7}[cell]
    for name in mine:
        assert name in result["metrics"], name
        assert result["metrics"][name]["value"] >= 0
    # the device's readers find no device on the CPU; nothing else is left out
    assert set(result["metrics"]) <= {m["name"] for m in bench.cell(cell).per_layer}
