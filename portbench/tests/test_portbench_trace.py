"""The traced run's arithmetic on synthetic intervals: the union of device
time, the idle gaps and their host labels, and the readers built on them."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import tracing
from portbench.harness.tracing import Event

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(name, METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize(
    "intervals, merged",
    [
        ([], []),
        ([(0, 10)], [(0, 10)]),
        ([(5, 10), (0, 3)], [(0, 3), (5, 10)]),
        ([(0, 10), (2, 4), (9, 12)], [(0, 12)]),
        ([(0, 5), (5, 8)], [(0, 8)]),
        ([(3, 4), (1, 2), (0, 6), (7, 9)], [(0, 6), (7, 9)]),
    ],
)
def test_merge(intervals, merged):
    assert tracing.merge(intervals) == merged


@pytest.mark.parametrize(
    "busy, lo, hi, gaps",
    [
        ([], 0, 10, [(0, 10)]),
        ([(0, 10)], 0, 10, []),
        ([(2, 4), (6, 7)], 0, 10, [(0, 2), (4, 6), (7, 10)]),
        ([(0, 3), (8, 20)], 1, 12, [(3, 8)]),
    ],
)
def test_gaps(busy, lo, hi, gaps):
    assert tracing.gaps_in(busy, lo, hi) == gaps


def test_innermost_label():
    host = [Event("aten::a", False, 0, 100), Event("aten::b", False, 10, 50), Event("cudaMemcpyAsync", False, 20, 30)]
    assert tracing.innermost(host, [5, 25, 40, 60, 150]) == [
        "aten::a", "cudaMemcpyAsync", "aten::b", "aten::a", "no host op",
    ]


def synthetic():
    ms = 1_000_000
    ev = [
        Event(tracing.WINDOW_SPAN, False, 0, 100 * ms, thread=1),
        Event(tracing.WINDOW_SPAN, True, 0, 100 * ms, annotation=True),
        Event("poly_fir_kernel", True, 10 * ms, 12 * ms),
        Event("poly_fir_kernel", True, 40 * ms, 42 * ms),
        Event("Memcpy HtoD (Pinned -> Device)", True, 11 * ms, 20 * ms),
        Event("Event Sync", True, 50 * ms, 60 * ms),
        Event("aten::copy_", False, 5 * ms, 30 * ms, thread=1),
        Event("cudaStreamSynchronize", False, 60 * ms, 95 * ms, thread=1),
        Event("aten::other_thread", False, 0, 100 * ms, thread=2),
    ]
    return tracing.analyse(ev)


def test_analyse():
    t = synthetic()
    assert t.window_s == pytest.approx(0.1)
    assert t.busy_s == pytest.approx(0.012)  # 10-20 ms and 40-42 ms
    assert t.ops["poly_fir_kernel"] == [2, pytest.approx(0.004)]
    assert "Event Sync" not in t.ops and tracing.WINDOW_SPAN not in t.ops
    # gaps 0-10 (copy_), 20-40 (mid 30: copy_ ends at 30, so none), 42-100 (mid 71: sync)
    assert t.gaps["aten::copy_"] == [1, pytest.approx(0.010)]
    assert t.gaps["no host op"] == [1, pytest.approx(0.020)]
    assert t.gaps["cudaStreamSynchronize"] == [1, pytest.approx(0.058)]
    b = t.breakdown()
    assert b["device_ops"][0][0].startswith("Memcpy") and len(b["idle_gaps"]) == 3
    assert tracing.kernel_seconds(t, ("poly_fir_kernel",)) == (2, pytest.approx(0.004))


def test_idle_and_busy_readers():
    t = synthetic()
    jobs = [SimpleNamespace(dispatched_chunks=3), SimpleNamespace(dispatched_chunks=1)]
    run = SimpleNamespace(trace=t, jobs=jobs)
    assert reader("device_idle.archive")(run) == pytest.approx(88.0)
    assert reader("device_idle.preview")(run) == pytest.approx(88.0)
    assert reader("step_busy_ms.archive")(run) == pytest.approx(3.0)
    assert reader("device_idle.archive")(SimpleNamespace(trace=None, jobs=jobs)) is None


def test_missing_window_raises():
    with pytest.raises(RuntimeError):
        tracing.analyse([Event("poly_fir_kernel", True, 0, 1)])
