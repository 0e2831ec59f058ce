"""The port's spans and counters (``iq_to_audio_torch/utils/spans.py``):
off unless the profiler records, and where they land in a pipeline run."""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import make_nfm_iq

import iq_to_audio_torch as tpkg
from iq_to_audio_torch.io.reader import IQReader
from iq_to_audio_torch.io.writer import write_stereo_wav
from iq_to_audio_torch.pipeline.pipeline import _PinnedRing
from iq_to_audio_torch.pipeline.preview import run_preview
from iq_to_audio_torch.utils import spans
from iq_to_audio_torch.utils.spans import Record

torch.set_num_threads(1)

FS = 250_000.0
CENTER = 145_000_000.0


@pytest.fixture(autouse=True)
def empty():
    spans.reset()
    yield
    spans.reset()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)

    @spans.job
    def work():
        with spans.span("iq2a.read"):
            spans.count("chunks", 10)
        return 7

    assert spans.span("a") is spans.span("b")
    assert work() == 7
    assert spans.records() == []


def test_span_records_name_parent_job_and_thread():
    @spans.job
    def inner():
        with spans.span("b"):
            pass

    @spans.job
    def outer():
        with spans.span("a"):
            inner()  # a job inside a job opens none of its own

    with recording():
        outer()
        outer()
        with spans.span("outside"):
            pass
    recs = spans.records()
    got = [(r.name, r.parent, r.job) for r in recs]
    j0, j1 = recs[0].job, recs[3].job
    assert got == [
        (spans.JOB, None, j0), ("a", 0, j0), ("b", 1, j0),
        (spans.JOB, None, j1), ("a", 3, j1), ("b", 4, j1),
        ("outside", None, None),
    ]
    assert j1 == j0 + 1
    assert {r.thread for r in recs} == {threading.get_ident()}
    assert all(0 < r.start_ns <= r.end_ns for r in recs)
    assert recs[2].start_ns >= recs[1].start_ns and recs[2].end_ns <= recs[1].end_ns


@pytest.mark.parametrize(
    "spans_, own",
    [
        ([("a", 0, 100, None)], [100]),
        ([("a", 0, 100, None), ("b", 10, 30, 0), ("c", 40, 90, 0)], [30, 20, 50]),
        ([("a", 0, 100, None), ("b", 10, 60, 0), ("c", 20, 50, 1)], [50, 20, 30]),
        ([("a", 0, 10, None), ("b", 20, 25, None)], [10, 5]),
    ],
)
def test_self_time_is_duration_less_children(spans_, own):
    recs = [Record(n, s, e, p, None, 1) for n, s, e, p in spans_]
    assert spans.self_ns(recs) == own


def test_counters_land_on_the_innermost_span():
    with recording():
        spans.count("lost", 1)  # outside any span
        with spans.span("outer"):
            spans.count("n", 1)
            with spans.span("inner"):
                spans.count("n", 2)
                spans.count("n", 3)
                spans.count("bytes", 8)
            spans.count("n", 4)
    outer, inner = spans.records()
    assert outer.counters == {"n": 5}
    assert inner.counters == {"n": 5, "bytes": 8}


def test_two_threads_keep_separate_stacks(monkeypatch):
    """The profiler records on the thread that started it; here every
    thread records, so that two stacks interleave."""
    monkeypatch.setattr(spans, "_enabled", lambda: True)
    turns = threading.Barrier(2, timeout=10)

    @spans.job
    def worker(tag):
        for i in range(3):
            with spans.span(f"{tag}.outer"):
                turns.wait()
                with spans.span(f"{tag}.inner{i}"):
                    turns.wait()

    threads = [threading.Thread(target=worker, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    assert not any(t.is_alive() for t in threads)
    recs = spans.records()
    assert len(recs) == 2 * (1 + 3 * 2)
    assert len({r.thread for r in recs}) == 2
    jobs = {r.thread: r.job for r in recs if r.name == spans.JOB}
    for r in recs:
        assert r.job == jobs[r.thread]
        if r.parent is not None:
            up = recs[r.parent]
            assert up.thread == r.thread
            assert up.name == (spans.JOB if r.name.endswith("outer") else f"{r.name[0]}.outer")


def test_a_blocking_ring_slot_is_a_wait_span():
    ring = _PinnedRing((4,), torch.float32, torch.device("cpu"))

    class Event:
        synchronized = 0

        def synchronize(self):
            Event.synchronized += 1

    with recording():
        with spans.span("iq2a.stage"):
            ring.events[0] = Event()
            ring.next()  # slot 0: blocks on its event
            ring.next()  # slot 1: nothing to wait for
    assert Event.synchronized == 1 and ring.events == [None, None]
    assert [(r.name, r.parent) for r in spans.records()] == [("iq2a.stage", None), ("iq2a.wait", 0)]


# where each span of a pipeline job sits: name -> the names its parent may have
PARENTS = {
    spans.JOB: {None},
    "iq2a.setup.probe": {spans.JOB},
    "iq2a.setup.mix_sign": {spans.JOB},
    "iq2a.setup.build": {spans.JOB},
    "iq2a.loop": {spans.JOB},
    "iq2a.flush": {spans.JOB},
    "iq2a.read": {"iq2a.setup.mix_sign", "iq2a.stage", "iq2a.fill"},
    "iq2a.alloc": {"iq2a.loop"},
    "iq2a.pad": {"iq2a.stage", "iq2a.fill"},
    "iq2a.stage": {"iq2a.loop"},
    "iq2a.step": {"iq2a.loop"},
    "iq2a.fetch": {"iq2a.loop"},
    "iq2a.drain": {"iq2a.loop"},
    "iq2a.write": {"iq2a.drain", "iq2a.loop"},
    # the read-ahead worker's group, a root on its own thread, and the
    # loop's taking of it
    "iq2a.fill": {None},
    "iq2a.take": {"iq2a.stage"},
    # a slot whose copy is still in flight (events exist on the card; the
    # table's runs give the CPU's slots events that never block)
    "iq2a.wait": {"iq2a.fill", "iq2a.drain"},
}
COUNTERS = {
    "iq2a.stage": {"h2d_bytes", "input_bytes"},
    "iq2a.step": {"chunks"},
    "iq2a.take": {"ahead_groups", "ahead_ready"},
}
# a read that fills an upload row counts its bytes; the one that finds the
# capture's end, or looks for a frame past a spent budget, counts nothing
MAY_COUNT = {"iq2a.read": {"direct_bytes"}}


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans") / f"baseband_{int(CENTER)}Hz_cap.wav"
    iq = make_nfm_iq(FS, 0.7, 25_000.0)
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(FS))
    return path


def job(entry, capture, out, channels):
    cfg = tpkg.ProcessingConfig(
        in_path=capture, target_freq=CENTER + 25_000.0, output_path=out, device="cpu",
        chunk_size=32_768, extra_target_freqs=[CENTER - 40_000.0] * (channels - 1),
    )
    if entry == "run":
        return tpkg.ProcessingPipeline(cfg).run()
    return run_preview(cfg, 0.4)[0]


@pytest.fixture
def slot_events(monkeypatch):
    """Every ring slot gets an event after its copy, as on the card, but one
    that never blocks."""

    class Done:
        def synchronize(self):
            pass

    def record(self, i):
        self.events[i] = Done()

    monkeypatch.setattr(_PinnedRing, "record", record)


@pytest.mark.parametrize("entry, channels", [("run", 1), ("run", 2), ("preview", 1)])
def test_pipeline_spans_sit_where_the_table_puts_them(
    capture, tmp_path, monkeypatch, slot_events, entry, channels
):
    plain = job(entry, capture, tmp_path / "off.wav", channels)
    assert spans.records() == []
    # the warm-up's block, the one block the loop copies and does not read
    firsts = []
    read_block_raw = IQReader.read_block_raw

    def spy(self):
        block = read_block_raw(self)
        firsts.append(block.size // 2)
        return block

    monkeypatch.setattr(IQReader, "read_block_raw", spy)
    with recording():
        results = [job(entry, capture, tmp_path / f"on{i}.wav", channels) for i in range(2)]
    recs = spans.records()
    assert len(firsts) == 2
    names = [r.name for r in recs]
    assert set(names) == set(PARENTS)
    roots = [r for r in recs if r.name == spans.JOB]
    assert len(roots) == 2 and len({r.job for r in recs}) == 2
    for r in recs:
        up = recs[r.parent].name if r.parent is not None else None
        assert up in PARENTS[r.name], (r.name, up)
        if r.name in MAY_COUNT and up in ("iq2a.stage", "iq2a.fill"):
            assert set(r.counters) <= MAY_COUNT[r.name], r.name
        else:
            assert set(r.counters) == COUNTERS.get(r.name, set()), r.name
    for root, result, first in zip(roots, results, firsts):
        mine = [r for r in recs if r.job == root.job]
        total = lambda counter: sum(r.counters.get(counter, 0) for r in mine)  # noqa: E731
        assert total("chunks") == result.dispatched_chunks
        assert total("input_bytes") == 4 * result.input_samples
        # every block after the first is read straight into its upload row
        assert total("direct_bytes") == 4 * (result.input_samples - min(first, result.input_samples))
        assert total("direct_bytes") > 0
        (loop,) = [r for r in mine if r.name == "iq2a.loop"]
        assert 0 < loop.end_ns - loop.start_ns <= result.loop_seconds * 1e9
        assert sum(r.name == "iq2a.setup.mix_sign" for r in mine) == 1
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in mine)
    # recording changes no output byte
    for on, off in zip(results[0].output_paths, plain.output_paths):
        assert on.read_bytes() == off.read_bytes()


def test_profile_dir_trace_carries_the_loop_spans_and_none_stay(capture, tmp_path):
    cfg = tpkg.ProcessingConfig(
        in_path=capture, target_freq=CENTER + 25_000.0, output_path=tmp_path / "a.wav",
        device="cpu", chunk_size=32_768, profile_dir=tmp_path / "trace",
    )
    tpkg.ProcessingPipeline(cfg).run()
    events = json.loads((tmp_path / "trace" / "chunk_loop.trace.json").read_text())["traceEvents"]
    names = {str(e.get("name", "")) for e in events}
    assert {"iq2a.loop", "iq2a.stage", "iq2a.step", "iq2a.drain", "iq2a.write"} <= names
    assert spans.records() == []


@pytest.mark.parametrize("mode", ["usb", "lsb", "nfm", "am"])
def test_the_ssb_chain_is_one_span_per_chunk_inside_the_step(capture, tmp_path, mode):
    """``iq2a.ssb`` wraps the SSB decoder's chain once per chunk, inside the
    step's enqueue, with no counters, as ``iq2a.am`` wraps the AM decoder's
    (envelope, DC blocker); other modes record neither; recording changes
    no output byte."""

    def run(out):
        cfg = tpkg.ProcessingConfig(
            in_path=capture, target_freq=CENTER + 25_000.0, output_path=out, device="cpu",
            chunk_size=32_768, demod_mode=mode, extra_target_freqs=[CENTER - 40_000.0],
        )
        return tpkg.ProcessingPipeline(cfg).run()

    plain = run(tmp_path / "off.wav")
    assert spans.records() == []
    with recording():
        traced = run(tmp_path / "on.wav")
    recs = spans.records()
    chain = {"usb": "iq2a.ssb", "lsb": "iq2a.ssb", "am": "iq2a.am"}.get(mode)
    steps = {i for i, r in enumerate(recs) if r.name == "iq2a.step"}
    chunks = sum(r.counters.get("chunks", 0) for r in recs)
    assert chunks == traced.dispatched_chunks > 1
    for name in ("iq2a.ssb", "iq2a.am"):
        got = [r for r in recs if r.name == name]
        if name != chain:
            assert got == []
        else:
            assert len(got) == chunks
            assert all(r.parent in steps and not r.counters for r in got)
    assert len(traced.output_paths) == len(plain.output_paths) == 2
    for on, off in zip(traced.output_paths, plain.output_paths):
        assert on.read_bytes() == off.read_bytes()
