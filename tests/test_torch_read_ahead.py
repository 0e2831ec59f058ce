"""The chunk loop's read-ahead worker (``pipeline.py::_ChunkLoop._groups``),
on the CPU: the same WAV bytes whether the worker is late for every group
or ahead of every one, and those within the parity tolerance of the JAX
package's; no thread left after a run, an error or a cancel; a stopped and
resumed run; the worker's spans and counters."""

from __future__ import annotations

import contextlib
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import error_db, make_nfm_iq

import iq_to_audio_tpu as jpkg
import iq_to_audio_torch as tpkg
from iq_to_audio_torch import ProcessingCancelled
from iq_to_audio_torch.io.reader import IQReader
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.ops import native_ddc
from iq_to_audio_torch.pipeline import pipeline as tpipeline
from iq_to_audio_torch.pipeline.pipeline import _ChunkLoop
from iq_to_audio_torch.pipeline.progress import NullProgressSink
from iq_to_audio_torch.utils import spans

torch.set_num_threads(1)

FS = 250_000.0
CENTER = 145_000_000.0
OFFSET = 25_000.0
CHUNK = 65_625  # the loop's chunk for these captures at chunk_size 32_768
WORKER = "iq2a-read-ahead"

# capture length and budget in chunks; the cuts fall inside a group of two
CASES = {
    "multi-group": dict(chunks=8.0),
    "short last block": dict(chunks=7.4),
    "budget mid-group, frames left": dict(chunks=12.0, budget=9.5),
    "budget mid-group at the capture's end": dict(chunks=9.5, budget=9.5),
    "pcm_u8": dict(chunks=7.4, codec="pcm_u8"),
    "float32 capture": dict(chunks=7.4, codec="pcm_f32le"),
    "pass-through": dict(chunks=7.4, demod_mode="none"),
}


@pytest.fixture(autouse=True)
def jax_nco(monkeypatch):
    """The port's NCO without its increment residual, so that the two
    packages mix alike (as ``test_torch_pipeline_modes.py`` does)."""
    monkeypatch.setattr(
        "iq_to_audio_torch.pipeline.capture.nco_increment_residual", lambda *a, **k: 0
    )


def _capture(tmp_path, chunks, codec="pcm_s16le"):
    """A capture of ``chunks`` loop chunks and the config fields it needs."""
    n = int(round(chunks * CHUNK))
    iq = make_nfm_iq(FS, n / FS + 0.01, OFFSET)[:n]
    if codec == "pcm_u8":
        raw = np.empty(2 * n, np.uint8)
        raw[0::2] = np.clip(np.round(iq.real * 127 + 128), 0, 255)
        raw[1::2] = np.clip(np.round(iq.imag * 127 + 128), 0, 255)
        path = tmp_path / "cap.cu8"
        raw.tofile(path)
        return path, dict(center_freq=CENTER, input_sample_rate=FS)
    path = tmp_path / f"baseband_{int(CENTER)}Hz_cap.wav"
    write_stereo_wav(path, np.column_stack([iq.real, iq.imag]), int(FS), codec=codec)
    return path, {}


def _cfg(pkg, path, out, **kw):
    extra = {"device": "cpu"} if pkg is tpkg else {}
    return pkg.ProcessingConfig(
        in_path=path, target_freq=CENTER + OFFSET, output_path=out, chunk_size=32_768,
        mix_sign_override=1, **extra, **kw,
    )


def _run(path, out, sink=None, **kw):
    return tpkg.ProcessingPipeline(_cfg(tpkg, path, out, **kw)).run(sink)


@contextlib.contextmanager
def paced(pace):
    """``late``: the worker starts each group only once the loop has asked
    for it (every take finds nothing ready); ``ahead``: the loop asks for a
    group only once the worker has handed it over (every take finds it
    ready); ``plain``: as the threads fall."""
    with pytest.MonkeyPatch.context() as mp:
        take = _ChunkLoop._take
        if pace == "late":
            asked, stops = threading.Event(), []
            fill_group, read_ahead = _ChunkLoop._fill_group, _ChunkLoop._read_ahead

            class Asking:
                def __init__(self, ready):
                    self.ready = ready

                def empty(self):
                    return self.ready.empty()

                def get(self):
                    asked.set()
                    return self.ready.get()

            def late_read_ahead(self, uploads, free, ready, stop, carried):
                stops.append(stop)
                return read_ahead(self, uploads, free, ready, stop, carried)

            def late_fill(self, rows):
                if threading.current_thread().name == WORKER:
                    deadline = time.monotonic() + 60.0
                    while not asked.wait(0.002) and not stops[-1].is_set():
                        assert time.monotonic() < deadline, "the loop never asked"
                    asked.clear()
                return fill_group(self, rows)

            mp.setattr(_ChunkLoop, "_read_ahead", late_read_ahead)
            mp.setattr(_ChunkLoop, "_fill_group", late_fill)
            mp.setattr(_ChunkLoop, "_take", staticmethod(lambda ready: take(Asking(ready))))
        elif pace == "ahead":

            def ahead_take(ready):
                deadline = time.monotonic() + 60.0
                while ready.empty():
                    assert time.monotonic() < deadline, "the worker never handed a group"
                    time.sleep(0.001)
                return take(ready)

            mp.setattr(_ChunkLoop, "_take", staticmethod(ahead_take))
        yield


@pytest.fixture
def workers(monkeypatch):
    """The read-ahead threads each run starts."""
    started = []
    thread_start = threading.Thread.start

    def start(self):
        if self.name == WORKER:
            started.append(self)
        return thread_start(self)

    monkeypatch.setattr(threading.Thread, "start", start)
    return started


@pytest.fixture
def no_thread_left():
    before = set(threading.enumerate())
    yield
    assert set(threading.enumerate()) == before


@pytest.mark.parametrize("case", list(CASES))
def test_late_or_ahead_the_bytes_are_the_same_and_match_jax(
    tmp_path, caplog, workers, no_thread_left, case
):
    spec = dict(CASES[case])
    chunks, budget = spec.pop("chunks"), spec.pop("budget", None)
    path, extra = _capture(tmp_path, chunks, spec.pop("codec", "pcm_s16le"))
    kw = dict(extra, **spec)
    if budget is not None:
        kw["max_input_seconds"] = int(round(budget * CHUNK)) / FS
    outs, logs = {}, {}
    for pace in ("plain", "late", "ahead"):
        caplog.clear()
        with paced(pace), caplog.at_level("INFO", logger=tpipeline.LOG.name):
            result = _run(path, tmp_path / f"{pace}.wav", **kw)
        outs[pace] = result.output_paths[0].read_bytes()
        logs[pace] = "due to preview limit" in caplog.text
    assert len(workers) == 3  # one worker a run, each joined
    assert not any(w.is_alive() for w in workers)
    used = int(round(min(chunks, budget or chunks) * CHUNK))
    assert result.input_samples == used
    assert result.dispatched_chunks == 2 * -(-used // (2 * CHUNK))  # groups of two
    assert outs["late"] == outs["plain"] == outs["ahead"]
    # the budget cut the capture where frames were left, and only there
    assert set(logs.values()) == {budget is not None and budget < chunks}

    jout = tmp_path / "jax.wav"
    jpkg.ProcessingPipeline(_cfg(jpkg, path, jout, **kw)).run()
    got, want = read_wav(result.output_paths[0])[0], read_wav(jout)[0]
    assert got.shape == want.shape
    assert error_db(got, want) < -80.0
    assert np.abs(got - want).max() <= 1.5 / 32768  # within 1 LSB


def _tensors(obj):
    if isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, torch.Tensor):
        yield obj


@pytest.mark.parametrize("codec", ["pcm_s16le", "pcm_f32le", "pcm_u8"])
@pytest.mark.parametrize("channelizer", ["conv", "fft", "native"])
def test_the_carried_state_never_views_the_upload_slot(
    tmp_path, monkeypatch, channelizer, codec
):
    """On the CPU the step's input is the pinned slot itself, which goes
    back to the worker once the step has returned: no tensor of the state
    it returns may share that slot's memory."""
    if channelizer == "native" and not native_ddc.available():
        pytest.skip("the native channelizer library does not build here")
    monkeypatch.setenv("IQ2A_CHANNELIZER", channelizer)
    path, extra = _capture(tmp_path, 2.5, codec)
    calls = []
    build = tpipeline.build_chunk_step

    def checking_build(**kw):
        step = build(**kw)
        fn = step.fn

        def one(state, accs, raw, rs_offset, slot):
            state = fn(state, accs, raw, rs_offset, slot)
            slot_mem = raw.untyped_storage().data_ptr()
            calls.append([t.untyped_storage().data_ptr() != slot_mem for t in _tensors(state)])
            return state

        step.fn = one  # fn_super runs its rows through fn
        return step

    monkeypatch.setattr(tpipeline, "build_chunk_step", checking_build)
    result = _run(path, tmp_path / "a.wav", **extra)
    assert result.channelizer == channelizer
    assert len(calls) == result.dispatched_chunks == 3
    assert all(all(owned) and owned for owned in calls)


def test_one_group_starts_no_thread(tmp_path, workers, no_thread_left):
    path, _ = _capture(tmp_path, 0.6)
    result = _run(path, tmp_path / "one.wav")
    assert result.dispatched_chunks == 1 and workers == []
    path, _ = _capture(tmp_path, 2.5)
    _run(path, tmp_path / "three.wav")
    assert len(workers) == 1 and not workers[0].is_alive()


@pytest.mark.parametrize("pace", ["late", "ahead"])
def test_a_reader_error_reaches_the_caller_where_the_serial_loop_raised_it(
    tmp_path, monkeypatch, workers, no_thread_left, pace
):
    """The worker's third read fails: that is the first row of the third
    group (the first group's second row is read on the loop's thread), so
    two groups were dispatched, as in a loop without a worker."""
    path, _ = _capture(tmp_path, 8.0)
    read_into, reads = IQReader.read_into, []

    def failing(self, dest, max_frames=None):
        if threading.current_thread().name == WORKER:
            reads.append(max_frames)
            if len(reads) == 3:
                raise OSError(5, "Input/output error")
        return read_into(self, dest, max_frames)

    groups = []
    build = tpipeline.build_chunk_step

    def counting_build(**kw):
        step = build(**kw)
        fn_super = step.fn_super

        def group(*args):
            groups.append(1)
            return fn_super(*args)

        step.fn_super = group
        return step

    monkeypatch.setattr(IQReader, "read_into", failing)
    monkeypatch.setattr(tpipeline, "build_chunk_step", counting_build)
    with paced(pace), pytest.raises(OSError) as err:
        _run(path, tmp_path / "a.wav")
    assert err.type is OSError and str(err.value) == "[Errno 5] Input/output error"
    assert len(reads) == 3 and len(groups) == 2
    assert len(workers) == 1 and not workers[0].is_alive()


class _CancelAfter(NullProgressSink):
    """Cancel once the ingest phase passes ``threshold`` samples."""

    def __init__(self, threshold):
        self.threshold, self.seen, self._cb = threshold, 0.0, None

    def advance(self, phase, delta, *, overall_completed, overall_total):
        if phase.key == "ingest":
            self.seen += delta
            if self.seen >= self.threshold and self._cb:
                self._cb()

    def set_cancel_callback(self, callback):
        self._cb = callback


@pytest.mark.parametrize("pace", ["late", "ahead"])
def test_a_cancel_joins_the_worker(tmp_path, workers, no_thread_left, pace):
    path, _ = _capture(tmp_path, 8.0)
    out = tmp_path / "cancelled.wav"
    with paced(pace), pytest.raises(ProcessingCancelled):
        _run(path, out, _CancelAfter(3 * CHUNK))
    assert len(workers) == 1 and not workers[0].is_alive()
    assert not out.exists()  # the partial output is deleted


@pytest.mark.parametrize("pace", ["late", "ahead"])
def test_a_stopped_and_resumed_run_writes_the_uninterrupted_bytes(
    tmp_path, workers, no_thread_left, pace
):
    path, _ = _capture(tmp_path, 8.0)
    whole = _run(path, tmp_path / "whole.wav").output_paths[0].read_bytes()
    out = tmp_path / "resumed.wav"
    with paced(pace):
        with pytest.raises(ProcessingCancelled):
            _run(path, out, _CancelAfter(4.5 * CHUNK), checkpoint_secs=0.5)
        with (tmp_path / "resumed.wav.ckpt").open("rb") as f:
            done = pickle.load(f)["counters"]["processed_samples"]
        result = _run(path, out, checkpoint_secs=0.5, resume=True)
    assert 0 < done < result.input_samples == 8 * CHUNK
    assert out.read_bytes() == whole
    assert len(workers) == 3 and not any(w.is_alive() for w in workers)


@pytest.mark.parametrize("pace", ["late", "ahead"])
def test_a_traced_run_counts_the_takes_and_files_the_worker_spans_under_the_job(
    tmp_path, no_thread_left, pace
):
    path, _ = _capture(tmp_path, 7.4)
    spans.reset()
    try:
        with paced(pace), profile(activities=[ProfilerActivity.CPU]):
            result = _run(path, tmp_path / "traced.wav")
        recs = spans.records()
    finally:
        spans.reset()
    (root,) = [r for r in recs if r.name == spans.JOB]
    here = threading.get_ident()
    assert root.thread == here
    takes = [r for r in recs if r.name == "iq2a.take"]
    # eight chunks in groups of two, the last one short: the worker fills
    # the last three
    assert len(takes) == 3 == result.dispatched_chunks // 2 - 1
    assert all(set(r.counters) == {"ahead_groups", "ahead_ready"} for r in takes)
    assert sum(r.counters["ahead_groups"] for r in takes) == 3
    assert sum(r.counters["ahead_ready"] for r in takes) == (3 if pace == "ahead" else 0)
    assert all(recs[r.parent].name == "iq2a.stage" for r in takes)
    fills = [r for r in recs if r.name == "iq2a.fill"]
    assert len(fills) == 3 and len({r.thread for r in fills}) == 1
    worker = fills[0].thread
    assert worker != here
    for r in recs:
        assert r.job == root.job
        assert (r.thread == worker) == (r.name == "iq2a.fill" or (
            r.parent is not None and recs[r.parent].name == "iq2a.fill"
        ))
    assert all(r.parent is None for r in fills)
    reads = [r for r in recs if r.thread == worker and r.name == "iq2a.read"]
    assert len(reads) == 6 and all(r.counters.get("direct_bytes", 0) > 0 for r in reads)
    assert all(s >= 0 for s in spans.self_ns(recs))


def test_concurrent_runs_under_a_short_switch_interval_write_their_own_bytes(
    tmp_path, no_thread_left
):
    """Four runs at once, each with its worker (eight threads), with the
    interpreter switching threads every 10 us: each writes the bytes of a
    run alone, so no worker filled another run's slot or moved another
    run's stream position."""
    for i in range(4):
        (tmp_path / f"c{i}").mkdir()
    paths = [_capture(tmp_path / f"c{i}", 4.4 + i, "pcm_s16le")[0] for i in range(4)]
    alone = [_run(p, p.with_name("alone.wav")).output_paths[0].read_bytes() for p in paths]
    got, errors = [None] * 4, []

    def one(i):
        try:
            got[i] = _run(paths[i], paths[i].with_name("together.wav")).output_paths[0].read_bytes()
        except Exception as exc:  # noqa: BLE001 - reported by the assertion below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runs = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in runs:
            t.start()
        for t in runs:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in runs)
    assert errors == []
    assert got == alone
