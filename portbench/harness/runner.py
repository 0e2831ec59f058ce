"""One run of one cell: set-up, the measured window, the check, the result.

The traffic file's ``entry`` names the file ``entries/<entry>.py`` that
calls the program's public entry for a job, and its other keys size the
jobs; the configuration's file gives the
deployment.  A job is one call into the program, in a fresh pipeline, as the
program's front ends make it; the next job starts when it returns (a closed
loop with one user).
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import check, tracing
from .spec import Bench

#: top-level module names the measured process must not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "iq_to_audio_tpu")


@dataclass
class Job:
    index: int
    offsets: list
    wall_s: float = 0.0
    loop_s: float = 0.0
    input_samples: int = 0
    dispatched_chunks: int = 0
    capture_s: float = 0.0
    outputs: list = field(default_factory=list)
    error: str | None = None


def forbidden_modules() -> list[str]:
    """Forbidden top-level names in ``sys.modules``, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def capture_name(fc: float, seed: int) -> str:
    """SDR++'s file name: ``baseband_<fc>Hz_<HH-MM-SS>_<DD-MM-YYYY>.wav``."""
    rng = np.random.default_rng([seed, 3])
    h, m, s = rng.integers(0, 24), rng.integers(0, 60), rng.integers(0, 60)
    day, month = rng.integers(1, 29), rng.integers(1, 13)
    return f"baseband_{int(fc)}Hz_{h:02d}-{m:02d}-{s:02d}_{day:02d}-{month:02d}-2026.wav"


def job_offsets(cfg: dict, offsets: list, seed: int, index: int) -> list:
    """The carriers job ``index`` converts: all of them where the
    configuration converts as many targets as there are carriers, else a
    seeded pick of ``targets_per_job``."""
    k = int(cfg["targets_per_job"])
    if k >= len(offsets):
        return list(offsets)
    pick = np.random.default_rng([seed, 7, index + 1]).choice(len(offsets), k, replace=False)
    return [offsets[int(i)] for i in pick]


def check_indices(traffic: dict, seed: int) -> set:
    span, k = int(traffic["check_span"]), int(traffic["check_sample"])
    return {int(i) for i in np.random.default_rng([seed, 11]).choice(span, min(k, span), replace=False)}


def write_capture(cfg: dict, signal, container, work: Path, seed: int, seconds: float, device: str) -> Path:
    """Make the seed's capture on ``device`` and write it under ``work``."""
    capture = work / capture_name(cfg["assumed"]["center_freq_hz"], seed)
    iq = signal.make(cfg, seconds, seed, device)
    container.write(capture, iq, cfg["sample_rate"])
    del iq
    return capture


def run_job(entry, job: Job, capture: Path, cfg: dict, traffic: dict, out: Path, device: str) -> Job:
    """One call of ``entry`` (an ``entries/<name>.py`` module) in a fresh
    pipeline, timed from the call to its return."""
    from iq_to_audio_torch.pipeline.config import ProcessingConfig

    fc = float(cfg["assumed"]["center_freq_hz"])
    pcfg = ProcessingConfig(
        in_path=capture, target_freq=fc + job.offsets[0],
        extra_target_freqs=[fc + o for o in job.offsets[1:]],
        output_path=out, device=device, **cfg["pipeline"],
    )
    t0 = time.perf_counter()
    result = entry.run(pcfg, traffic)
    job.wall_s = time.perf_counter() - t0
    job.loop_s = result.loop_seconds
    job.input_samples = result.input_samples
    job.dispatched_chunks = result.dispatched_chunks
    job.capture_s = result.input_samples / float(cfg["sample_rate"])
    job.outputs = list(result.output_paths)
    return job


def run_cell(
    bench: Bench, cell_name: str, seed: int, seconds: float, trace: bool, *,
    device: str = "cuda", t0: float | None = None, capture_seconds: float | None = None,
    log=sys.stderr,
) -> dict:
    """Run ``cell_name`` once and return its result line (a dict).  ``t0`` is
    the process's start on the ``perf_counter`` clock; ``capture_seconds``
    shortens the capture (the CPU tests' tiny runs)."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = bench.cell(cell_name)
    cfg, traffic = cell.config, cell.traffic
    cuda = device.startswith("cuda")
    signal = bench.signal(cfg["signal"])
    container = bench.container(cfg["container"])
    offsets = signal.offsets(cfg)
    cap_s = float(capture_seconds or traffic["capture_seconds"])
    entry = bench.entry(traffic["entry"])
    keep = check_indices(traffic, seed)

    t_in = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        work = Path(tmp)
        out_dir = work / "out"
        out_dir.mkdir()
        capture = write_capture(cfg, signal, container, work, seed, cap_s, device)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        t_cap = time.perf_counter()

        def one(index: int) -> Job:
            job = Job(index, job_offsets(cfg, offsets, seed, index))
            name = f"keep{index}.wav" if index in keep else "job.wav"
            try:
                return run_job(entry, job, capture, cfg, traffic, out_dir / name, device)
            except Exception:  # a failed job is counted, and the loop goes on
                job.error = traceback.format_exc()
                print(f"job {index} failed:\n{job.error}", file=log)
                return job

        warm = one(-1)
        if warm.error:
            raise RuntimeError(f"the warm-up job failed:\n{warm.error}")
        setup_s = time.perf_counter() - t0
        print(
            f"setup: {t_in - t0:.3f} s start and imports, {t_cap - t_in:.3f} s capture, "
            f"{setup_s - (t_cap - t0):.3f} s warm-up job", file=log,
        )

        jobs: list[Job] = []
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            span = lambda name: record_function(name)  # noqa: E731
        else:
            span = lambda name: contextlib.nullcontext()  # noqa: E731
        with span(tracing.WINDOW_SPAN):
            w0 = time.perf_counter()
            while True:
                with span(tracing.JOB_SPAN):
                    jobs.append(one(len(jobs)))
                if time.perf_counter() - w0 >= seconds:
                    break
            window_s = time.perf_counter() - w0
        if cuda:
            torch.cuda.synchronize()
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
        trace_summary = None
        if prof is not None:
            t_an = time.perf_counter()
            prof.__exit__(None, None, None)
            trace_summary = tracing.analyse(tracing.events_of(prof))
            del prof
            print(
                f"trace: {trace_summary.n_events} events read in "
                f"{time.perf_counter() - t_an:.1f} s", file=log,
            )
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        ok = [j for j in jobs if j.error is None]
        failed = len(jobs) - len(ok)
        # the sampled jobs wrote files of their own; the last of the others
        # is what job.wav (or its per-channel names) holds now
        compared = [j for j in ok if j.index in keep]
        rest = [j for j in ok if j.index not in keep]
        if rest:
            compared.append(rest[-1])
        t_ref = time.perf_counter()
        ref = check.Reference(capture, container, cfg, device)
        worst = check.compare(compared, ref, log)
        ref_s = time.perf_counter() - t_ref

    run = SimpleNamespace(
        cell=cell, config=cfg, traffic=traffic, setup_s=setup_s, window_s=window_s,
        jobs=ok, trace=trace_summary, peaks=bench.peaks(),
        device_kind=torch.cuda.get_device_name() if cuda else "cpu",
    )
    metrics = {}
    for m in cell.per_layer if trace else cell.end_to_end:
        value = bench.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    correct, checks = check.verdict(worst, cell.limits, failed)
    walls = [j.wall_s for j in ok]
    print("walls_ms: " + " ".join(f"{w * 1e3:.0f}" for w in walls), file=log)
    print(
        f"jobs: {len(jobs)} attempted, {failed} failed, window {window_s:.3f} s, "
        f"job wall median {statistics.median(walls) if walls else 0:.4f} s, "
        f"setup {setup_s:.3f} s, reference {ref_s:.2f} s over {worst['wavs']} wavs"
    )
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": cell.chips if cuda else 0,
        "memory_peak_bytes": memory_peak,
    }
    result = {
        "correct": correct, "attempted": len(jobs), "failed": failed,
        "metrics": metrics, "device": device_info,
    }
    if trace_summary is not None:
        device_info["busy_s"] = trace_summary.busy_s
        device_info["window_s"] = trace_summary.window_s
        result["breakdown"] = trace_summary.breakdown()
    for name, c in checks.items():
        bound = "at least" if name == "wavs_compared" else "limit"
        print(f"check {name}: {c['value']} ({bound} {c['limit']})", file=log)
    result["checks"] = checks
    # last, once the reference, the modes and the readers have loaded too
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"forbidden modules in the measured process: {', '.join(leaked)}")
    return result
