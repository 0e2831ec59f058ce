"""The check's two readings at a cell's own size, on the chip, for many seeds
in one process: the program's (what ``correct`` compares in a run) and the
control's, the reference itself computed in TF32 (operands rounded to 10
mantissa bits, float32 sums) and put in the program's place: its audio is
written as the program's WAVs and judged by the run's own comparison and
the cell's limits, so a sound check reads ``control_correct`` false.  The
benchmark's own runs do not run this.

    python3 portbench/control.py --workload nfm5.archive --seeds 1,2,3 --out FILE

Writes one JSON line per seed to ``FILE`` and to standard output.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import wave  # noqa: E402
from pathlib import Path  # noqa: E402


def write_s16(path: Path, codes, rate: float) -> None:
    """Mono s16 WAV of ``codes`` (s16 values), as the program writes its
    audio."""
    import torch

    raw = torch.clamp(torch.round(codes), -32768, 32767).to(torch.int16).numpy().tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(rate))
        w.writeframes(raw)


def readings(bench, cell_name: str, seed: int, device: str, capture_seconds=None) -> dict:
    """Run the jobs a run would compare (the seed's sampled jobs and one
    more), and judge them as a run does; then put the control's audio in
    their place (the same WAV names) and judge that the same way."""
    import torch

    from portbench.harness import check, runner

    cell = bench.cell(cell_name)
    cfg, traffic = cell.config, cell.traffic
    signal = bench.signal(cfg["signal"])
    container = bench.container(cfg["container"])
    entry = bench.entry(traffic["entry"])
    offsets = signal.offsets(cfg)
    indices = sorted(runner.check_indices(traffic, seed)) + [int(traffic["check_span"])]
    cap_s = float(capture_seconds or traffic["capture_seconds"])
    row = {"cell": cell_name, "seed": seed}
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        work = Path(tmp)
        capture = runner.write_capture(cfg, signal, container, work, seed, cap_s, device)
        jobs = []
        t = time.perf_counter()
        for i in indices:
            job = runner.Job(i, runner.job_offsets(cfg, offsets, seed, i))
            jobs.append(runner.run_job(entry, job, capture, cfg, traffic, work / f"keep{i}.wav", device))
        row["program_s"] = time.perf_counter() - t
        if device.startswith("cuda"):
            torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = check.Reference(capture, container, cfg, device)
        program = check.compare(jobs, ref, sys.stderr)
        row["program_correct"], _ = check.verdict(program, cell.limits)
        row["reference_s"] = time.perf_counter() - t
        t = time.perf_counter()
        ctl = check.Reference(capture, container, cfg, device, prec=check.CONTROL)
        for job in jobs:
            sign = ctl.sign(job.offsets[0])
            for off, path in zip(job.offsets, job.outputs):
                write_s16(path, ctl.codes(off, sign, job.input_samples), cfg["output_rate"])
        each: list = []
        control = check.compare(jobs, ref, None, each)
        row["control_correct"], _ = check.verdict(control, cell.limits)
        # the upper reading: the least the control gives over its WAVs
        for name in check.NUMBERS[1:]:
            control[f"{name}_least"] = min(g[name] for g in each)
        row["control_s"] = time.perf_counter() - t
    row["program"] = program
    row["control"] = control
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    root = Path.cwd()
    sys.path.insert(0, str(root))
    import torch

    from portbench.harness.spec import Bench

    if not torch.cuda.is_available():
        print("control readings need a CUDA device", file=sys.stderr)
        return 2
    bench = Bench(root)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for seed in (int(s) for s in args.seeds.split(",")):
            row = readings(bench, args.workload, seed, "cuda")
            row["kind"] = torch.cuda.get_device_name()
            print(json.dumps(row), flush=True)
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
