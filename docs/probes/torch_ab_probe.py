"""Two trees of the PyTorch/CUDA port against each other on one card.

Run from anywhere:
    python3 docs/probes/torch_ab_probe.py A=<tree> B=<tree> [pairs] [runs]

Runs ``torch_loop_probe.py`` (of the directory this file is in) from each
tree in turns, one process after the other, ``pairs`` times (10), and swaps
which tree goes first from pair to pair.  Each process makes ``runs`` (4)
timed passes of the flagship benchmark.  A first process per tree, not
counted, builds its kernels.  Prints every run's JSON line, then per tree
the quartiles of the realtime factor, of the pass's and the chunk loop's
seconds over all runs, the median host microseconds inside the channelizer
wrapper and inside ``chunk_step``, and the same medians per process and by
whether the tree went first or second in its pair.  The card's name and
power limit come first.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

PROBE = Path(__file__).resolve().with_name("torch_loop_probe.py")


def run_probe(label: str, tree: str, runs: int) -> list[dict]:
    proc = subprocess.run(
        [sys.executable, str(PROBE), label, str(runs)],
        cwd=tree, capture_output=True, text=True, check=False,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{label} in {tree} failed:\n{proc.stderr[-2000:]}")
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]


def quartiles(values: list[float]) -> dict:
    q1, q2, q3 = statistics.quantiles(values, n=4, method="inclusive")
    return {"n": len(values), "min": min(values), "q1": q1, "median": q2, "q3": q3,
            "max": max(values)}


def main() -> int:
    trees = dict(arg.split("=", 1) for arg in sys.argv[1:3])
    pairs = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    runs = int(sys.argv[4]) if len(sys.argv) > 4 else 4
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    labels = list(trees)
    for label in labels:
        run_probe(label, trees[label], 1)  # builds the kernels
    rows: dict[str, list[dict]] = {label: [] for label in labels}
    for pair in range(pairs):
        order = labels if pair % 2 == 0 else labels[::-1]
        for position, label in enumerate(order):
            for row in run_probe(label, trees[label], runs):
                row.update(pair=pair, position=position)
                rows[label].append(row)
                print(json.dumps(row), flush=True)
    for label in labels:
        mine = rows[label]
        summary = {"tree": label, "path": trees[label]}
        for key in ("realtime_factor", "elapsed", "loop_seconds"):
            summary[key] = quartiles([r[key] for r in mine])
        for key in ("wrapper_us", "chunk_step_us"):
            summary[f"{key}_median"] = statistics.median(v for r in mine for v in r[key])
        summary["loop_seconds_median_by_process"] = [
            statistics.median(r["loop_seconds"] for r in mine if r["pair"] == p)
            for p in range(pairs)
        ]
        summary["loop_seconds_median_by_position"] = {
            name: statistics.median(r["loop_seconds"] for r in mine if r["position"] == pos)
            for pos, name in enumerate(("first", "second"))
            if any(r["position"] == pos for r in mine)
        }
        print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
