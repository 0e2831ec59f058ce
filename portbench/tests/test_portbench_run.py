"""The command: no result without a card, and on the card (tests marked
``cuda``) each cell end to end, and nothing in a directory that holds only
the benchmark."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def run(cwd, cell, seconds, trace=0, timeout=600):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed", str(2**31 + 77),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=timeout,
    )


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = run(ROOT, "nfm5.archive", 1)
    assert p.returncode == 2 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    p = run(ROOT, cell, 3, trace)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["failed"] == 0 and result["device"]["platform"] == "gpu"
    want = SPEC["per_layer"] if trace else SPEC["end_to_end"]
    names = {m["name"] for m in want if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"
    if trace:
        assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]


@pytest.mark.cuda
def test_nothing_without_the_program(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = run(tmp_path, "nfm5.archive", 1)
    assert p.returncode != 0 and p.stdout == ""
