"""BENCHMARK.json against the benchmark's contract, and lookup by name:
a configuration, a traffic mix, an entry and a metric added as files and
entries."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.harness import runner
from portbench.harness.spec import BENCH_DIR, Bench

ROOT = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"]
    assert SPEC["command"][1] == "portbench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43_200
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[key]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert {m["source"] for m in SPEC["end_to_end"]} <= {"host_clock", "device_trace"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(bench, cell):
    c = bench.cell(cell)
    assert c.chips == 1
    e2e = [m["name"] for m in c.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(bench.metric(m["name"]).read)
    assert set(c.limits) == {"len_gap", "mean_gap_lsb", "trim_gap_lsb"} and c.limits["len_gap"] == 0
    assert callable(bench.signal(c.config["signal"]).make)
    assert callable(bench.container(c.config["container"]).write)
    assert callable(bench.entry(c.traffic["entry"]).run)


def test_added_by_files_and_entries(tmp_path, conv_channelizer):
    """A configuration, a traffic mix, an entry, a limit and a metric added
    as files, with entries in BENCHMARK.json, run without touching a
    harness file."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    before = {p.name: p.read_bytes() for p in (bench_dir / "harness").glob("*.py")}
    cfg = json.loads((bench_dir / "configs" / "nfm1_2m5_s16.json").read_text())
    cfg["name"] = "nfm1_narrow"
    cfg["pipeline"]["bandwidth"] = 6250.0
    (bench_dir / "configs" / "nfm1_narrow.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench_dir / "traffic" / "archive.json").read_text())
    traffic.update(name="archive_short", entry="pipeline_logged", capture_seconds=0.6, check_sample=1, check_span=2)
    (bench_dir / "traffic" / "archive_short.json").write_text(json.dumps(traffic))
    (bench_dir / "entries" / "pipeline_logged.py").write_text(
        "CALLS = []\n\n\ndef run(config, traffic):\n"
        "    from iq_to_audio_torch.pipeline.pipeline import ProcessingPipeline\n\n"
        "    CALLS.append(config.target_freq)\n"
        "    return ProcessingPipeline(config).run()\n"
    )
    (bench_dir / "limits" / "narrow.short.json").write_text(
        (bench_dir / "limits" / "nfm5.archive.json").read_text()
    )
    (bench_dir / "metrics" / "jobs_done.py").write_text("def read(run):\n    return float(len(run.jobs))\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "nfm1_narrow", "source": "test", "file": "portbench/configs/nfm1_narrow.json", "reduced": ["pipeline"], "why": "test"})
    spec["workloads"].append({"name": "narrow.short", "config": "nfm1_narrow", "traffic": "archive_short", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "jobs_done", "unit": "jobs", "better": "higher", "bound": 0.05, "source": "host_clock", "workloads": ["narrow.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(tmp_path, bench_dir)
    cell = bench.cell("narrow.short")
    assert cell.config["pipeline"]["bandwidth"] == 6250.0
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "jobs_done"]
    result = runner.run_cell(bench, "narrow.short", 3, 0.1, False, device="cpu", capture_seconds=0.6)
    assert result["correct"], result["checks"]
    assert result["metrics"]["jobs_done"]["value"] == result["attempted"] >= 1
    assert set(result["metrics"]) == {"setup_s", "jobs_done"}
    assert len(bench.entry("pipeline_logged").CALLS) == result["attempted"] + 1  # and the warm-up
    assert list(result)[-1] == "checks"
    assert before == {p.name: p.read_bytes() for p in (bench_dir / "harness").glob("*.py")}
