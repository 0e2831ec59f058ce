"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix.  The configuration's file is
the one ``BENCHMARK.json`` gives; everything else is found under the
benchmark's directory by a name: ``traffic/<traffic>.json``,
``entries/<entry>.py`` (the program's entry a traffic mix's jobs call),
``metrics/<metric>.py``, ``limits/<cell>.json``, ``signals/<signal>.py``,
``containers/<container>.py`` and the reference's ``reference/modes/<mode>.py``.
Adding a configuration, a traffic mix or a metric adds files and entries and
edits none.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    #: end-to-end and per-layer metric entries of ``BENCHMARK.json`` that
    #: this cell reports
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _load_module(path: Path, name: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} not found")
    key = f"portbench_dyn_{hashlib.sha1(str(path.resolve()).encode()).hexdigest()[:12]}"
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """The benchmark as ``BENCHMARK.json`` at ``root`` describes it, with its
    files under ``bench_dir``."""

    def __init__(self, root: Path, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.bench_dir / "limits" / f"{cell}.json").read_text())

    def peaks(self) -> dict:
        return json.loads((self.bench_dir / "peaks.json").read_text())

    def cell(self, name: str) -> Cell:
        w = self._entry("workloads", name)
        e2e = [m for m in self.spec["end_to_end"] if name in m.get("workloads", [name])]
        moved = {m["name"] for m in e2e}
        layer = [
            m for m in self.spec["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in moved else [])
        ]
        return Cell(
            name=name, chips=int(w["chips"]), config=self.config(w["config"]),
            traffic=self.traffic(w["traffic"]), limits=self.limits(name),
            end_to_end=e2e, per_layer=layer,
        )

    def metric(self, name: str):
        """The reader ``metrics/<name>.py``: ``read(run) -> float | None``."""
        return _load_module(self.bench_dir / "metrics" / f"{name}.py", name)

    def signal(self, name: str):
        return _load_module(self.bench_dir / "signals" / f"{name}.py", f"signal_{name}")

    def container(self, name: str):
        return _load_module(self.bench_dir / "containers" / f"{name}.py", f"container_{name}")

    def entry(self, name: str):
        """The entry ``entries/<name>.py``: ``run(config, traffic) -> result``."""
        return _load_module(self.bench_dir / "entries" / f"{name}.py", f"entry_{name}")
