"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program: top-level names compared whole."""

import json
import shutil
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from portbench.harness import runner
from portbench.harness.spec import BENCH_DIR, Bench
from portbench.reference import chain

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "iq_to_audio_tpu"}


def top_level_after(code: str, home: Path) -> set:
    script = textwrap.dedent(code) + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))\n"
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "IQ2A_CHANNELIZER": "conv", "HOME": str(home), "TMPDIR": str(home), "OMP_NUM_THREADS": "1"},
    ).stdout.strip().splitlines()[-1]
    return set(eval(out))  # a list of names printed by the script above


def test_a_run_imports_no_jax(tmp_path):
    names = top_level_after(
        """
        import sys; sys.path.insert(0, '.')
        from pathlib import Path
        from portbench.harness import runner
        from portbench.harness.spec import Bench
        r = runner.run_cell(Bench(Path('.')), 'nfm5.archive', 5, 0.05, True, device='cpu', capture_seconds=0.6)
        assert r['correct']
        """,
        tmp_path,
    )
    assert "iq_to_audio_torch" in names and "torch" in names
    assert not names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program(tmp_path):
    names = top_level_after(
        """
        import sys; sys.path.insert(0, '.')
        import torch
        from portbench.reference import chain, design
        z = torch.exp(1j * torch.arange(30_000, dtype=torch.float64) * 0.01)
        p = {"fs_ch_target": 96000.0, "bandwidth": 12500.0, "demod_mode": "nfm", "deemph_us": 300.0}
        chain.channel_audio(z, 2.5e6, 25_000.0, 1, p, "f64")
        chain.channel_audio(z, 2.5e6, 25_000.0, 1, p, "tf32")
        """,
        tmp_path,
    )
    assert "portbench" in names
    assert not names & (FORBIDDEN | {"iq_to_audio_torch"})


@pytest.mark.parametrize(
    "loaded, found",
    [
        (["jax.numpy"], ["jax"]),
        (["jaxlib"], ["jaxlib"]),
        (["flax.linen"], ["flax"]),
        (["iq_to_audio_tpu.pipeline"], ["iq_to_audio_tpu"]),
        (["iq_to_audio_torch.pipeline", "jaxtyping", "iq_to_audio_tpu_extra"], []),
    ],
)
def test_forbidden_names_compared_whole(monkeypatch, loaded, found):
    for name in loaded:
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert runner.forbidden_modules() == found


def _reader_imports_jax(monkeypatch, tmp_path):
    """A per-layer metric whose reader, found by name, imports ``jax``."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (bench_dir / "metrics" / "late_reader.py").write_text("import jax  # noqa: F401\n\n\ndef read(run):\n    return 1.0\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "late_reader", "unit": "x", "better": "higher", "bound": 0.05, "source": "host_clock", "workloads": ["nfm1.preview"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return Bench(tmp_path, bench_dir)


def _mode_imports_jax(monkeypatch, tmp_path):
    """A demodulator of the reference, loaded by name after the window, that
    imports ``jax``."""
    orig = chain.load_mode

    def load_mode(name):
        import jax  # noqa: F401

        return orig(name)

    monkeypatch.setattr(chain, "load_mode", load_mode)
    return Bench(ROOT)


@pytest.mark.parametrize("late", [_reader_imports_jax, _mode_imports_jax], ids=["metric_reader", "reference_mode"])
def test_jax_loaded_after_the_window_gives_no_result(monkeypatch, tmp_path, conv_channelizer, late):
    """What loads last (the reference's modes, the metric readers) is inside
    the guard: a run that ends with ``jax`` in ``sys.modules`` returns no
    result and names it."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    monkeypatch.syspath_prepend(str(tmp_path / "stub"))
    bench = late(monkeypatch, tmp_path)
    assert "jax" not in sys.modules
    try:
        with pytest.raises(SystemExit, match="forbidden modules in the measured process: jax"):
            runner.run_cell(bench, "nfm1.preview", 2**31 + 5, 0.05, False, device="cpu", capture_seconds=0.6)
    finally:
        sys.modules.pop("jax", None)
