"""A whole run, past the harness's look for a card, with the timed path
broken underneath: ``correct`` has to come out false for each fault a cell
can have, and true without one.  (No cell spans chips, so there is no
exchange between chips to leave out.)"""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import runner
from portbench.harness.spec import Bench

ROOT = Path(__file__).resolve().parents[2]


def state_unchanged(monkeypatch):
    """Every chunk step returns the state it was given."""
    from iq_to_audio_torch.pipeline import step

    orig = step.ChunkStep.fn

    def fn(self, state, accs, raw, rs_offset, slot):
        orig(self, state, accs, raw, rs_offset, slot)
        return state

    monkeypatch.setattr(step.ChunkStep, "fn", fn)


def half_batch(monkeypatch):
    """Every other chunk of a window is left out: its slot is never
    computed."""
    from iq_to_audio_torch.pipeline import step

    orig = step.ChunkStep.fn

    def fn(self, state, accs, raw, rs_offset, slot):
        return state if slot % 2 else orig(self, state, accs, raw, rs_offset, slot)

    monkeypatch.setattr(step.ChunkStep, "fn", fn)


def answer_altered(monkeypatch):
    """Each WAV's first block of audio is altered where it is written."""
    from iq_to_audio_torch.io import writer

    orig = writer.AudioWriter.write_s16

    def write_s16(self, samples):
        if not getattr(self, "_altered", False):
            self._altered = True
            samples = -np.asarray(samples, dtype=np.int16)
        return orig(self, samples)

    monkeypatch.setattr(writer.AudioWriter, "write_s16", write_s16)


FAULTS = {"none": None, "state_unchanged": state_unchanged, "half_batch": half_batch, "answer_altered": answer_altered}


@pytest.mark.parametrize("cell", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
@pytest.mark.parametrize("fault", list(FAULTS))
def test_fault_fails_the_run(monkeypatch, conv_channelizer, cell, fault):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    result = runner.run_cell(Bench(ROOT), cell, 2**31 + 23, 0.2, False, device="cpu", capture_seconds=2.2)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["correct"] is (fault == "none"), result["checks"]
