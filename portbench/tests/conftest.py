"""The benchmark's own CPU tests: ``python -m pytest portbench/tests``.

They run the harness on the CPU at tiny sizes through ``run_cell(...,
device="cpu", capture_seconds=...)``; the tests marked ``cuda`` run the
command itself and skip without a card.
"""

import sys
from pathlib import Path

import pytest
import torch

# the tests run the program and the reference at tiny sizes, several
# processes at a time: one intra-op thread each keeps them from contending
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark refuses to run without one")
    return torch.device("cuda")


@pytest.fixture
def bench():
    from portbench.harness.spec import Bench

    return Bench(ROOT)


@pytest.fixture
def conv_channelizer(monkeypatch):
    """The program's hand-kernel channelizer (its plain version on the CPU),
    as the card runs it."""
    monkeypatch.setenv("IQ2A_CHANNELIZER", "conv")
