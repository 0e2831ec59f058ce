"""``chan_roofline.archive``: the channelizer's bytes and operations from the
configuration's shapes, against the flagship chunk's figures."""

import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness.tracing import Trace

BENCH = Path(__file__).resolve().parents[1]
CFG = json.loads((BENCH / "configs" / "nfm1_2m5_s16.json").read_text())
PEAKS = json.loads((BENCH / "peaks.json").read_text())
H100 = "NVIDIA H100 80GB HBM3"
CHUNK = 4_192_500  # the card's flagship chunk: m = 161,250 outputs


def roofline():
    spec = importlib.util.spec_from_file_location("chan_roofline", BENCH / "metrics" / "chan_roofline.archive.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_geometry():
    assert roofline().channel_geometry(CFG) == (26, 1601)


@pytest.mark.parametrize(
    "channels, mbytes, gflop, bound_us, bound",
    [(1, 18.06, 2.065, 5.39, "bytes"), (5, 23.22, 10.33, 20.9, "operations")],
)
def test_work_of_one_chunk(channels, mbytes, gflop, bound_us, bound):
    nbytes, flops = roofline().work(CFG, CHUNK, channels)
    assert nbytes / 1e6 == pytest.approx(mbytes, rel=1e-3)
    assert flops / 1e9 == pytest.approx(gflop, rel=1e-3)
    t_b = nbytes / PEAKS[H100]["hbm_bytes_per_s"]
    t_f = flops / PEAKS[H100]["tf32_flops"]
    assert max(t_b, t_f) * 1e6 == pytest.approx(bound_us, rel=1e-2)
    assert ("bytes" if t_b >= t_f else "operations") == bound


def run_with(kernel_name, seconds_per_launch, launches=24, channels=1, kind=H100):
    trace = Trace(window_s=1.0, busy_s=0.1, ops={kernel_name: [launches, seconds_per_launch * launches]})
    jobs = [SimpleNamespace(input_samples=CHUNK * launches, offsets=[0.0] * channels)]
    return SimpleNamespace(trace=trace, jobs=jobs, config=CFG, peaks=PEAKS, device_kind=kind)


def test_share_of_the_bound():
    read = roofline().read
    assert read(run_with("poly_fir_kernel<4, 2>", 60.7e-6)) == pytest.approx(100 * 5.391 / 60.7, rel=1e-3)
    assert read(run_with("poly_fir_kernel", 200e-6, channels=5)) == pytest.approx(100 * 20.86 / 200, rel=1e-3)


def test_nothing_to_read():
    read = roofline().read
    assert read(run_with("other_kernel", 60e-6)) is None  # a renamed kernel reads nothing
    assert read(run_with("poly_fir_kernel", 60e-6, kind="cpu")) is None
    assert read(SimpleNamespace(trace=None)) is None
