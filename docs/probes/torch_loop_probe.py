"""Host-side timing of the PyTorch/CUDA port's chunk loop on the card.

Run from the root of a checkout:
    python3 docs/probes/torch_loop_probe.py [label] [runs]

Runs ``run_benchmark`` (10 s synthetic 2.5 MS/s s16 capture, one NFM
channel, warm-up pass then timed pass) ``runs`` times (4) in one process and
prints, per run, one JSON line: the realtime factor, the pass's and the
chunk loop's seconds, and the host microseconds each of the timed pass's
six chunks spent inside the channelizer wrapper (``poly_fir_il``) and inside
``chunk_step``.  It imports the package of the directory it is run from, so
``docs/probes/torch_ab_probe.py`` runs it from two trees in turns on one
card: the host clock moves by tens of percent between processes.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

from iq_to_audio_torch.ops import ddc  # noqa: E402
from iq_to_audio_torch.pipeline import step as stepmod  # noqa: E402
from iq_to_audio_torch.pipeline.benchmark import run_benchmark  # noqa: E402


def timed(fn, sink: list):
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sink.append(time.perf_counter() - t0)
        return out

    return wrapper


def main() -> int:
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    kernel_s: list = []
    step_s: list = []
    ddc.poly_fir_il = timed(ddc.poly_fir_il, kernel_s)
    stepmod.chunk_step = timed(stepmod.chunk_step, step_s)
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    for run in range(runs):
        kernel_s.clear()
        step_s.clear()
        results: dict = {}
        with tempfile.TemporaryDirectory() as tmp:
            run_benchmark(
                seconds=10.0, sample_rate=2.5e6, freq_offset=25e3, center_freq=None,
                target_freq=None, base_kwargs={"device": "cuda"}, warmup=True,
                results_out=results, workdir=Path(tmp),
            )
        print(json.dumps({
            "label": label, "run": run, "realtime_factor": results["realtime_factor"],
            "elapsed": results["elapsed"], "loop_seconds": results["loop_seconds"],
            "wrapper_us": [int(s * 1e6) for s in kernel_s[-6:]],
            "chunk_step_us": [int(s * 1e6) for s in step_s[-6:]],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
