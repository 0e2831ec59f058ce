"""The benchmark of ``iq_to_audio_torch``, one run of one cell.

    python3 portbench/run.py --workload nfm5.archive --seed 7 --seconds 20 --trace 0

Run from the root of a checkout.  Prints, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: the numbers
compared against the reference, each with its limit (also the last lines of
standard error).  Without a CUDA device, or with fewer than the cell asks
for, it exits with code 2 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    sys.path.insert(0, str(root))
    # every build and kernel cache in fixed directories inside the checkout
    cache = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")

    import torch

    from portbench.harness import runner
    from portbench.harness.spec import Bench

    bench = Bench(root)
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    result = runner.run_cell(
        bench, args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t0=T0,
    )
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
