"""A probe of the port's channelizer kernel on the card.

Run from the root of a checkout:  python3 docs/probes/torch_kernel_probe.py

What the tensor cores' truncating accumulation costs: the same source built
with ``-DIQ2A_ONE_CHAIN`` (every MMA of the reduction chained through one
accumulator, instead of one chain per super-tap added by FADD) against the
plain version, at 62 and 385 taps and at 520 features, with both kernels'
times.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

from iq_to_audio_torch.ops import _cuda_build  # noqa: E402
from iq_to_audio_torch.ops import poly_fir as P  # noqa: E402


def err_db(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return 20.0 * math.log10(float((got - want).norm() / want.norm()) + 1e-30)


def time_ms(fn, iters: int = 30) -> float:
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def inputs(decim: int, channels: int, k_taps: int, m: int, rng):
    feat, out_ch = 2 * decim, 2 * channels
    w = rng.normal(size=(k_taps, feat, out_ch)) / math.sqrt(k_taps * feat)
    x = rng.integers(-32768, 32767, (m + k_taps - 1) * feat) / 32768.0
    return torch.from_numpy(x.astype(np.float32)).cuda(), torch.from_numpy(w.astype(np.float32)).cuda()


def main() -> int:
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    rng = np.random.default_rng(0)
    src = _cuda_build.CSRC / "poly_fir.cu"
    lib_path = _cuda_build.BUILD_DIR / "libpoly_fir_one_chain_probe.so"
    _cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _cuda_build.NVCC_FLAGS if f != "-Xptxas=-v"]
    subprocess.run([_cuda_build._nvcc(), *flags, "-DIQ2A_ONE_CHAIN", "-o", str(lib_path), str(src)],
                   check=True)
    fn = ctypes.CDLL(str(lib_path)).iq2a_poly_fir_il
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ctypes.c_longlong, ptr, ptr, ptr, *([i32] * 6), ptr]
    fn.restype = i32
    for decim, k_taps, m in ((26, 62, 161_250), (26, 385, 161_250), (260, 62, 16_125)):
        x, w = inputs(decim, 1, k_taps, m, rng)
        feat = 2 * decim
        scratch = torch.empty(-(-feat // 8) * (4 * P.super_taps(k_taps) + 3) * 2 * 16, device="cuda")
        out = torch.empty((2, m), device="cuda")
        kb = P.choose_k_block(k_taps, feat, 2, m)
        stream = torch.cuda.current_stream().cuda_stream

        def one_chain(pack=0):
            rc = fn(x.data_ptr(), x.numel(), w.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                    m, k_taps, feat, 2, kb // 4, pack, stream)
            assert rc == 0, rc

        one_chain(pack=1)
        torch.cuda.synchronize()
        want = P.poly_fir_il_plain(x, w, decim, m)
        print(f"one chain K={k_taps} F={feat} m={m}: {err_db(out, want):.1f} dB, "
              f"{time_ms(one_chain):.4f} ms; chain per super-tap: "
              f"{err_db(P.poly_fir_il(x, w, decim, m), want):.1f} dB, "
              f"{time_ms(lambda: P.poly_fir_il(x, w, decim, m)):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
