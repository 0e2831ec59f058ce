"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every hand-written kernel from ``iq_to_audio_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel against its plain torch version on the card at the
   main path's shapes (< -100 dB), and time the kernel, the plain version
   and the one PyTorch call that computes the same function;
4. drive the main path end to end: ``run_benchmark`` on a 10 s synthetic
   2.5 MS/s s16 capture with one NFM channel, with every launch count set
   to 0 just before; the launches must equal the chunks dispatched, and
   the first 2 s of audio must agree with the package's float64 twin;
5. the ``{"kernels": [...]}`` line, then the card line, then the
   ``{"ok": true, ...}`` line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from iq_to_audio_torch.io.writer import read_wav
from iq_to_audio_torch.ops import _cuda_build
from iq_to_audio_torch.ops.ddc import bandpass_kernel, interleave_kernel
from iq_to_audio_torch.ops.nco import nco_increment_fixed
from iq_to_audio_torch.ops.poly_fir import (
    build_poly_kernel,
    choose_k_block,
    poly_fir_il,
    poly_fir_il_plain,
)
from iq_to_audio_torch.ops.resample import ResamplePlan
from iq_to_audio_torch.pipeline.benchmark import run_benchmark
from iq_to_audio_torch.pipeline.filters import compute_decimation, design_channel_filter
from iq_to_audio_torch.ref.chain import RefResampler, ref_demod_chain

SAMPLE_RATE = 2_500_000.0
OFFSET = 25_000.0
SECONDS = 10.0
#: hand-written CUDA sources built by this script (csrc/<name>.cu)
SOURCES = ("poly_fir",)

# Data-sheet peaks (dense, no sparsity) by H100 part: FP32 outside the
# tensor cores in FLOP/s, and device memory in bytes/s.
_PEAKS = {
    "PCIe": (51e12, 2.0e12),
    "NVL": (60e12, 3.9e12),
    "SXM": (67e12, 3.35e12),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def error_db(test: np.ndarray, ref: np.ndarray) -> float:
    test = np.asarray(test, np.float64)
    ref = np.asarray(ref, np.float64)
    num = float(np.linalg.norm(test - ref))
    den = float(np.linalg.norm(ref)) + 1e-30
    return 20.0 * math.log10(num / den + 1e-30)


def card_line() -> str:
    if shutil.which("nvidia-smi"):
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return proc.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0)


def peaks_for(name: str) -> tuple[float, float, str]:
    for key in ("PCIe", "NVL"):
        if key in name:
            return (*_PEAKS[key], key)
    return (*_PEAKS["SXM"], "SXM")


def time_ms(fn, iters: int, warm: int = 2) -> float:
    """Mean device milliseconds per call from CUDA events around ``iters``
    back-to-back calls, after ``warm`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def build_all() -> dict:
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        results = dict(zip(SOURCES, pool.map(_cuda_build.build, SOURCES)))
    seconds = time.perf_counter() - t0
    for name, (path, report) in results.items():
        ptxas = [ln.strip() for ln in report.splitlines() if "registers" in ln or "smem" in ln]
        emit({"phase": "build", "source": f"iq_to_audio_torch/csrc/{name}.cu",
              "library": path.name, "ptxas": ptxas})
    emit({"phase": "build", "seconds": seconds})
    return results


def check_poly_fir(label: str, bandwidth: float, offsets, peaks) -> dict:
    """One geometry of the channelizer at the flagship chunk length."""
    flops_peak, bytes_peak, _ = peaks
    decim, _ = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = design_channel_filter(SAMPLE_RATE, bandwidth, decim)
    incs = [nco_increment_fixed(o, SAMPLE_RATE) for o in offsets]
    kernel_il = interleave_kernel(bandpass_kernel(taps, incs), "iq")
    poly = build_poly_kernel(kernel_il, 2 * decim)
    K, F, out_ch = poly.shape
    m = 161_250  # decimated outputs of the flagship 4,192,500-sample chunk
    n = m * decim
    L = len(taps)
    rng = np.random.default_rng(1234)
    raw = rng.integers(-32768, 32767, 2 * (L - 1) + 2 * n, endpoint=True, dtype=np.int16)
    x = (torch.from_numpy(raw).cuda().to(torch.float32) * (1.0 / 32768.0)).contiguous()
    w = torch.from_numpy(poly).cuda()
    ki = torch.from_numpy(kernel_il).cuda()

    got = poly_fir_il(x, w, decim, m)
    torch.cuda.synchronize()
    want = poly_fir_il_plain(x, w, decim, m)
    torch.cuda.synchronize()

    def library():
        with torch.backends.cudnn.flags(allow_tf32=False):
            return torch.nn.functional.conv1d(x[None, None], ki, stride=2 * decim)[0]

    lib = library()
    torch.cuda.synchronize()
    err = error_db(got.cpu().numpy(), want.cpu().numpy())
    lib_err = error_db(lib.cpu().numpy(), want.cpu().numpy())
    if not err < -100.0:
        raise AssertionError(f"poly_fir_il {label}: {err:.1f} dB against the plain version")
    if not lib_err < -100.0:
        raise AssertionError(f"conv1d yardstick {label}: {lib_err:.1f} dB against plain")
    ms = time_ms(lambda: poly_fir_il(x, w, decim, m), iters=20)
    plain_ms = time_ms(lambda: poly_fir_il_plain(x, w, decim, m), iters=5, warm=1)
    library_ms = time_ms(library, iters=20)
    flops = 2.0 * m * K * F * out_ch
    nbytes = 4.0 * (x.numel() + w.numel() + out_ch * m)
    t_ops, t_bytes = flops / flops_peak, nbytes / bytes_peak
    row = {
        "phase": "kernel_check",
        "geometry": label,
        "taps": L,
        "K": K,
        "F": F,
        "O": out_ch,
        "m": m,
        "k_block": choose_k_block(K, F, out_ch),
        "err_db": err,
        "library_err_db": lib_err,
        "max_abs_err": float((got - want).abs().max()),
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "gflop": flops / 1e9,
        "mbytes": nbytes / 1e6,
    }
    emit(row)
    return row


def check_end_to_end() -> dict:
    poly_fir_il.launches = 0
    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        run_benchmark(
            seconds=SECONDS, sample_rate=SAMPLE_RATE, freq_offset=OFFSET,
            center_freq=None, target_freq=None, base_kwargs={"device": "cuda"},
            warmup=True, results_out=results, workdir=work,
        )
        wall = time.perf_counter() - t0
        launches = poly_fir_il.launches
        # both passes (warm-up and timed) dispatch the same chunks
        if launches != 2 * results["dispatched_chunks"]:
            raise AssertionError(
                f"poly_fir_il launched {launches} times for "
                f"2 x {results['dispatched_chunks']} dispatched chunks"
            )
        audio, rate = read_wav(results["output_path"])
        audio = audio[:, 0]
        if rate != 48_000 or abs(audio.size - SECONDS * 48_000) > 2:
            raise AssertionError(f"audio has {audio.size} samples at {rate} Hz")
        if not np.all(np.isfinite(audio)):
            raise AssertionError("non-finite audio")
        if not -30.0 < results["audio_peak_dbfs"] < 0.0:
            raise AssertionError(f"audio peak {results['audio_peak_dbfs']:.2f} dBFS")
        capture = next(work.glob("benchmark_fc-*.wav"))
        frames, _ = read_wav(capture)
        n_in = int(2.0 * SAMPLE_RATE)
        iq = frames[:n_in, 0].astype(np.float64) + 1j * frames[:n_in, 1]
    decim, fs_ch = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = design_channel_filter(SAMPLE_RATE, 12_500.0, decim)
    audio_ch, _ = ref_demod_chain(
        iq, sample_rate=SAMPLE_RATE, freq_offset=OFFSET, taps=taps, decimation=decim,
        mode="nfm", agc_enabled=True, mix_sign=results["mix_sign"],
    )
    plan = ResamplePlan.create(fs_ch, 48_000.0, 1)
    twin = np.clip(RefResampler(plan.up, plan.down).resample_all(audio_ch), -0.99, 0.99)
    # the twin through the writer's s16 encode and the reader's decode: the
    # unmodulated benchmark carrier demodulates to low-level noise, whose
    # s16 quantisation alone sits near -55 dB of it
    twin_s16 = np.round(twin * 32767.0) / 32768.0
    k = int(1.95 * 48_000)  # the twin's last outputs see zero-padded input
    err = error_db(audio[:k], twin_s16[:k])
    if not err < -60.0:
        raise AssertionError(f"end-to-end audio {err:.1f} dB against the float64 twin")
    row = {
        "phase": "end_to_end",
        "seconds": SECONDS,
        "sample_rate": SAMPLE_RATE,
        "realtime_factor": results["realtime_factor"],
        "elapsed": results["elapsed"],
        "cold_elapsed": results["cold_elapsed"],
        "loop_seconds": results["loop_seconds"],
        "dispatched_chunks": results["dispatched_chunks"],
        "launches": {"poly_fir_il": launches},
        "twin_err_db": err,
        "twin_err_unquantised_db": error_db(audio[:k], twin[:k]),
        "audio_peak_dbfs": results["audio_peak_dbfs"],
        "wall_seconds": wall,
    }
    emit(row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are enabled; the port needs full float32")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    peaks = peaks_for(card)
    emit({"phase": "card", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "peak_part": peaks[2],
          "fp32_flops": peaks[0], "mem_bytes_per_s": peaks[1]})
    build_all()
    flagship = check_poly_fir("flagship C=1", 12_500.0, (OFFSET,), peaks)
    check_poly_fir("C=2", 12_500.0, (OFFSET, -40_000.0), peaks)
    check_poly_fir("long filter K=385", 2_000.0, (OFFSET,), peaks)
    e2e = check_end_to_end()
    emit({"kernels": [{
        "name": "poly_fir_il",
        "route": "cuda",
        "source": "iq_to_audio_torch/csrc/poly_fir.cu",
        "replaces": "iq_to_audio_tpu/ops/pallas_ddc.py:68",
        "also_replaces": "iq_to_audio_tpu/ops/pallas_ddc.py:103",
        "launches": e2e["launches"]["poly_fir_il"],
        "max_abs_err": flagship["max_abs_err"],
        "ms": flagship["kernel_ms"],
        "plain_ms": flagship["plain_ms"],
        "bound_ms": flagship["bound_ms"],
        "bound_by": flagship["bound_by"],
        "library_ms": flagship["library_ms"],
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
