"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every hand-written kernel from ``iq_to_audio_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel against its plain torch version on the card at the
   main paths' shapes (< -100 dB, and two identical launches bit for bit),
   and time the kernel, the plain version and the one PyTorch call that
   computes the same function: the interleaved channelizer at one, two and
   five channels and with a long filter, the pair-input channelizer at one
   and five channels, a wide geometry (25 MS/s, decimation 260) and ragged
   ones (an output count that is no multiple of 4; a pair whose second row
   is 4-byte aligned only);
4. drive each path end to end, with every launch count set to 0 just
   before and read just after:
   a. ``run_benchmark`` on a 10 s synthetic 2.5 MS/s s16 capture with one
      NFM channel; the launches must equal the chunks dispatched, and the
      first 2 s of audio must agree with the package's float64 twin;
   b. six flagship chunks streamed through ``ddc_apply(poly_w=...)``
      (the pair-input kernel), against one whole-signal call and the CPU;
   c. ``run_benchmark`` with five NFM channels (the tap-block loop of the
      interleaved kernel); channels 0 and 4 against the twin;
   d. AM, USB and LSB (AGC off) against the twin, and USB with the AGC on
      against the twin's RMS, on one 10 s capture made here;
   e. a checkpointed run cancelled by a progress sink after ~5 s of input
      and resumed: its WAVs must be byte-identical to an uninterrupted run;
5. the device time of one ``chunk_step`` at one and at five channels (CUDA
   events, then ``torch.profiler`` for the busy time) beside the kernel's
   share of it: last, so that no path above runs with the profiler's
   tracing attached to the process;
6. the ``{"kernels": [...]}`` line, then the card line, then the
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

from iq_to_audio_torch import ProcessingCancelled, ProcessingConfig, ProcessingPipeline
from iq_to_audio_torch.demod import create_decoder
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.ops import _cuda_build
from iq_to_audio_torch.ops.ddc import (
    MASK32,
    DDCPlan,
    bandpass_kernel,
    ddc_apply,
    interleave_kernel,
)
from iq_to_audio_torch.ops.nco import nco_increment_fixed
from iq_to_audio_torch.ops.poly_fir import (
    build_poly_kernel,
    choose_k_block,
    poly_fir_il,
    poly_fir_il_plain,
    poly_fir_pair,
    poly_fir_pair_plain,
)
from iq_to_audio_torch.ops.resample import ResamplePlan, design_resampler_kernel
from iq_to_audio_torch.pipeline.benchmark import run_benchmark
from iq_to_audio_torch.pipeline.filters import compute_decimation, design_channel_filter
from iq_to_audio_torch.pipeline.progress import ProgressSink
from iq_to_audio_torch.pipeline.step import build_chunk_step
from iq_to_audio_torch.ref.chain import RefResampler, ref_demod_chain

SAMPLE_RATE = 2_500_000.0
CENTER = 400_000_000.0
OFFSET = 25_000.0
SECONDS = 10.0
#: hand-written CUDA sources built by this script (csrc/<name>.cu)
SOURCES = ("poly_fir",)
#: every kernel wrapper, with its launch count
WRAPPERS = {"poly_fir_il": poly_fir_il, "poly_fir_pair": poly_fir_pair}
#: decimated outputs of the flagship 4,192,500-sample chunk
FLAGSHIP_M = 161_250
#: seconds of each run held against the float64 twin
TWIN_SECONDS = 2.0

# Data-sheet peaks (dense, no sparsity) by H100 part: FP32 outside the
# tensor cores and TF32 on them in FLOP/s, and device memory in bytes/s.
_PEAKS = {
    "PCIe": (51e12, 378e12, 2.0e12),
    "NVL": (60e12, 417.5e12, 3.9e12),
    "SXM": (67e12, 495e12, 3.35e12),
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


def peaks_for(name: str) -> tuple[float, float, float, str]:
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


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def check_poly_fir(label: str, bandwidth: float, offsets, peaks, layout: str = "il", *,
                   sample_rate: float = SAMPLE_RATE, m: int = FLAGSHIP_M, extra: int = 0) -> dict:
    """One geometry of the channelizer, over the interleaved stream
    (``poly_fir_il``) or an (re, im) pair (``poly_fir_pair``): ``m`` output
    rows (the flagship chunk's by default), ``extra`` samples beyond the
    stream's length (the pair's second row then starts off a 16-byte
    boundary)."""
    fp32_peak, tf32_peak, bytes_peak, _ = peaks
    decim, _ = compute_decimation(sample_rate, 96_000.0)
    taps = design_channel_filter(sample_rate, bandwidth, decim)
    incs = [nco_increment_fixed(o, sample_rate) for o in offsets]
    kernel = bandpass_kernel(taps, incs)
    n = m * decim
    L = len(taps)
    rng = np.random.default_rng(1234)
    if layout == "il":
        kernel = interleave_kernel(kernel, "iq")
        poly = build_poly_kernel(kernel, 2 * decim)
        shape, stride = (2 * (L - 1) + 2 * n + extra,), 2 * decim
        fn, plain = poly_fir_il, poly_fir_il_plain
    else:
        poly = build_poly_kernel(kernel, decim)
        shape, stride = (2, L - 1 + n + extra), decim
        fn, plain = poly_fir_pair, poly_fir_pair_plain
    raw = rng.integers(-32768, 32767, shape, endpoint=True, dtype=np.int16)
    x = (torch.from_numpy(raw).cuda().to(torch.float32) * (1.0 / 32768.0)).contiguous()
    K, F, out_ch = poly.shape
    w = torch.from_numpy(poly).cuda()
    kt = torch.from_numpy(kernel).cuda()
    lib_x = x.reshape(1, -1, shape[-1])

    got = fn(x, w, decim, m)
    again = fn(x, w, decim, m)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{fn.__name__} {label}: two identical launches differ")
    want = plain(x, w, decim, m)
    torch.cuda.synchronize()

    def library():
        with torch.backends.cudnn.flags(allow_tf32=False):
            return torch.nn.functional.conv1d(lib_x, kt, stride=stride)[0, :, :m]

    lib = library()
    torch.cuda.synchronize()
    err = error_db(got.cpu().numpy(), want.cpu().numpy())
    lib_err = error_db(lib.cpu().numpy(), want.cpu().numpy())
    if not err < -100.0:
        raise AssertionError(f"{fn.__name__} {label}: {err:.1f} dB against the plain version")
    if not lib_err < -100.0:
        raise AssertionError(f"conv1d yardstick {label}: {lib_err:.1f} dB against plain")
    ms = time_ms(lambda: fn(x, w, decim, m), iters=50, warm=5)
    plain_ms = time_ms(lambda: plain(x, w, decim, m), iters=5, warm=1)
    library_ms = time_ms(library, iters=20)
    # useful operations only: no zeros of the shifted form, no padding
    flops = 2.0 * m * K * F * out_ch
    nbytes = 4.0 * (x.numel() + w.numel() + out_ch * m)
    t_fp32, t_tf32x3 = flops / fp32_peak, 3.0 * flops / tf32_peak
    t_ops, t_bytes = min(t_fp32, t_tf32x3), nbytes / bytes_peak
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    k_block = choose_k_block(K, F, out_ch, m, sm_count)
    row = {
        "phase": "kernel_check",
        "kernel": fn.__name__,
        "geometry": label,
        "taps": L,
        "K": K,
        "F": F,
        "O": out_ch,
        "m": m,
        "k_block": k_block,
        "err_db": err,
        "library_err_db": lib_err,
        "max_abs_err": float((got - want).abs().max()),
        "bit_identical": True,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_fp32_ms": 1e3 * max(t_fp32, t_bytes),
        "gflop": flops / 1e9,
        "mbytes": nbytes / 1e6,
    }
    emit(row)
    return row


def step_device_time(fn, steps: int) -> tuple[float | None, dict]:
    """Device-busy milliseconds per call of ``fn`` (the sum of all kernels'
    and copies' own device time under ``torch.profiler``) and the six
    largest by name; ``(None, {})`` where the profiler reports no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    per_op = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # an operator's row repeats its kernels' time
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            per_op[ev.key] = per_op.get(ev.key, 0.0) + us / 1e3 / steps
    if not per_op:
        return None, {}
    top = dict(sorted(per_op.items(), key=lambda kv: -kv[1])[:6])
    return sum(per_op.values()), {k[:60]: v for k, v in top.items()}


def time_chunk_step(channels: int, kernel_row: dict) -> dict:
    """Device milliseconds of one flagship ``chunk_step`` (s16 in, NFM,
    s16 audio out) from CUDA events, beside the channelizer kernel's time at
    the same geometry (``kernel_row``, from phase 3)."""
    decim, fs_ch = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = design_channel_filter(SAMPLE_RATE, 12_500.0, decim)
    offsets = [OFFSET + 175_000.0 * c * (-1) ** c for c in range(channels)]
    incs = [nco_increment_fixed(o, SAMPLE_RATE) for o in offsets]
    ddc_plan = DDCPlan(len(taps), decim, FLAGSHIP_M * decim)
    rs_plan = ResamplePlan.create(fs_ch, 48_000.0, ddc_plan.out_size)
    decoder = create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
    decoder.setup(fs_ch)
    step = build_chunk_step(
        ddc_plan=ddc_plan, rs_plan=rs_plan, ddc_kernel_np=bandpass_kernel(taps, incs),
        rs_kernel_np=design_resampler_kernel(rs_plan.up, rs_plan.down), incs_fixed=incs,
        codec="pcm_s16le", iq_order="iq", decoder=decoder, device=torch.device("cuda"),
        est_total_chunks=6,
    )
    rng = np.random.default_rng(99)
    raw = torch.from_numpy(
        rng.integers(-20_000, 20_000, 2 * ddc_plan.chunk_size, dtype=np.int16)
    ).cuda()
    accs = step.init_accs()
    box = {"state": step.init_state()}

    def one():
        box["state"] = step.fn(box["state"], accs, raw, 0, 0)

    reset_counts()
    ms = time_ms(one, iters=10)
    launches = read_counts()["poly_fir_il"]
    if launches != 12 or not torch.isfinite(box["state"]["peak"]).all():
        raise AssertionError(f"chunk_step C={channels}: {launches} launches, peak not finite")
    busy_ms, top = step_device_time(one, steps=5)
    row = {
        "phase": "chunk_step",
        "channels": channels,
        "m": FLAGSHIP_M,
        "chunk_step_ms": ms,
        "kernel_ms": kernel_row["kernel_ms"],
        "kernel_share": kernel_row["kernel_ms"] / ms,
        "launches_timed": launches,
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else max(0.0, 1.0 - busy_ms / ms),
        "top_device_ops_ms": top,
    }
    emit(row)
    return row


def twin_audio(iq: np.ndarray, offset: float, mode: str, agc: bool, mix_sign: int):
    """The float64 twin's 48 kHz audio, and the same passed through the
    writer's s16 encode and the reader's decode."""
    decim, fs_ch = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = design_channel_filter(SAMPLE_RATE, 12_500.0, decim)
    audio_ch, _ = ref_demod_chain(
        iq, sample_rate=SAMPLE_RATE, freq_offset=offset, taps=taps, decimation=decim,
        mode=mode, agc_enabled=agc, mix_sign=mix_sign,
    )
    plan = ResamplePlan.create(fs_ch, 48_000.0, 1)
    twin = np.clip(RefResampler(plan.up, plan.down).resample_all(audio_ch), -0.99, 0.99)
    return twin, np.round(twin * 32767.0) / 32768.0


def head_iq(capture: Path) -> np.ndarray:
    """The first ``TWIN_SECONDS`` of a capture as complex128."""
    frames, _ = read_wav(capture)
    n_in = int(TWIN_SECONDS * SAMPLE_RATE)
    return frames[:n_in, 0].astype(np.float64) + 1j * frames[:n_in, 1]


def twin_err_db(audio: np.ndarray, iq: np.ndarray, offset: float, mode: str, agc: bool,
                mix_sign: int) -> tuple[float, float]:
    """Error of the first ~2 s of ``audio`` against the s16-quantised twin
    (and against the unquantised twin)."""
    twin, twin_s16 = twin_audio(iq, offset, mode, agc, mix_sign)
    k = int((TWIN_SECONDS - 0.05) * 48_000)  # the twin's last outputs see zero-padded input
    return error_db(audio[:k], twin_s16[:k]), error_db(audio[:k], twin[:k])


def check_end_to_end() -> dict:
    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        t0 = time.perf_counter()
        reset_counts()
        run_benchmark(
            seconds=SECONDS, sample_rate=SAMPLE_RATE, freq_offset=OFFSET,
            center_freq=None, target_freq=None, base_kwargs={"device": "cuda"},
            warmup=True, results_out=results, workdir=work,
        )
        launches = read_counts()
        wall = time.perf_counter() - t0
        # both passes (warm-up and timed) dispatch the same chunks
        if launches["poly_fir_il"] != 2 * results["dispatched_chunks"]:
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
        iq = head_iq(next(work.glob("benchmark_fc-*.wav")))
    # the unmodulated benchmark carrier demodulates to low-level noise, whose
    # s16 quantisation alone sits near -55 dB of it: compare with the twin
    # passed through the same encode
    err, err_raw = twin_err_db(audio, iq, OFFSET, "nfm", True, results["mix_sign"])
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
        "launches": launches,
        "twin_err_db": err,
        "twin_err_unquantised_db": err_raw,
        "audio_peak_dbfs": results["audio_peak_dbfs"],
        "wall_seconds": wall,
    }
    emit(row)
    return row


def check_ddc_apply(chunks: int = 6) -> dict:
    """Flagship chunks streamed through the pair-input entry point with the
    tail and phase carried, against one whole-signal call on the card and
    the same stream through the CPU's plain path."""
    decim, _ = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = design_channel_filter(SAMPLE_RATE, 12_500.0, decim)
    L = len(taps)
    plan = DDCPlan(L, decim, FLAGSHIP_M * decim)
    n = plan.chunk_size
    inc = nco_increment_fixed(OFFSET, SAMPLE_RATE)
    kernel = bandpass_kernel(taps, [inc])
    poly = build_poly_kernel(kernel, decim)
    rng = np.random.default_rng(77)
    t = np.arange(chunks * n, dtype=np.float64) / SAMPLE_RATE
    tone = 0.5 * np.exp(2j * math.pi * (OFFSET + 1_000.0) * t)
    x_np = np.stack([tone.real, tone.imag]).astype(np.float32)
    x_np += rng.normal(scale=0.02, size=x_np.shape).astype(np.float32)

    def stream(device: torch.device):
        x = torch.from_numpy(x_np).to(device)
        k = torch.from_numpy(kernel).to(device)
        w = torch.from_numpy(poly).to(device)
        inc_lo = torch.tensor([(inc * decim) & MASK32], dtype=torch.int64, device=device)
        tail = torch.zeros((2, L - 1), dtype=torch.float32, device=device)
        phase = torch.zeros(1, dtype=torch.int64, device=device)
        parts = []
        for c in range(chunks):
            xr, xi = x[0, c * n : (c + 1) * n], x[1, c * n : (c + 1) * n]
            yr, yi, tail, phase = ddc_apply(plan, k, xr, xi, tail, phase, inc_lo, poly_w=w)
            parts.append(torch.stack([yr, yi]))
        return torch.cat(parts, dim=-1), phase, (x, k, w, inc_lo)

    reset_counts()
    t0 = time.perf_counter()
    got, phase, (x, k, w, inc_lo) = stream(torch.device("cuda"))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if launches["poly_fir_pair"] != chunks:
        raise AssertionError(f"poly_fir_pair launched {launches} times for {chunks} chunks")
    whole_plan = DDCPlan(L, decim, chunks * n)
    zeros = torch.zeros((2, L - 1), dtype=torch.float32, device=x.device)
    phase0 = torch.zeros(1, dtype=torch.int64, device=x.device)
    wr, wi, _, wphase = ddc_apply(whole_plan, k, x[0], x[1], zeros, phase0, inc_lo, poly_w=w)
    whole = torch.stack([wr, wi]).cpu().numpy()
    cpu, cpu_phase, _ = stream(torch.device("cpu"))
    got_np = got.cpu().numpy()
    err_whole = error_db(got_np, whole)
    err_cpu = error_db(got_np, cpu.numpy())
    if not (err_whole < -100.0 and err_cpu < -100.0):
        raise AssertionError(
            f"ddc_apply stream: {err_whole:.1f} dB against the whole call, "
            f"{err_cpu:.1f} dB against the CPU"
        )
    if not (torch.equal(phase.cpu(), wphase.cpu()) and torch.equal(phase.cpu(), cpu_phase)):
        raise AssertionError("ddc_apply stream: carried phase differs")
    if not np.all(np.isfinite(got_np)) or got_np.shape != (2, 1, chunks * FLAGSHIP_M):
        raise AssertionError(f"ddc_apply stream: output {got_np.shape} not finite/shaped")
    row = {
        "phase": "ddc_apply_stream",
        "chunks": chunks,
        "m_per_chunk": FLAGSHIP_M,
        "launches": launches,
        "err_vs_whole_db": err_whole,
        "err_vs_cpu_db": err_cpu,
        "seconds": seconds,
    }
    emit(row)
    return row


def check_batch(channels: int = 5) -> dict:
    """``run_benchmark`` with five NFM channels through one channelizer
    pass per chunk (O = 10 outputs per row)."""
    results: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        reset_counts()
        run_benchmark(
            seconds=SECONDS, sample_rate=SAMPLE_RATE, freq_offset=OFFSET,
            center_freq=None, target_freq=None, channels=channels,
            base_kwargs={"device": "cuda"}, warmup=True, results_out=results, workdir=work,
        )
        launches = read_counts()
        if launches["poly_fir_il"] != 2 * results["dispatched_chunks"]:
            raise AssertionError(
                f"batch: poly_fir_il launched {launches} times for "
                f"2 x {results['dispatched_chunks']} dispatched chunks"
            )
        paths = results["output_paths"]
        if len(paths) != channels:
            raise AssertionError(f"batch: {len(paths)} outputs for {channels} channels")
        audio = []
        for p in paths:
            a, rate = read_wav(p)
            a = a[:, 0]
            if rate != 48_000 or abs(a.size - SECONDS * 48_000) > 2 or not np.all(np.isfinite(a)):
                raise AssertionError(f"batch: {p.name} has {a.size} samples at {rate} Hz")
            audio.append(a)
        iq = head_iq(next(work.glob("benchmark_fc-*.wav")))
    errs = {}
    for c in (0, channels - 1):
        off = results["freq_offsets"][c]
        err, err_raw = twin_err_db(audio[c], iq, off, "nfm", True, results["mix_sign"])
        if not err < -60.0:
            raise AssertionError(f"batch channel {c}: {err:.1f} dB against the float64 twin")
        errs[str(c)] = {"offset": off, "twin_err_db": err, "twin_err_unquantised_db": err_raw}
    row = {
        "phase": "batch",
        "channels": channels,
        "realtime_factor": results["realtime_factor"],
        "elapsed": results["elapsed"],
        "cold_elapsed": results["cold_elapsed"],
        "loop_seconds": results["loop_seconds"],
        "dispatched_chunks": results["dispatched_chunks"],
        "launches": launches,
        "twin": errs,
    }
    emit(row)
    return row


#: the modes capture: (target offset, tone offset, amplitude).  The SSB
#: targets sit on the NCO's grid (multiples of 2.5e6 / 2**32 * 2**27 =
#: 78,125 Hz), where the uint32 increment is exact: off the grid the NCO
#: runs up to 3e-4 Hz away from the twin's float64 oscillator, and the
#: demodulated tone's phase drifts from the twin's by -50 dB over 2 s.
MODE_SIGNALS = {
    "am": (25_000.0, 25_000.0, 0.22),  # 800 Hz tone at 60% modulation
    "usb": (-234_375.0, -233_375.0, 0.15),
    "lsb": (312_500.0, 311_500.0, 0.15),
    "usb_quiet": (468_750.0, 469_750.0, 0.03),  # the AGC pulls it up
}


def make_modes_capture(path: Path) -> None:
    """A 10 s 2.5 MS/s s16 capture holding an AM carrier, an upper- and a
    lower-sideband tone and a quiet upper-sideband tone, each in its own
    channel, over seeded Gaussian noise."""
    n = int(SECONDS * SAMPLE_RATE)
    t = np.arange(n, dtype=np.float64) / SAMPLE_RATE
    iq = np.zeros(n, np.complex128)
    _, am_tone, am_amp = MODE_SIGNALS["am"]
    envelope = am_amp * (1.0 + 0.6 * np.sin(2.0 * math.pi * 800.0 * t))
    iq += envelope * np.exp(2j * math.pi * am_tone * t)
    for key in ("usb", "lsb", "usb_quiet"):
        _, tone, amp = MODE_SIGNALS[key]
        iq += amp * np.exp(1j * (2.0 * math.pi * tone * t + 0.3))
    rng = np.random.default_rng(5)
    frames = np.empty((n, 2), np.float32)
    frames[:, 0] = iq.real + rng.normal(scale=0.002, size=n)
    frames[:, 1] = iq.imag + rng.normal(scale=0.002, size=n)
    np.clip(frames, -0.999, 0.999, out=frames)
    write_stereo_wav(path, frames, int(SAMPLE_RATE), codec="pcm_s16le")


def run_path(capture: Path, out: Path, offsets, mode: str, agc: bool, sink=None, **kw):
    """One ``ProcessingPipeline.run`` on the card with the launch counts
    set to 0 just before; returns ``(result, launches)``."""
    cfg = ProcessingConfig(
        in_path=capture, target_freq=CENTER + offsets[0],
        extra_target_freqs=[CENTER + o for o in offsets[1:]], center_freq=CENTER,
        demod_mode=mode, agc_enabled=agc, output_path=out, device="cuda", **kw,
    )
    reset_counts()
    result = ProcessingPipeline(cfg).run(sink)
    launches = read_counts()
    if launches["poly_fir_il"] != result.dispatched_chunks or result.dispatched_chunks <= 0:
        raise AssertionError(
            f"{mode}: poly_fir_il launched {launches} times for "
            f"{result.dispatched_chunks} dispatched chunks"
        )
    return result, launches


def check_modes(capture: Path, work: Path) -> dict:
    iq = head_iq(capture)
    rows = {}
    for key, mode, agc in (("am", "am", True), ("usb", "usb", False), ("lsb", "lsb", False)):
        off = MODE_SIGNALS[key][0]
        result, launches = run_path(capture, work / f"mode_{key}.wav", [off], mode, agc)
        audio = read_wav(result.output_paths[0])[0][:, 0]
        if abs(audio.size - SECONDS * 48_000) > 2 or not np.all(np.isfinite(audio)):
            raise AssertionError(f"{key}: {audio.size} audio samples")
        err, err_raw = twin_err_db(audio, iq, off, mode, agc, result.mix_sign)
        if not err < -60.0:
            raise AssertionError(f"{key}: {err:.1f} dB against the float64 twin")
        rows[key] = {"twin_err_db": err, "twin_err_unquantised_db": err_raw,
                     "launches": launches, "loop_seconds": result.loop_seconds,
                     "peak": result.audio_peak}
    off = MODE_SIGNALS["usb_quiet"][0]
    result, launches = run_path(capture, work / "mode_usb_agc.wav", [off], "usb", True)
    audio = read_wav(result.output_paths[0])[0][:, 0]
    twin, _ = twin_audio(iq, off, "usb", True, result.mix_sign)
    k = int((TWIN_SECONDS - 0.05) * 48_000)
    half = slice(k // 2, k)
    rms_got = float(np.sqrt(np.mean(audio[half].astype(np.float64) ** 2)))
    rms_twin = float(np.sqrt(np.mean(twin[half] ** 2)))
    if not abs(rms_got / rms_twin - 1.0) < 0.05:
        raise AssertionError(f"usb AGC: RMS {rms_got:.4f} against the twin's {rms_twin:.4f}")
    rows["usb_agc"] = {"rms": rms_got, "twin_rms": rms_twin, "rms_ratio": rms_got / rms_twin,
                       "launches": launches, "loop_seconds": result.loop_seconds}
    row = {"phase": "modes", **rows}
    emit(row)
    return row


class CancelAfter(ProgressSink):
    """Cancels the run once ``threshold`` input samples were ingested."""

    def __init__(self, threshold: float):
        self.threshold = threshold
        self.ingested = 0.0
        self._cb = None

    def start(self, phases, *, overall_total):
        pass

    def advance(self, phase, delta, *, overall_completed, overall_total):
        if phase.key == "ingest":
            self.ingested += delta
            if self.ingested >= self.threshold and self._cb is not None:
                self._cb()

    def status(self, message):
        pass

    def close(self):
        pass

    def cancel(self):
        pass

    def set_cancel_callback(self, callback):
        self._cb = callback


def check_resume(capture: Path, work: Path) -> dict:
    """Two USB channels with the AGC on (the most carried state): an
    uninterrupted run, then a run with ``checkpoint_secs=2`` cancelled after
    ~5 s of input, then its resume."""
    offsets = [MODE_SIGNALS["usb"][0], MODE_SIGNALS["usb_quiet"][0]]
    ref, ref_launches = run_path(capture, work / "ref.wav", offsets, "usb", True)
    out = work / "resumed.wav"
    sink = CancelAfter(5.0 * SAMPLE_RATE)
    reset_counts()
    try:
        run_path(capture, out, offsets, "usb", True, sink=sink, checkpoint_secs=2.0)
    except ProcessingCancelled:
        pass
    else:
        raise AssertionError("resume: the progress sink did not cancel the run")
    cancelled_launches = read_counts()
    ckpts = list(work.glob("*.ckpt"))
    if len(ckpts) != 1 or cancelled_launches["poly_fir_il"] <= 0:
        raise AssertionError(f"resume: checkpoints {ckpts}, launches {cancelled_launches}")
    result, resume_launches = run_path(
        capture, out, offsets, "usb", True, checkpoint_secs=2.0, resume=True
    )
    if list(work.glob("*.ckpt")):
        raise AssertionError("resume: the checkpoint outlived the completed run")
    identical = [a.read_bytes() == b.read_bytes()
                 for a, b in zip(ref.output_paths, result.output_paths)]
    if len(identical) != 2 or not all(identical):
        raise AssertionError(f"resume: WAVs byte-identical per channel: {identical}")
    row = {
        "phase": "resume",
        "channels": len(offsets),
        "cancelled_after_samples": sink.ingested,
        "resumed_chunks": result.dispatched_chunks,
        "uninterrupted_chunks": ref.dispatched_chunks,
        "launches": {"uninterrupted": ref_launches, "cancelled": cancelled_launches,
                     "resumed": resume_launches},
        "byte_identical": identical,
        "input_samples": result.input_samples,
    }
    emit(row)
    return row


def kernel_entry(name: str, replaces: str, launches: int, row: dict, **extra) -> dict:
    return {
        "name": name,
        "route": "cuda",
        "source": "iq_to_audio_torch/csrc/poly_fir.cu",
        "replaces": replaces,
        **extra,
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["kernel_ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "bound_fp32_ms": row["bound_fp32_ms"],
        "library_ms": row["library_ms"],
    }


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
          "cuda": torch.version.cuda, "peak_part": peaks[3],
          "fp32_flops": peaks[0], "tf32_flops": peaks[1], "mem_bytes_per_s": peaks[2]})
    build_all()
    flagship = check_poly_fir("flagship C=1", 12_500.0, (OFFSET,), peaks)
    check_poly_fir("C=2", 12_500.0, (OFFSET, -40_000.0), peaks)
    five = [OFFSET, 175_000.0, -350_000.0, 525_000.0, -700_000.0]
    batch = check_poly_fir("C=5", 12_500.0, five, peaks)
    check_poly_fir("long filter K=385", 2_000.0, (OFFSET,), peaks)
    pair = check_poly_fir("pair C=1", 12_500.0, (OFFSET,), peaks, layout="pair")
    check_poly_fir("pair C=5", 12_500.0, five, peaks, layout="pair")
    # 25 MS/s at the 96 kHz channel target: 520 features per row
    check_poly_fir("wide D=260", 12_500.0, (OFFSET,), peaks, sample_rate=25e6, m=16_125)
    check_poly_fir("ragged m=161249", 12_500.0, (OFFSET,), peaks, m=161_249, extra=3)
    check_poly_fir("pair ragged, row 4-byte aligned", 12_500.0, (OFFSET,), peaks,
                   layout="pair", m=161_249, extra=1)
    e2e = check_end_to_end()
    stream = check_ddc_apply()
    check_batch()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        capture = work / "modes.wav"
        make_modes_capture(capture)
        check_modes(capture, work)
        check_resume(capture, work)
    time_chunk_step(1, flagship)
    time_chunk_step(5, batch)
    emit({"kernels": [
        kernel_entry(
            "poly_fir_il", "iq_to_audio_tpu/ops/pallas_ddc.py:68",
            e2e["launches"]["poly_fir_il"], flagship,
            also_replaces="iq_to_audio_tpu/ops/pallas_ddc.py:103",
        ),
        kernel_entry(
            "poly_fir_pair", "iq_to_audio_tpu/ops/pallas_ddc.py:313",
            stream["launches"]["poly_fir_pair"], pair,
        ),
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
