"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line; any failed check raises and the
script exits non-zero:

1. the card's name and power limit (``nvidia-smi``);
2. build every hand-written kernel from ``iq_to_audio_torch/csrc`` (one
   ``nvcc`` per source, all started together);
3. the mixer-sign probe (``csrc/mix_probe.cu``) on NFM and USB warm-up
   blocks (1,601 and 7,143 taps) against the host's float64 twin: the same
   sign, powers within 1e-10 relative, 20 calls bit for bit alike; its
   call and bound times beside the twin's;
   then hold each channelizer kernel against its plain torch version on
   the card at the main paths' shapes (< -100 dB, and two identical launches bit for bit),
   and time the kernel, the plain version and the one PyTorch call that
   computes the same function (``conv1d``), beside the port's two other
   library formulations of it (the shifted dense matmul on cuBLAS, the
   overlap-save FFT bank on cuFFT; a pair input interleaved inside their
   time): the interleaved channelizer at one, two and five channels and
   with a long filter, the pair-input channelizer at one and five channels,
   a wide geometry (25 MS/s, decimation 260) and ragged ones (an output
   count that is no multiple of 4; a pair whose second row is 4-byte
   aligned only);
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
      against the twin's RMS, on one 5 s capture made here;
   e. a checkpointed run cancelled by a progress sink after ~2.5 s of input
      and resumed: its WAVs must be byte-identical to an uninterrupted run;
5. one flagship chunk (one and five channels) through every channelizer
   formulation of the port on the card: the hand kernel, the plain
   ``conv1d``, the lane-filling J-conv, the shifted dense matmul and the
   overlap-save FFT bank, each held against the hand kernel's output
   (< -100 dB; the FFT bank < -90 dB) and timed with CUDA events;
6. the other run modes on the flagship capture, each with the launch counts
   set to 0 just before and read just after: a plain run (the reference
   bytes), pass-through (``demod_mode="none"``) against the float64 twin's
   DDC output, audio plus IQ dump in one run (audio byte-identical to the
   plain run's, the dump against the twin), the stage snapshots of chunk 0
   (``decimated`` bit for bit the hot path's output, ``filtered[::D]``
   against it, ``mixed`` and ``filtered`` against the twin), the run with
   ``IQ2A_CHANNELIZER=fft`` (no launch of the hand kernel, audio < -60 dB
   against the plain run), and the command line as a subprocess (a run
   whose WAV is byte-identical to the plain run's, and ``--benchmark``),
   the sequence-parallel run on a world of one (``run_captures_dp`` on an
   in-process one-rank NCCL group: at least one hand-kernel launch per
   chunk, audio < -55 dB against the plain run and < -60 dB against the
   twin, and ``--seq-parallel on`` as a subprocess, its WAV byte-identical
   to the API run's), two ``--in`` without burst mode (run in turn on
   one card, each WAV byte-identical to the plain run's), and the
   interactive session in this process on the headless toolkit
   (``check_interactive``: the GUI's 2 s snapshot at nfft 262,144 on the
   card against the host's FFT, the window when matplotlib imports, the
   preview at one and five targets through ``PreviewWorker`` with one
   hand-kernel launch per chunk and WAVs byte-identical to ``run_preview``,
   the confirmed config byte-identical to the plain run, and the
   audio-post worker byte-identical to ``--audio-post`` streaming in a
   subprocess);
7. the spectral analysis at its defaults (the card) against the host's
   float64 FFT, and ``measure_step_resident_msps`` at one and five channels
   (CUDA-graph replays, within 0.5-1.05x of the rate the profiler's
   device-busy time implies);
   then burst mode on the flagship capture (``HeteroExecutor`` with one
   host-CPU worker over eight segments, twice on one executor, each with the
   launch counts set to 0 just before): the device must take segments
   through the hand kernel and the spliced audio must agree with the plain
   run and the twin (< -60 dB); the device stream alone; and the executor's
   resident-compute probe of the kernel;
8. the device time of the mixer-sign probe's kernels (``torch.profiler``),
   the device time of one ``chunk_step`` at one and at five channels (CUDA
   events, then ``torch.profiler`` for the busy time) beside the kernel's
   share of it, and last a run with ``profile_dir`` (its trace must hold
   one device event of the hand kernel per chunk dispatched): these come
   last, so that no path above runs with the profiler's tracing
   attached to the process;
9. the ``{"kernels": [...]}`` line, then the card line, then the
   ``{"ok": true, ...}`` line.

It imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
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
from iq_to_audio_torch.analysis import compute_psd, streaming_waterfall
from iq_to_audio_torch.demod import create_decoder
from iq_to_audio_torch.io.writer import read_wav, write_stereo_wav
from iq_to_audio_torch.ops import _cuda_build
from iq_to_audio_torch.ops.mix_probe import (
    choose_tile,
    mix_sign_powers,
    mix_sign_powers_plain,
    probe_geometry,
)
from iq_to_audio_torch.ops.ddc import (
    DDCPlan,
    bandpass_kernel,
    bank_from_kernel,
    complex_from_interleaved,
    ddc_apply,
    fir_il,
    interleave_kernel,
    j_lanes_kernel,
    shift_matmul_kernel,
)
from iq_to_audio_torch.ops.nco import (
    device_increment,
    nco_increment_fixed,
    nco_increment_residual,
)
from iq_to_audio_torch.ops.osfir import OverlapSavePlan, os_fir_bank
from iq_to_audio_torch.ops.poly_fir import (
    build_poly_kernel,
    choose_k_block,
    poly_fir_il,
    poly_fir_il_plain,
    poly_fir_pair,
    poly_fir_pair_plain,
)
from iq_to_audio_torch.ops.resample import ResamplePlan, design_resampler_kernel
from iq_to_audio_torch.pipeline.benchmark import (
    generate_synthetic_iq,
    measure_step_resident_msps,
    run_benchmark,
)
from iq_to_audio_torch.pipeline.filters import compute_decimation, design_channel_filter
from iq_to_audio_torch.pipeline.progress import ProgressSink
from iq_to_audio_torch.pipeline.step import build_chunk_step
from iq_to_audio_torch.ref.chain import (
    RefOscillator,
    RefOverlapSaveFIR,
    RefResampler,
    mix_sign_powers as twin_mix_sign_powers,
    pick_mix_sign,
    ref_demod_chain,
)

SAMPLE_RATE = 2_500_000.0
CENTER = 400_000_000.0
OFFSET = 25_000.0
SECONDS = 10.0
#: length of the capture of the mode and resume paths (three flagship chunks)
MODES_SECONDS = 5.0
#: hand-written CUDA sources built by this script (csrc/<name>.cu)
SOURCES = ("poly_fir", "mix_probe")
#: every kernel wrapper, with its launch count
WRAPPERS = {
    "poly_fir_il": poly_fir_il,
    "poly_fir_pair": poly_fir_pair,
    "mix_sign_powers": mix_sign_powers,
}
#: decimated outputs of the flagship 4,192,500-sample chunk
FLAGSHIP_M = 161_250
#: seconds of each run held against the float64 twin
TWIN_SECONDS = 2.0
#: s16 steps by which the FFT channelizer's run may differ from the hand
#: kernel's at any audio sample of the flagship WAV, start-up included.  Their
#: channel outputs agree to -127 dB, but the unmodulated carrier's filter
#: start-up passes near zero, where the discriminator turns either run's
#: rounding into steps at one sample: 36 on an H100, where a one-sample
#: framing fault reads 2,498.  It is this capture's reading: on other captures
#: the start-up lands within 2-72 steps or flips by 2*pi (about 7,090), with
#: the JAX package's uint32 NCO as with the port's (PERF.md, section 6).
FFT_AUDIO_STEPS = 256

# Data-sheet peaks (dense, no sparsity) by H100 part: FP32 outside the
# tensor cores and TF32 on them in FLOP/s, and device memory in bytes/s.
_PEAKS = {
    "PCIe": (51e12, 378e12, 2.0e12),
    "NVL": (60e12, 417.5e12, 3.9e12),
    "SXM": (67e12, 495e12, 3.35e12),
}
#: float64 outside the tensor cores, FLOP/s, by H100 part (the mixer-sign probe's peak)
_FP64_PEAKS = {"PCIe": 25.6e12, "NVL": 30e12, "SXM": 34e12}


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line also says how many seconds into the
    script it was printed (``at_s``)."""
    if "phase" in obj:
        obj = {**obj, "at_s": round(time.perf_counter() - _T0, 3)}
    print(json.dumps(obj), flush=True)


def error_db(test: np.ndarray, ref: np.ndarray) -> float:
    kind = np.complex128 if np.iscomplexobj(test) or np.iscomplexobj(ref) else np.float64
    test = np.asarray(test, kind)
    ref = np.asarray(ref, kind)
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
    kernel = pair_np = bandpass_kernel(taps, incs)
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
    formulations = library_formulations(x, layout, pair_np, decim, m, L, want, label)
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
        **formulations,
    }
    emit(row)
    return row


def check_mix_probe(peaks, mode: str, carrier: int) -> dict:
    """The mixer-sign probe (``csrc/mix_probe.cu``) on one 2.5 MS/s s16 warm-up
    block against the host twin: the same sign, both powers within 1e-10
    relative, 20 calls bit for bit alike; then its host times: the wrapper's
    wall per call (upload, two launches, the copy back of two doubles), the
    twin's and the plain form's (CPU).  Its device time comes later
    (:func:`time_mix_probe`), with the other profiled phases."""
    bandwidth = {"nfm": 12_500.0, "usb": 2_800.0}[mode]
    offset = 175_000.0
    decim, _ = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = design_channel_filter(SAMPLE_RATE, bandwidth, decim)
    rng = np.random.default_rng([len(taps), carrier + 1])
    n = 140_000
    iq = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    if carrier:
        iq += 0.4 * np.exp(2j * np.pi * carrier * offset * np.arange(n) / SAMPLE_RATE)
    raw = np.round(np.column_stack([iq.real, iq.imag]).reshape(-1) * 32767.0).astype(np.int16)
    warm = (raw.astype(np.float32) * np.float32(1.0 / 32768.0)).view(np.complex64)
    dev = torch.device("cuda")
    args = (warm, SAMPLE_RATE, offset, taps, decim)

    def timed(fn, calls):
        walls = []
        for _ in range(calls):
            t0 = time.perf_counter()
            out = fn()
            walls.append(time.perf_counter() - t0)
        return out, 1e3 * float(np.median(walls))

    reset_counts()
    got = mix_sign_powers(*args, dev)
    runs = {mix_sign_powers(*args, dev) for _ in range(20)}
    want, twin_ms = timed(lambda: twin_mix_sign_powers(*args), 3)
    plain, plain_ms = timed(lambda: mix_sign_powers_plain(*args), 3)
    rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
    if runs != {got} or pick_mix_sign(got) != pick_mix_sign(want) or not rel <= 1e-10:
        raise AssertionError(f"mix probe {mode} {carrier:+d}: {got} against the twin's {want}")
    if carrier and pick_mix_sign(got) != carrier:
        raise AssertionError(f"mix probe {mode} {carrier:+d}: sign {pick_mix_sign(got)}")
    if read_counts()["mix_sign_powers"] != 21:
        raise AssertionError(f"mix probe: {read_counts()} launches for 21 calls")
    _, call_ms = timed(lambda: mix_sign_powers(*args, dev), 20)
    n_snip, _, k, first = probe_geometry(warm.size, SAMPLE_RATE, len(taps), decim)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    m, tc = choose_tile(k - first, len(taps), decim, sm_count)
    fp64 = _FP64_PEAKS[peaks[3]]
    flops = 2.0 * (k - first) * len(taps) * 4.0
    nbytes = 8.0 * (n_snip + len(taps)) + 16.0
    t_ops, t_bytes = flops / fp64, nbytes / peaks[2]
    row = {
        "phase": "mix_probe",
        "mode": mode,
        "carrier": carrier,
        "taps": len(taps),
        "snippet": n_snip,
        "outputs_per_sign": k - first,
        "tile": [m, tc],
        "powers": list(got),
        "twin_powers": list(want),
        "plain_powers": list(plain),
        "max_rel_err": rel,
        "sign": pick_mix_sign(got),
        "bit_identical_20": True,
        "call_ms": call_ms,
        "twin_ms": twin_ms,
        "plain_cpu_ms": plain_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "float64 operations" if t_ops >= t_bytes else "bytes",
        "fp64_flops": fp64,
    }
    emit(row)
    return {**row, "args": args}


def time_mix_probe(probe: dict) -> dict:
    """The device time of one :func:`check_mix_probe` call under the
    profiler: its two kernels, and everything the call puts on the card."""
    args = probe["args"]
    busy_ms, top = step_device_time(
        lambda: mix_sign_powers(*args, torch.device("cuda")), steps=10
    )
    kernel_ms = sum(v for k, v in top.items() if "mix_probe" in k)
    row = {
        "phase": "mix_probe_time",
        "mode": probe["mode"],
        "taps": probe["taps"],
        "kernel_ms": kernel_ms if kernel_ms > 0 else None,
        "device_busy_ms": busy_ms,
        "top_device_ops_ms": top,
        "bound_ms": probe["bound_ms"],
    }
    emit(row)
    return row


def library_formulations(x, layout: str, pair_np, decim: int, m: int, L: int, want, label: str) -> dict:
    """The channelizer's function through the two library formulations of
    the port, on a ``kernel_check`` row's input: the shifted dense matmul
    (cuBLAS, ``fir_il(mm_kernel=...)``) and the overlap-save FFT bank
    (cuFFT, ``os_fir_bank``), each held against the plain version's output
    and timed with CUDA events.  Both read the interleaved stream, so for a
    pair input the one interleave of the ``(2, T)`` relay they need is
    inside their time."""
    n = m * decim
    kil_np = interleave_kernel(pair_np, "iq")
    j = min(max(1, 128 // kil_np.shape[0]), m)
    mm = torch.from_numpy(shift_matmul_kernel(kil_np, decim, j)).cuda()
    os_plan = OverlapSavePlan.for_chunk(L, decim, n)  # power-of-two framing on the card
    bank = torch.from_numpy(bank_from_kernel(pair_np, os_plan)).cuda()
    rows = L - 1 + n

    def stream():
        if layout == "il":
            return x[: 2 * rows]  # the stream without the floats beyond it
        return torch.stack([x[0, :rows], x[1, :rows]], dim=-1).reshape(-1)

    def shift_matmul():
        return fir_il(stream(), decim, m, L, mm_kernel=mm, j_lanes=j)

    def fft_bank():
        xc = complex_from_interleaved(stream(), "iq")
        dec, _ = os_fir_bank(os_plan, bank, xc[L - 1 :], xc[: L - 1])
        return torch.view_as_real(dec).permute(0, 2, 1).reshape(-1, m)  # (2C, m)

    out = {"mm_j_lanes": j, "fft_size": os_plan.fft_size}
    want_np = want.cpu().numpy()
    for name, fn, limit in (("shift_matmul", shift_matmul, -100.0), ("fft_bank", fft_bank, -90.0)):
        got = fn()
        torch.cuda.synchronize()
        err = error_db(got.cpu().numpy(), want_np)
        if tuple(got.shape) != tuple(want.shape) or not err < limit:
            raise AssertionError(f"{name} {label}: {tuple(got.shape)}, {err:.1f} dB against plain")
        out[f"{name}_err_db"] = err
        out[f"{name}_ms"] = time_ms(fn, iters=10, warm=2)
    return out


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
        if launches["mix_sign_powers"] != 2:  # one mixer-sign probe a pass
            raise AssertionError(f"mix_sign_powers launched {launches} times for 2 passes")
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
    inc, res = nco_increment_fixed(OFFSET, SAMPLE_RATE), nco_increment_residual(OFFSET, SAMPLE_RATE)
    kernel = bandpass_kernel(taps, [inc], [res])
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
        inc_lo = torch.tensor(
            [device_increment(inc, res, decim)], dtype=torch.int64, device=device
        )
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
#: 78,125 Hz), where the uint32 increment is exact; off the grid the
#: pipeline's 62-bit NCO (``ops/nco.py``) mixes at the exact frequency too,
#: which ``tests/test_torch_ssb_reference.py`` holds to the float64 reference.
MODE_SIGNALS = {
    "am": (25_000.0, 25_000.0, 0.22),  # 800 Hz tone at 60% modulation
    "usb": (-234_375.0, -233_375.0, 0.15),
    "lsb": (312_500.0, 311_500.0, 0.15),
    "usb_quiet": (468_750.0, 469_750.0, 0.03),  # the AGC pulls it up
}


def make_modes_capture(path: Path) -> None:
    """A ``MODES_SECONDS`` 2.5 MS/s s16 capture holding an AM carrier, an upper- and a
    lower-sideband tone and a quiet upper-sideband tone, each in its own
    channel, over seeded Gaussian noise."""
    n = int(MODES_SECONDS * SAMPLE_RATE)
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


def run_path(capture: Path, out: Path, offsets, mode: str, agc: bool, sink=None,
             hand_kernel: bool = True, **kw):
    """One ``ProcessingPipeline.run`` on the card with the launch counts
    set to 0 just before; returns ``(result, launches)``.  The hand kernel
    must have launched once per dispatched chunk, or (``hand_kernel=False``,
    a run pinned to another channelizer) not at all."""
    cfg = ProcessingConfig(
        in_path=capture, target_freq=CENTER + offsets[0],
        extra_target_freqs=[CENTER + o for o in offsets[1:]], center_freq=CENTER,
        demod_mode=mode, agc_enabled=agc, output_path=out, device="cuda", **kw,
    )
    reset_counts()
    result = ProcessingPipeline(cfg).run(sink)
    launches = read_counts()
    want = result.dispatched_chunks if hand_kernel else 0
    if launches["poly_fir_il"] != want or result.dispatched_chunks <= 0:
        raise AssertionError(
            f"{mode}: poly_fir_il launched {launches} times for "
            f"{result.dispatched_chunks} dispatched chunks (expected {want})"
        )
    return result, launches


def check_modes(capture: Path, work: Path) -> dict:
    iq = head_iq(capture)
    rows = {}
    for key, mode, agc in (("am", "am", True), ("usb", "usb", False), ("lsb", "lsb", False)):
        off = MODE_SIGNALS[key][0]
        result, launches = run_path(capture, work / f"mode_{key}.wav", [off], mode, agc)
        audio = read_wav(result.output_paths[0])[0][:, 0]
        if abs(audio.size - MODES_SECONDS * 48_000) > 2 or not np.all(np.isfinite(audio)):
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
    uninterrupted run, then a run with ``checkpoint_secs=1`` cancelled after
    ~2.5 s of input (two of the capture's three chunks), then its resume."""
    offsets = [MODE_SIGNALS["usb"][0], MODE_SIGNALS["usb_quiet"][0]]
    ref, ref_launches = run_path(capture, work / "ref.wav", offsets, "usb", True)
    out = work / "resumed.wav"
    sink = CancelAfter(0.5 * MODES_SECONDS * SAMPLE_RATE)
    reset_counts()
    try:
        run_path(capture, out, offsets, "usb", True, sink=sink, checkpoint_secs=1.0)
    except ProcessingCancelled:
        pass
    else:
        raise AssertionError("resume: the progress sink did not cancel the run")
    cancelled_launches = read_counts()
    ckpts = list(work.glob("*.ckpt"))
    if len(ckpts) != 1 or cancelled_launches["poly_fir_il"] <= 0:
        raise AssertionError(f"resume: checkpoints {ckpts}, launches {cancelled_launches}")
    result, resume_launches = run_path(
        capture, out, offsets, "usb", True, checkpoint_secs=1.0, resume=True
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


def check_channelizers(label: str, offsets, kernel_row: dict) -> dict:
    """One flagship chunk through every channelizer formulation of the port
    on the card, from the same stream: each output against the hand
    kernel's, and each one's device milliseconds (CUDA events) for the same
    function, stream in and ``(2C, m)`` decimated filter output out."""
    decim, _ = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = design_channel_filter(SAMPLE_RATE, 12_500.0, decim)
    L, m = len(taps), FLAGSHIP_M
    n = m * decim
    incs = [nco_increment_fixed(o, SAMPLE_RATE) for o in offsets]
    pair_np = bandpass_kernel(taps, incs)
    kil_np = interleave_kernel(pair_np, "iq")
    j = min(max(1, 128 // kil_np.shape[0]), m)
    os_plan = OverlapSavePlan.for_chunk(L, decim, n)  # power-of-two framing on the card
    rng = np.random.default_rng(4321)
    raw = rng.integers(-32768, 32767, 2 * (L - 1) + 2 * n, endpoint=True, dtype=np.int16)
    x = (torch.from_numpy(raw).cuda().to(torch.float32) * (1.0 / 32768.0)).contiguous()
    consts = {
        "hand": {"poly_w": torch.from_numpy(build_poly_kernel(kil_np, 2 * decim)).cuda()},
        "conv1d": {"kernel_il": torch.from_numpy(kil_np).cuda()},
        "jconv": {"j_kernel": torch.from_numpy(j_lanes_kernel(kil_np, decim, j)).cuda(),
                  "j_lanes": j},
        "shift_matmul": {"mm_kernel": torch.from_numpy(shift_matmul_kernel(kil_np, decim, j)).cuda(),
                         "j_lanes": j},
    }
    bank = torch.from_numpy(bank_from_kernel(pair_np, os_plan)).cuda()
    fns = {name: (lambda kw=kw: fir_il(x, decim, m, L, **kw)) for name, kw in consts.items()}

    def fft_bank():
        xc = complex_from_interleaved(x, "iq")
        dec, _ = os_fir_bank(os_plan, bank, xc[L - 1 :], xc[: L - 1])
        return torch.view_as_real(dec).permute(0, 2, 1).reshape(-1, m)  # (2C, m)

    fns["fft_bank"] = fft_bank
    reset_counts()
    hand = fns["hand"]()
    torch.cuda.synchronize()
    if read_counts()["poly_fir_il"] != 1:
        raise AssertionError(f"channelizers {label}: the hand kernel did not launch")
    hand_np = hand.cpu().numpy()
    row = {"phase": "channelizers", "geometry": label, "m": m, "taps": L, "j_lanes": j,
           "n_shift": int(consts["shift_matmul"]["mm_kernel"].shape[0]),
           "mm_stride": int(consts["shift_matmul"]["mm_kernel"].shape[1]),
           "fft_size": os_plan.fft_size, "fft_frames": os_plan.num_frames,
           "fft_fold": os_plan.fold, "kernel_check_ms": kernel_row["kernel_ms"]}
    for name, fn in fns.items():
        out = fn()
        torch.cuda.synchronize()
        if tuple(out.shape) != tuple(hand.shape):
            raise AssertionError(f"channelizers {label}: {name} gave {tuple(out.shape)}")
        err = error_db(out.cpu().numpy(), hand_np)
        limit = -90.0 if name == "fft_bank" else -100.0
        if name != "hand" and not err < limit:
            raise AssertionError(
                f"channelizers {label}: {name} {err:.1f} dB against the hand kernel "
                f"(limit {limit:.0f} dB)"
            )
        row[f"{name}_err_db"] = err
        del out
    for name, fn in fns.items():
        row[f"{name}_ms"] = time_ms(fn, iters=20 if name == "hand" else 10, warm=3)
    row["fastest"] = min(fns, key=lambda k: row[f"{k}_ms"])
    emit(row)
    return row


def twin_ddc(iq: np.ndarray, offset: float, mix_sign: int):
    """The float64 twin's mixed, filtered and decimated streams for one
    channel, mixed at ``offset`` itself, as the pipeline's 62-bit NCO mixes
    (``ops/nco.py``)."""
    decim, _ = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = design_channel_filter(SAMPLE_RATE, 12_500.0, decim)
    mixed = RefOscillator(offset, SAMPLE_RATE).mix(iq, mix_sign)
    filtered = RefOverlapSaveFIR(taps, 65_536).process(mixed)
    return mixed, filtered, filtered[::decim]


def check_modes_of_run(capture: Path, work: Path) -> dict:
    """The run modes beside plain audio on the flagship capture: plain run,
    pass-through, audio + IQ dump, the FFT channelizer."""
    iq = head_iq(capture)
    decim, _ = compute_decimation(SAMPLE_RATE, 96_000.0)
    k_dec = int((TWIN_SECONDS - 0.05) * SAMPLE_RATE) // decim
    plain, plain_launches = run_path(capture, work / "plain.wav", [OFFSET], "nfm", True)
    plain_bytes = plain.output_paths[0].read_bytes()
    _, _, twin_dec = twin_ddc(iq, OFFSET, plain.mix_sign)

    # pass-through: the slice WAV keeps the capture's s16 codec
    sliced, slice_launches = run_path(capture, work / "slice.wav", [OFFSET], "none", True)
    frames, rate = read_wav(sliced.output_paths[0])
    total_dec = -(-int(SECONDS * SAMPLE_RATE) // decim)
    if rate != round(sliced.fs_channel) or frames.shape != (total_dec, 2):
        raise AssertionError(f"pass_through: {frames.shape} frames at {rate} Hz")
    got = frames[:k_dec, 0].astype(np.float64) + 1j * frames[:k_dec, 1]
    slice_err = error_db(got, twin_dec[:k_dec])
    if not slice_err < -60.0:
        raise AssertionError(f"pass_through: {slice_err:.1f} dB against the twin's DDC output")
    emit({"phase": "pass_through", "seconds": SECONDS, "frames": int(frames.shape[0]),
          "twin_err_db": slice_err, "launches": slice_launches,
          "dispatched_chunks": sliced.dispatched_chunks, "loop_seconds": sliced.loop_seconds,
          "peak": sliced.audio_peak})

    # audio and IQ dump in one run
    dump_path = work / "chan.cf32"
    dumped, dump_launches = run_path(
        capture, work / "dumped.wav", [OFFSET], "nfm", True, dump_iq_path=dump_path
    )
    audio_identical = dumped.output_paths[0].read_bytes() == plain_bytes
    dump = np.fromfile(dump_path, dtype=np.complex64)
    dump_err = error_db(dump[:k_dec], twin_dec[:k_dec])
    if not audio_identical or dump.size != total_dec or not dump_err < -90.0:
        raise AssertionError(
            f"dump_iq: audio identical {audio_identical}, {dump.size} samples, "
            f"{dump_err:.1f} dB against the twin"
        )
    emit({"phase": "dump_iq", "samples": int(dump.size), "twin_err_db": dump_err,
          "audio_byte_identical": audio_identical, "launches": dump_launches,
          "loop_seconds": dumped.loop_seconds})

    # the same run on the FFT channelizer, with its IQ dump: the hand kernel
    # must not launch, and both its channel output and every sample of its
    # WAV must agree with the hand kernel's run
    fft_dump_path = work / "fft_chan.cf32"
    os.environ["IQ2A_CHANNELIZER"] = "fft"
    try:
        fft, fft_launches = run_path(
            capture, work / "fft.wav", [OFFSET], "nfm", True, hand_kernel=False,
            dump_iq_path=fft_dump_path,
        )
    finally:
        del os.environ["IQ2A_CHANNELIZER"]
    a = read_wav(fft.output_paths[0])[0][:, 0]
    b = read_wav(plain.output_paths[0])[0][:, 0]
    same_size = a.size == b.size
    fft_err = error_db(a, b) if same_size else float("inf")
    max_steps = float(np.abs(a - b).max()) * 32768 if same_size else float("inf")
    chan_err = error_db(np.fromfile(fft_dump_path, dtype=np.complex64), dump)
    if fft.channelizer != "fft" or not (max_steps <= FFT_AUDIO_STEPS and chan_err < -100.0):
        raise AssertionError(
            f"fft_pipeline: {fft.channelizer}, audio within {max_steps} s16 steps of the "
            f"plain run ({fft_err:.1f} dB), channelizer output {chan_err:.1f} dB against "
            "the hand kernel's"
        )
    emit({"phase": "fft_pipeline", "err_vs_hand_kernel_run_db": fft_err,
          "max_steps_vs_hand_kernel_run": max_steps, "chan_err_vs_hand_kernel_db": chan_err,
          "launches": fft_launches,
          "dispatched_chunks": fft.dispatched_chunks, "loop_seconds": fft.loop_seconds,
          "hand_kernel_run_loop_seconds": plain.loop_seconds})
    return {"plain": plain, "plain_launches": plain_launches, "plain_bytes": plain_bytes}


def check_stages(capture: Path) -> dict:
    """``fn_stages`` on chunk 0 of the flagship capture at full width."""
    decim, fs_ch = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = design_channel_filter(SAMPLE_RATE, 12_500.0, decim)
    inc, res = nco_increment_fixed(OFFSET, SAMPLE_RATE), nco_increment_residual(OFFSET, SAMPLE_RATE)
    ddc_plan = DDCPlan(len(taps), decim, FLAGSHIP_M * decim)
    n = ddc_plan.chunk_size
    rs_plan = ResamplePlan.create(fs_ch, 48_000.0, ddc_plan.out_size)
    decoder = create_decoder("nfm", deemph_us=300.0, agc_enabled=True)
    decoder.setup(fs_ch)
    step = build_chunk_step(
        ddc_plan=ddc_plan, rs_plan=rs_plan, ddc_kernel_np=bandpass_kernel(taps, [inc], [res]),
        rs_kernel_np=design_resampler_kernel(rs_plan.up, rs_plan.down), incs_fixed=[inc],
        nco_res=[res], codec="pcm_s16le", iq_order="iq", decoder=decoder,
        device=torch.device("cuda"), dump_iq=True, super_chunks=1, want_stages=True,
        est_total_chunks=6,
    )
    frames, _ = read_wav(capture)
    iq = frames[:n, 0].astype(np.float64) + 1j * frames[:n, 1]
    raw_np = np.round(frames[:n] * 32768.0).astype(np.int16).reshape(-1)
    raw = torch.from_numpy(raw_np).cuda()
    reset_counts()
    hot_accs = step.init_accs()
    step.fn(step.init_state(), hot_accs, raw, 0, 0)
    accs = step.init_accs()
    t0 = time.perf_counter()
    _, stages = step.fn_stages(step.init_state(), accs, raw, 0, 0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    if launches["poly_fir_il"] != 2:
        raise AssertionError(f"stages: poly_fir_il launched {launches} times for two steps")
    m = FLAGSHIP_M
    dec_r, dec_i = stages["decimated"]
    bit_identical = bool(
        torch.equal(dec_r, hot_accs["iq_r"][:, :m]) and torch.equal(dec_i, hot_accs["iq_i"][:, :m])
        and torch.equal(accs["audio"], hot_accs["audio"])
    )
    dec = (dec_r[0] + 1j * dec_i[0]).cpu().numpy()
    filt = (stages["filtered"][0][0] + 1j * stages["filtered"][1][0]).cpu().numpy()
    mixed = (stages["mixed"][0][0] + 1j * stages["mixed"][1][0]).cpu().numpy()
    t_mixed, t_filt, _ = twin_ddc(iq, OFFSET, 1)
    errs = {
        "filtered_strided_vs_decimated_db": error_db(filt[::decim], dec),
        "mixed_vs_twin_db": error_db(mixed, t_mixed),
        "filtered_vs_twin_db": error_db(filt, t_filt),
        "decimated_vs_twin_db": error_db(dec, t_filt[::decim]),
    }
    shapes_ok = (
        mixed.shape == filt.shape == (n,) and dec.shape == (m,)
        and {"input", "demod", "audio"} <= set(stages)
    )
    if not (bit_identical and shapes_ok and errs["filtered_strided_vs_decimated_db"] < -100.0
            and errs["mixed_vs_twin_db"] < -100.0 and errs["filtered_vs_twin_db"] < -90.0):
        raise AssertionError(f"stages: bit identical {bit_identical}, shapes {shapes_ok}, {errs}")
    row = {"phase": "stages", "chunk": n, "stage_names": sorted(stages),
           "decimated_bit_identical": bit_identical, **errs, "launches": launches,
           "fn_stages_seconds": seconds}
    emit(row)
    return row


def check_cli(capture: Path, work: Path, plain_bytes: bytes) -> dict:
    """The command line as a subprocess on the card: a run whose WAV equals
    the API run's byte for byte, and the synthetic benchmark."""
    out = work / "cli.wav"
    base = [sys.executable, "-m", "iq_to_audio_torch", "--cli"]
    t0 = time.perf_counter()
    run = subprocess.run(
        [*base, "--in", str(capture), "--fc", str(CENTER), "--ft", str(CENTER + OFFSET),
         "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent,
    )
    run_seconds = time.perf_counter() - t0
    if run.returncode != 0 or not out.exists():
        raise AssertionError(f"cli: exit {run.returncode}: {run.stderr[-2000:]}")
    identical = out.read_bytes() == plain_bytes
    if not identical or "Audio peak level" not in run.stdout:
        raise AssertionError(f"cli: WAV byte-identical to the API run: {identical}; {run.stdout!r}")
    t0 = time.perf_counter()
    bench = subprocess.run(
        [*base, "--benchmark", "--benchmark-seconds", "2"],
        capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent,
    )
    bench_seconds = time.perf_counter() - t0
    if bench.returncode != 0 or "x realtime" not in bench.stdout:
        raise AssertionError(f"cli --benchmark: exit {bench.returncode}: {bench.stderr[-2000:]}")
    row = {"phase": "cli", "wav_byte_identical": identical, "run_seconds": run_seconds,
           "benchmark_seconds": bench_seconds, "benchmark_line": bench.stdout.strip().splitlines()[-1]}
    emit(row)
    return row


def check_spectrum(capture: Path) -> dict:
    """The analysis entry points at their defaults (``backend="torch"``,
    ``device=None``: the card) and the matmul backend, against the host's
    float64 FFT on the head of the capture, over the bins within 60 dB of
    the peak (< 0.3 dB)."""
    iq = head_iq(capture).astype(np.complex64)
    blocks = [iq[i : i + (1 << 18)] for i in range(0, iq.size, 1 << 18)]
    row = {"phase": "spectrum"}
    _, want = compute_psd(iq, SAMPLE_RATE, nfft=1 << 18, backend="numpy")
    _, want_wf, _, frames = streaming_waterfall(blocks, SAMPLE_RATE, nfft=4096, backend="numpy")
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    got = {
        "psd_torch": (compute_psd(iq, SAMPLE_RATE, nfft=1 << 18)[1], want),
        "waterfall_torch": (streaming_waterfall(blocks, SAMPLE_RATE, nfft=4096)[1], want_wf),
        "waterfall_matmul": (
            streaming_waterfall(blocks, SAMPLE_RATE, nfft=4096, backend="matmul")[1], want_wf
        ),
    }
    row["device_allocations"] = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    if row["device_allocations"] <= 0:
        raise AssertionError("spectrum: the default backend allocated nothing on the card")
    for key, (psd, ref) in got.items():
        hot = ref > ref.max() - 60.0
        row[f"{key}_max_db_diff"] = float(np.abs(psd[hot] - ref[hot]).max())
        if not row[f"{key}_max_db_diff"] < 0.3:
            raise AssertionError(f"spectrum {key}: {row[f'{key}_max_db_diff']:.3f} dB off the host FFT")
    row["waterfall_frames"] = frames
    emit(row)
    return row


def graph_rate_checks(label: str, probe: dict, S: int = 1) -> dict:
    """A resident rate from CUDA-graph replays beside the rate the
    profiler's device-busy time of one replay implies: within 0.5-1.05x of
    it, with the hand kernel seen ``S`` times per captured call.  Both
    probes' work captures; one that reads anything but ``cuda_graph`` (a
    host sync or a pageable copy crept into the step) fails."""
    if probe["method"] != "cuda_graph":
        raise AssertionError(f"{label}: method {probe['method']} on the card: {probe}")
    ratio = probe["msps"] / probe["busy_msps"]
    if not 0.5 <= ratio <= 1.05:
        raise AssertionError(f"{label}: graph rate / busy rate {ratio}: {probe}")
    if probe["kernel_events"] != probe["calls"] * S:
        raise AssertionError(f"{label}: {probe['kernel_events']} kernel events for "
                             f"{probe['calls']} x {S} chunks of a replay")
    return {"graph_msps": probe["msps"], "busy_msps": probe["busy_msps"],
            "graph_over_busy": ratio}


def check_resident() -> dict:
    rows = {}
    for channels in (1, 5):
        reset_counts()
        out = measure_step_resident_msps(SAMPLE_RATE, channels=channels, device="cuda")
        launches = read_counts()["poly_fir_il"]
        S = out["super_chunks"]
        # the wrapper counts the two warm-up groups and the captured ones:
        # a replay launches the graph, not the wrapper
        want = (out["calls"] + 2) * S
        rates = graph_rate_checks(f"resident C={channels}", out, S)
        if launches != want or not out["msps"] > 0:
            raise AssertionError(f"resident C={channels}: {launches} launches, expected {want}")
        rows[str(channels)] = {**out, "launches": launches, **rates}
    row = {"phase": "resident", **rows}
    emit(row)
    return row


def check_burst(capture: Path, work: Path, runs: dict, resident: dict) -> dict:
    """Burst mode (``pipeline/hetero.py``) on the flagship capture, the
    device stream on the card: ``HeteroExecutor(cpu_workers=1,
    n_segments=8)`` twice on one executor (``cold``: the worker's start-up
    and channelizer build inside the run; ``warm``: rates and worker kept),
    each with the launch counts set to 0 just before; then the device stream
    alone (``cpu_workers=0``: one claim, no lead-in); then the executor's
    resident-compute probe of the hand kernel beside ``resident``'s
    ``fn_super`` rate."""
    from iq_to_audio_torch.pipeline.hetero import HeteroExecutor

    plain = runs["plain"]
    plain_audio = read_wav(plain.output_paths[0])[0][:, 0]
    iq = head_iq(capture)

    def config(name: str) -> ProcessingConfig:
        return ProcessingConfig(
            in_path=capture, target_freq=CENTER + OFFSET, center_freq=CENTER, demod_mode="nfm",
            agc_enabled=True, output_path=work / name, device="cuda",
        )

    def audio_of(result) -> np.ndarray:
        audio, rate = read_wav(result.output_paths[0])
        audio = audio[:, 0]
        if rate != 48_000 or audio.shape != plain_audio.shape or not np.all(np.isfinite(audio)):
            raise AssertionError(f"burst: {audio.shape} samples at {rate} Hz")
        return audio

    row: dict = {"phase": "burst", "plain_loop_seconds": plain.loop_seconds}
    with HeteroExecutor(cpu_workers=1, n_segments=8) as ex:
        for name in ("cold", "warm"):
            reset_counts()
            t0 = time.perf_counter()
            result = ex.run(config(f"burst_{name}.wav"))
            run_seconds = time.perf_counter() - t0
            launches = read_counts()
            stats = ex.last_stats
            audio = audio_of(result)
            err_plain = error_db(audio, plain_audio)
            err_twin, err_twin_raw = twin_err_db(audio, iq, OFFSET, "nfm", True, result.mix_sign)
            row[name] = {
                **{k: stats[k] for k in (
                    "device_segments", "cpu_segments", "device_runs", "device_x", "cpu_x",
                    "device_abstained", "device_seconds", "cpu_seconds", "loop_seconds",
                )},
                "wire_probe": stats["wire_probe"],
                "launches": launches,
                "run_seconds": run_seconds,
                "err_vs_plain_db": err_plain,
                "twin_err_db": err_twin,
                "twin_err_unquantised_db": err_twin_raw,
            }
            il = launches["poly_fir_il"]
            if (stats["device_segments"] < 1 or stats["device_abstained"]
                    or il <= 0 or il < stats["device_runs"]):
                raise AssertionError(f"burst {name}: the device stream took no share: {row[name]}")
            if not (err_plain < -60.0 and err_twin < -60.0):
                raise AssertionError(
                    f"burst {name}: {err_plain:.1f} dB against the plain run, "
                    f"{err_twin:.1f} dB against the twin"
                )
        row["segments"] = stats["device_segments"] + stats["cpu_segments"]
        row["device_compute_msps"] = ex.device_compute_msps
    with HeteroExecutor(cpu_workers=0, n_segments=8) as ex:
        reset_counts()
        result = ex.run(config("burst_alone.wav"))
        launches = read_counts()
        stats = ex.last_stats
    audio = audio_of(result)
    err_alone = error_db(audio, plain_audio)
    identical = result.output_paths[0].read_bytes() == plain.output_paths[0].read_bytes()
    row["device_alone"] = {
        "device_runs": stats["device_runs"], "device_segments": stats["device_segments"],
        "loop_seconds": stats["loop_seconds"], "launches": launches,
        "err_vs_plain_db": err_alone, "byte_identical_to_plain": identical,
    }
    if stats["device_runs"] != 1 or launches["poly_fir_il"] <= 0 or not err_alone < -60.0:
        raise AssertionError(f"burst device alone: {row['device_alone']}")
    decim, _ = compute_decimation(SAMPLE_RATE, 96_000.0)
    taps = len(design_channel_filter(SAMPLE_RATE, 12_500.0, decim))
    reset_counts()
    ex = HeteroExecutor(cpu_workers=0)
    msps = ex.measure_resident_compute(taps, decim)
    probe = ex.last_compute_probe
    probe_launches = read_counts()["poly_fir_il"]
    if not (msps and msps > 0 and probe_launches > 0):
        raise AssertionError(f"burst: resident probe {msps} Msps, {probe_launches} launches")
    row["resident_probe"] = {**probe, "launches": probe_launches,
                             "fn_super_msps": resident["1"]["msps"],
                             **graph_rate_checks("burst resident probe", probe)}
    emit(row)
    return row


def check_seq_parallel(capture: Path, work: Path, plain) -> dict:
    """The flagship capture sequence-parallel on a world of one (an
    in-process one-rank NCCL group): ``run_captures_dp`` with the launch
    counts set to 0 just before, then the command line's ``--seq-parallel
    on`` as a subprocess.  The hand kernel must launch at least once per
    chunk; the audio must agree with the plain run (< -55 dB: the
    distributed scans add a zero-start local scan to a ramp correction, so
    1-LSB differences are expected) and the twin (< -60 dB), and the
    command line's WAV must equal the API run's byte for byte."""
    from iq_to_audio_torch.parallel.dp_runner import CaptureJob, mesh_geometry, run_captures_dp

    out = work / "seq_parallel.wav"
    job = CaptureJob(in_path=capture, target_freqs=[CENTER + OFFSET], output_paths=[out],
                     center_freq=CENTER)
    chunk = mesh_geometry(SAMPLE_RATE, 12_500.0, 96_000.0, 1, 1 << 18)[3].chunk_size
    chunks = -(-int(SECONDS * SAMPLE_RATE) // chunk)
    reset_counts()
    t0 = time.perf_counter()
    res = run_captures_dp([job], world=1, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_counts()
    audio, rate = read_wav(out)
    audio = audio[:, 0]
    plain_audio = read_wav(plain.output_paths[0])[0][:, 0]
    n = min(audio.size, plain_audio.size)
    err_plain = error_db(audio[:n], plain_audio[:n])
    err_twin, err_twin_raw = twin_err_db(audio, head_iq(capture), OFFSET, "nfm", True, plain.mix_sign)
    if (launches["poly_fir_il"] < chunks or rate != 48_000 or abs(audio.size - plain_audio.size) > 1
            or not np.all(np.isfinite(audio))):
        raise AssertionError(f"seq_parallel: {launches} launches for {chunks} chunks, "
                             f"{audio.size} samples at {rate} Hz")
    if not (err_plain < -55.0 and err_twin < -60.0):
        raise AssertionError(f"seq_parallel: {err_plain:.1f} dB against the plain run, "
                             f"{err_twin:.1f} dB against the twin")
    cli_out = work / "seq_parallel_cli.wav"
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "iq_to_audio_torch", "--cli", "--in", str(capture),
         "--fc", str(CENTER), "--ft", str(CENTER + OFFSET), "--out", str(cli_out),
         "--seq-parallel", "on"],
        capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent,
    )
    cli_seconds = time.perf_counter() - t0
    if run.returncode != 0 or not cli_out.exists():
        raise AssertionError(f"seq_parallel cli: exit {run.returncode}: {run.stderr[-2000:]}")
    cli_identical = cli_out.read_bytes() == out.read_bytes()
    if not cli_identical or "sequence-parallel over 1 device(s)" not in run.stderr:
        raise AssertionError(f"seq_parallel cli: WAV byte-identical {cli_identical}; "
                             f"{run.stderr[-2000:]}")
    row = {"phase": "seq_parallel", "world": 1, "chunk": chunk, "chunks": chunks,
           "launches": launches, "realtime_factor": SECONDS / res.loop_seconds,
           "loop_seconds": res.loop_seconds, "wall_seconds": wall,
           "plain_loop_seconds": plain.loop_seconds, "err_vs_plain_db": err_plain,
           "twin_err_db": err_twin, "twin_err_unquantised_db": err_twin_raw,
           "byte_identical_to_plain": out.read_bytes() == plain.output_paths[0].read_bytes(),
           "cli_seconds": cli_seconds, "cli_wav_byte_identical": cli_identical}
    emit(row)
    return row


def check_multi_in(capture: Path, work: Path, plain) -> dict:
    """Two ``--in`` without burst mode through the command line (in this
    process): one card cannot host two ``dp`` rows, so the captures run one
    after the other, each WAV tagged with its capture's stem and equal to
    the plain run's byte for byte."""
    from iq_to_audio_torch import cli as tcli

    second = work / "again" / capture.name  # the same stem: the tags get an index
    second.parent.mkdir()
    os.link(capture, second)
    out = work / "multi.wav"
    reset_counts()
    t0 = time.perf_counter()
    rc = tcli.main(["--cli", "--in", str(capture), "--in", str(second), "--fc", str(CENTER),
                    "--ft", str(CENTER + OFFSET), "--out", str(out)])
    seconds = time.perf_counter() - t0
    launches = read_counts()
    outs = [work / f"multi_{capture.stem}{i}.wav" for i in (1, 2)]
    identical = [p.exists() and p.read_bytes() == plain.output_paths[0].read_bytes() for p in outs]
    if rc != 0 or not all(identical) or launches["poly_fir_il"] != 2 * plain.dispatched_chunks:
        raise AssertionError(f"multi_in: exit {rc}, byte-identical {identical}, {launches}")
    row = {"phase": "multi_in", "captures": 2, "outputs": [p.name for p in outs],
           "byte_identical_to_plain": identical, "launches": launches, "seconds": seconds}
    emit(row)
    return row


#: the GUI's defaults: snapshot seconds and FFT size, and the preview's length
GUI_SNAPSHOT_SECONDS = 2.0
GUI_NFFT = 262_144
GUI_PREVIEW_SECONDS = 2.0


def check_interactive(capture: Path, work: Path, plain, plain_bytes: bytes,
                      five_offsets) -> dict:
    """The interactive session in this process on the headless toolkit
    (``IQ2A_QT=headless``), on the flagship capture at the GUI's defaults:

    * ``gather_snapshot(device="cuda")`` over 2 s at nfft 262,144: device
      allocations > 0, and the PSD within 0.3 dB of ``backend="numpy"`` on
      the same samples over the bins within 60 dB of the peak;
    * the window on ``device="cuda"`` (when matplotlib imports): the capture
      loaded (its snapshot on the card), the target set through the targets
      panel; without matplotlib the session state builds the configs;
    * ``PreviewWorker`` at one and at five targets (the tap-block loop),
      each with the launch counts set to 0 just before: ``poly_fir_il``
      once per dispatched chunk, and the preview WAVs byte-identical to a
      direct ``run_preview`` of the same config;
    * the confirmed config through ``ProcessingPipeline``, its parameters
      the plain run's: byte-identical to the plain run's WAV;
    * ``AudioPostWorker`` on that WAV against ``--audio-post DIR
      --audio-post-stream-mb 0.25`` as a subprocess (the streaming engine):
      byte-identical outputs."""
    from dataclasses import fields, replace

    os.environ["IQ2A_QT"] = "headless"
    from iq_to_audio_torch.interactive import _qt
    from iq_to_audio_torch.interactive.state import InteractiveState
    from iq_to_audio_torch.interactive.workers import (
        AudioPostWorker,
        PreviewWorker,
        gather_snapshot,
    )
    from iq_to_audio_torch.io.formats import resolve_input_format
    from iq_to_audio_torch.pipeline.preview import run_preview
    from iq_to_audio_torch.post.squelch import AudioPostOptions, SquelchConfig

    if not _qt.HEADLESS:
        raise AssertionError("interactive: IQ2A_QT=headless did not select the headless toolkit")
    row: dict = {"phase": "interactive", "snapshot_seconds": GUI_SNAPSHOT_SECONDS,
                 "nfft": GUI_NFFT, "preview_seconds": GUI_PREVIEW_SECONDS}

    # snapshot on the card against the host's float64 FFT of the same samples
    spec, _ = resolve_input_format(capture, requested=None)
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    t0 = time.perf_counter()
    snap = gather_snapshot(capture, spec, SAMPLE_RATE, GUI_SNAPSHOT_SECONDS, nfft=GUI_NFFT,
                           device="cuda")
    row["snapshot_wall_s"] = time.perf_counter() - t0
    row["snapshot_device_allocations"] = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    _, want, _, frames = streaming_waterfall(iter([snap.retained]), SAMPLE_RATE, nfft=GUI_NFFT,
                                             backend="numpy")
    hot = want > want.max() - 60.0
    row["snapshot_frames"] = snap.frames
    row["snapshot_max_db_diff"] = float(np.abs(snap.psd_db[hot] - want[hot]).max())
    if (row["snapshot_device_allocations"] <= 0 or frames != snap.frames
            or snap.retained.size != int(GUI_SNAPSHOT_SECONDS * SAMPLE_RATE)
            or not row["snapshot_max_db_diff"] < 0.3):
        raise AssertionError(f"interactive snapshot: {row}")

    base_kwargs = {"device": "cuda", "bandwidth": 12_500.0, "demod_mode": "nfm"}
    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        row["window"] = False
        row["window_import_error"] = str(exc)
        win = None
        state = InteractiveState(base_kwargs=dict(base_kwargs))
        state.input_path = capture
        state.center_freq, state.center_freq_source = CENTER, "filename"
    else:
        from iq_to_audio_torch.interactive.app import InteractiveWindow

        row["window"] = True
        if _qt.QApplication.instance() is None:
            _qt.QApplication([])
        win = InteractiveWindow(base_kwargs=base_kwargs, snapshot_seconds=GUI_SNAPSHOT_SECONDS)
        t0 = time.perf_counter()
        win._load_file(capture)
        row["window_load_wall_s"] = time.perf_counter() - t0
        state = win.state
        if (win._snapshot is None or win._snapshot.frames != snap.frames
                or state.center_freq != CENTER or win._snapshot_worker._kw["device"] != "cuda"):
            raise AssertionError(f"interactive window: snapshot {win._snapshot is not None}, "
                                 f"center {state.center_freq}")

    def set_targets(offsets) -> None:
        state.clear_targets()
        for off in offsets:
            state.add_target(CENTER + off)
        if win is not None:
            win.targets_panel.refresh()
            win.targets_panel.changed.emit()
            if not win.status_panel.preview_btn.isEnabled():
                raise AssertionError("interactive: preview not enabled with a target")

    def preview(offsets, tag: str) -> None:
        set_targets(offsets)
        got: list = []
        if win is not None:
            done = win._preview_done

            def capture_results(results):
                got.extend(results)
                done(results)

            win._preview_done = capture_results  # connected by _start_preview
            reset_counts()
            t0 = time.perf_counter()
            win._start_preview()
            wall = time.perf_counter() - t0
            launches = read_counts()
            del win._preview_done
        else:
            worker = PreviewWorker(state.build_configs(), GUI_PREVIEW_SECONDS)
            worker.signals.finished.connect(got.extend)
            reset_counts()
            t0 = time.perf_counter()
            worker.run()
            wall = time.perf_counter() - t0
            launches = read_counts()
        if len(got) != 1:
            raise AssertionError(f"interactive preview {tag}: {len(got)} results")
        cfg, result, path = got[0]
        if cfg.device != "cuda" or launches["poly_fir_il"] != result.dispatched_chunks \
                or result.dispatched_chunks <= 0:
            raise AssertionError(f"interactive preview {tag}: {launches} launches for "
                                 f"{result.dispatched_chunks} chunks on {cfg.device}")
        direct_dir = work / f"direct_preview_{tag}"
        run_preview(replace(cfg, output_path=direct_dir / f"audio_{int(cfg.target_freq)}_48k.wav"),
                    GUI_PREVIEW_SECONDS)
        gui_files = sorted(Path(path).parent.glob(f"audio_{int(cfg.target_freq)}_48k_preview*.wav"))
        identical = [(direct_dir / p.name).read_bytes() == p.read_bytes() for p in gui_files]
        if len(gui_files) != len(offsets) or not all(identical):
            raise AssertionError(f"interactive preview {tag}: {len(gui_files)} files, "
                                 f"byte-identical to run_preview {identical}")
        for p in gui_files:
            p.unlink()
        row[f"preview_{tag}"] = {"targets": len(offsets), "wall_s": wall,
                                 "dispatched_chunks": result.dispatched_chunks,
                                 "launches": launches, "byte_identical_to_run_preview": identical}

    preview([OFFSET], "1")
    preview(list(five_offsets), "5")

    # the confirmed config, with the plain run's parameters
    set_targets([OFFSET])
    if win is not None:
        win._confirm_run()
        configs = win.result.configs
    else:
        configs = state.build_configs()
    (cfg,) = configs
    # the plain run's config (run_path): only the centre's source may differ
    plain_cfg = ProcessingConfig(in_path=capture, target_freq=CENTER + OFFSET, center_freq=CENTER,
                                 demod_mode="nfm", agc_enabled=True, device="cuda")
    differ = sorted(f.name for f in fields(ProcessingConfig)
                    if getattr(cfg, f.name) != getattr(plain_cfg, f.name)
                    and f.name != "center_freq_source")
    if differ:
        raise AssertionError(f"interactive confirmed config differs from the plain run's: {differ}")
    confirmed = replace(cfg, output_path=work / "gui_confirmed.wav")
    reset_counts()
    result = ProcessingPipeline(confirmed).run()
    launches = read_counts()
    confirmed_bytes = result.output_paths[0].read_bytes()
    if launches["poly_fir_il"] != result.dispatched_chunks or confirmed_bytes != plain_bytes:
        raise AssertionError(f"interactive confirmed run: {launches} launches for "
                             f"{result.dispatched_chunks} chunks, byte-identical to the plain "
                             f"run {confirmed_bytes == plain_bytes}")
    row["confirmed"] = {"dispatched_chunks": result.dispatched_chunks, "launches": launches,
                        "loop_seconds": result.loop_seconds,
                        "plain_loop_seconds": plain.loop_seconds,
                        "byte_identical_to_plain": True}

    # audio post: the worker (in memory) against the command line (streaming)
    dirs = {tag: work / f"post_{tag}" for tag in ("worker", "cli")}
    for d in dirs.values():
        d.mkdir()
        os.link(result.output_paths[0], d / "confirmed.wav")
    summaries: list = []
    worker = AudioPostWorker([dirs["worker"] / "confirmed.wav"], AudioPostOptions(config=SquelchConfig()))
    worker.signals.finished.connect(summaries.append)
    t0 = time.perf_counter()
    worker.run()
    worker_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    post = subprocess.run(
        [sys.executable, "-m", "iq_to_audio_torch", "--audio-post", str(dirs["cli"]),
         "--audio-post-stream-mb", "0.25"],
        capture_output=True, text=True, timeout=600, cwd=Path(__file__).resolve().parent,
    )
    cli_wall = time.perf_counter() - t0
    outs = [d / "confirmed-cleaned.wav" for d in dirs.values()]
    if (post.returncode != 0 or len(summaries) != 1 or summaries[0].failed
            or not all(p.exists() for p in outs)):
        raise AssertionError(f"interactive audio post: exit {post.returncode}, "
                             f"{post.stderr[-2000:]}")
    identical = outs[0].read_bytes() == outs[1].read_bytes()
    if not identical:
        raise AssertionError("interactive audio post: worker and --audio-post outputs differ")
    res = summaries[0].results[0]
    row["audio_post"] = {"worker_wall_s": worker_wall, "cli_stream_wall_s": cli_wall,
                         "byte_identical": identical, "retained_ratio": res.retained_ratio,
                         "bytes_in": res.bytes_in, "bytes_out": res.bytes_out}
    if win is not None:
        win.close()
    emit(row)
    return row


def check_profile(capture: Path, work: Path, plain_bytes: bytes) -> dict:
    """A run with ``profile_dir``: the audio must be the plain run's, and
    the trace must hold one device-kernel event of the hand kernel for each
    chunk dispatched (the kernel is launched through ``ctypes``, outside
    torch's dispatcher, so only the device tracing can have seen it)."""
    trace_dir = work / "trace"
    result, launches = run_path(
        capture, work / "profiled.wav", [OFFSET], "nfm", True, profile_dir=trace_dir
    )
    trace = trace_dir / "chunk_loop.trace.json"
    size = trace.stat().st_size if trace.exists() else 0
    identical = result.output_paths[0].read_bytes() == plain_bytes
    with trace.open() as f:
        events = json.load(f)["traceEvents"]
    kernel_events = sum(
        1 for ev in events
        if str(ev.get("cat", "")).lower() == "kernel" and "poly_fir_kernel" in ev.get("name", "")
    )
    if size <= 1_000 or not identical or kernel_events != result.dispatched_chunks:
        raise AssertionError(
            f"profile: trace of {size} bytes with {kernel_events} hand-kernel events for "
            f"{result.dispatched_chunks} chunks, audio identical {identical}"
        )
    row = {"phase": "profile", "trace_bytes": size, "trace_hand_kernel_events": kernel_events,
           "dispatched_chunks": result.dispatched_chunks,
           "audio_byte_identical": identical, "launches": launches,
           "loop_seconds": result.loop_seconds}
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
    probes = [check_mix_probe(peaks, mode, c) for mode in ("nfm", "usb") for c in (1, -1, 0)]
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
    chan1 = check_channelizers("flagship C=1", (OFFSET,), flagship)
    chan5 = check_channelizers("C=5", five, batch)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        capture = work / f"flagship_fc-{int(CENTER)}Hz.wav"
        generate_synthetic_iq(capture, SAMPLE_RATE, SECONDS, OFFSET)
        runs = check_modes_of_run(capture, work)
        check_stages(capture)
        check_cli(capture, work, runs["plain_bytes"])
        sharded = check_seq_parallel(capture, work, runs["plain"])
        check_multi_in(capture, work, runs["plain"])
        gui = check_interactive(capture, work, runs["plain"], runs["plain_bytes"], five)
        check_spectrum(capture)
        resident = check_resident()
        burst = check_burst(capture, work, runs, resident)
        probe_times = {p["mode"]: time_mix_probe(p) for p in probes if p["carrier"] == 1}
        time_chunk_step(1, flagship)
        time_chunk_step(5, batch)
        check_profile(capture, work, runs["plain_bytes"])
    others = {
        key: {"C=1": chan1[key], "C=5": chan5[key]}
        for key in ("hand_ms", "conv1d_ms", "jconv_ms", "shift_matmul_ms", "fft_bank_ms")
    }
    emit({"kernels": [
        kernel_entry(
            "poly_fir_il", "iq_to_audio_tpu/ops/pallas_ddc.py:68",
            e2e["launches"]["poly_fir_il"], flagship,
            also_replaces="iq_to_audio_tpu/ops/pallas_ddc.py:103",
            shift_matmul_ms=chan1["shift_matmul_ms"], fft_bank_ms=chan1["fft_bank_ms"],
            formulations_ms=others,
            burst_launches={k: burst[k]["launches"]["poly_fir_il"] for k in ("cold", "warm")},
            seq_parallel_launches=sharded["launches"]["poly_fir_il"],
            interactive_launches={
                key: gui[key]["launches"]["poly_fir_il"]
                for key in ("preview_1", "preview_5", "confirmed")
            },
        ),
        kernel_entry(
            "poly_fir_pair", "iq_to_audio_tpu/ops/pallas_ddc.py:313",
            stream["launches"]["poly_fir_pair"], pair,
        ),
        {
            "name": "mix_sign_powers",
            "route": "cuda",
            "source": "iq_to_audio_torch/csrc/mix_probe.cu",
            "replaces": "none: the host's float64 probe, iq_to_audio_torch/ref/chain.py",
            "launches": e2e["launches"]["mix_sign_powers"],
            "max_rel_err": max(p["max_rel_err"] for p in probes),
            **{f"{p['mode']}_{k}": p[k] for p in probes if p["carrier"] == 1
               for k in ("call_ms", "twin_ms", "bound_ms")},
            **{f"{mode}_kernel_ms": t["kernel_ms"] for mode, t in probe_times.items()},
        },
    ]})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
