"""Multi-capture data-parallel front end (port of the JAX package's
``parallel/dp_runner.py``).

Streams N independent recordings through ONE sharded pipeline step, one
capture per ``dp`` row of the mesh; with one capture it is the pure
sequence-parallel run (dp = 1, every rank a ``seq`` shard).  The program of
each rank is :func:`~.sharded.build_sharded_step`; this module supplies the
host side: per-capture probing, aligned chunks, exact output bookkeeping
and per-channel WAV writers.

The parent process probes, plans the geometry and checks the output paths
(a mismatch fails before any file exists); then :func:`~.launch.run_world`
starts one rank per device.  Each rank reads its own ``seq`` slice of every
chunk of its capture by byte offset, so only the halos cross ranks.  Rank 0
writes the WAVs and reports each chunk to the parent, which feeds the
caller's progress sink.  Cancel is decided by rank 0 at every chunk
boundary and broadcast, so every rank stops at the same chunk; the partial
outputs are then deleted and
:class:`~iq_to_audio_torch.pipeline.pipeline.ProcessingCancelled` is raised.

Scope: one demod configuration and one capture geometry (sample rate,
codec, IQ order) across captures.  Anything else runs the captures one
after the other through the serial pipeline (the command line's fallback).
"""

from __future__ import annotations

import contextlib
import logging
import math
import threading
import time
from dataclasses import dataclass, field, replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..io.formats import InputFormatSpec
from ..io.reader import IQReader
from ..io.writer import AudioWriter
from ..ops.ddc import DDCPlan, bandpass_kernel, interleave_kernel
from ..ops.resample import ResamplePlan
from ..pipeline.capture import (
    ChannelGeometry,
    annotate,
    channel_geometry,
    decide_mix_sign,
    nco_increments,
    resampler_kernel,
    resolve_capture,
    warm_frames,
)
from ..pipeline.pipeline import ProcessingCancelled
from ..pipeline.progress import PhaseState, ProgressSink, ProgressTracker
from ..utils.device import resolve_device
from .launch import DEFAULT_TIMEOUT, run_world
from .mesh import device_count, make_mesh
from .sharded import (
    build_sharded_step,
    check_geometry,
    gather_rows,
    local_operands,
    mesh_device,
    plan_for_mesh,
)

LOG = logging.getLogger(__name__)

#: what a cancelled rank returns in place of a result
_CANCELLED = "cancelled"


@dataclass
class CaptureJob:
    """One recording and its channel targets."""

    in_path: Path
    target_freqs: list[float]
    output_paths: list[Path] = field(default_factory=list)
    center_freq: float | None = None
    input_format: str | None = None
    input_sample_rate: float | None = None


@dataclass
class DPResult:
    sample_rate: float
    decimation: int
    fs_channel: float
    num_captures: int
    channels_per_capture: int
    audio_peaks: list[list[float]]  # [capture][channel]
    frames_processed: int
    #: rank 0's seconds from the first chunk to the final flush
    loop_seconds: float = 0.0


@dataclass
class DPRun:
    """The planned run: what every rank needs, decided once in the parent."""

    paths: list[Path]
    specs: list[InputFormatSpec]
    sample_rate: float
    iq_order: str
    total_frames: int
    ddc_plan: DDCPlan
    rs_plan: ResamplePlan
    fs_channel: float
    incs: list[int]
    nco_res: list[int]
    kernel_il: np.ndarray
    rs_kernel: np.ndarray | None
    mode: str
    deemph_alpha: float
    agc_enabled: bool
    outputs: list[list[Path]]
    dp: int
    seq: int
    device: str

    @property
    def captures(self) -> int:
        return len(self.paths)

    @property
    def channels(self) -> int:
        return len(self.outputs[0])

    @property
    def n_chunks(self) -> int:
        return max(1, -(-int(self.total_frames) // self.ddc_plan.chunk_size))


def mesh_geometry(
    sample_rate: float, bandwidth: float, fs_ch_target: float, seq: int, target_chunk: int
):
    """The shared DSP geometry of a run on ``seq`` shards: ``(taps,
    decimation, fs_channel, ddc_plan, rs_plan)`` (see :func:`mesh_plans`)."""
    geo = channel_geometry(sample_rate, bandwidth, fs_ch_target)
    return (geo.taps, geo.decimation, geo.fs_channel, *mesh_plans(geo, seq, target_chunk))


def mesh_plans(geo: ChannelGeometry, seq: int, target_chunk: int):
    """``(ddc_plan, rs_plan)`` on ``seq`` shards: the chunk aligned to the
    decimation, the shards and the resampler's ``down``."""
    decimation = geo.decimation
    align = decimation * geo.out_align
    ddc_plan = plan_for_mesh(
        num_taps=len(geo.taps),
        decimation=decimation,
        seq=seq * (align // math.gcd(align, decimation * seq)),
        target_chunk=target_chunk,
    )
    # plan_for_mesh aligns to decimation*seq; re-check the resampler alignment
    n = ddc_plan.chunk_size
    unit = decimation * seq
    lcm = unit * align // math.gcd(unit, align)
    if n % lcm:
        ddc_plan = replace(ddc_plan, chunk_size=-(-n // lcm) * lcm)
    return ddc_plan, geo.resampler(ddc_plan.out_size)


def plan_captures(
    jobs: list[CaptureJob],
    *,
    dp: int,
    seq: int,
    bandwidth: float = 12_500.0,
    demod_mode: str = "nfm",
    fs_ch_target: float = 96_000.0,
    deemph_us: float = 300.0,
    agc_enabled: bool = True,
    iq_order: str = "iq",
    mix_sign_override: int | None = None,
    target_chunk: int = 1 << 18,
    device: str = "cuda",
) -> DPRun:
    """Probe the captures and plan the run on a ``dp x seq`` mesh; raises
    ``ValueError`` for what cannot run there, before any file is written."""
    G = len(jobs)
    if G < 1:
        raise ValueError("run_captures_dp needs at least one capture")
    K = len(jobs[0].target_freqs)
    if K < 1 or any(len(j.target_freqs) != K for j in jobs):
        raise ValueError("every capture must list the same number of targets")
    if dp != G:
        raise ValueError(f"mesh dp axis ({dp}) must equal capture count ({G})")

    # --- per-capture probing ------------------------------------------------
    caps = [
        resolve_capture(
            Path(job.in_path), input_format=job.input_format,
            sample_rate=job.input_sample_rate, center_freq=job.center_freq,
            targets=job.target_freqs,
        )
        for job in jobs
    ]
    sample_rate = caps[0].sample_rate
    codec = caps[0].spec.codec
    if any(abs(c.sample_rate - sample_rate) > 1e-6 or c.spec.codec != codec for c in caps):
        raise ValueError(
            "multi-capture DP requires identical sample rate and codec across "
            "captures; run heterogeneous captures sequentially"
        )

    geo = channel_geometry(sample_rate, bandwidth, fs_ch_target)
    ddc_plan, rs_plan = mesh_plans(geo, seq, target_chunk)
    check_geometry(dp, seq, G * K, ddc_plan, G)

    # --- per-capture mixer sign (the float64 probe on the run's device) -----
    def warm_block(cap):
        with cap.reader(warm_frames(sample_rate, len(geo.taps)), iq_order) as r:
            return r.read_block_raw()

    incs, nco_res = [], []
    for cap in caps:
        sign = decide_mix_sign(
            lambda cap=cap: warm_block(cap), resolve_device(device), codec, iq_order,
            sample_rate, cap.offsets[0], geo, override=mix_sign_override,
        )
        inc, res = nco_increments(cap.offsets, sample_rate, sign)
        incs += inc
        nco_res += res

    # --- output paths: fail before any file exists ---------------------------
    outputs: list[list[Path]] = []
    for job in jobs:
        outs = [Path(p) for p in job.output_paths]
        if not outs:
            outs = [annotate(Path(job.in_path).with_suffix(".wav"), f) for f in job.target_freqs]
        elif len(outs) == 1 and K > 1:
            outs = [annotate(outs[0], f) for f in job.target_freqs]
        if len(outs) != K:
            raise ValueError(
                f"{job.in_path}: {len(outs)} output path(s) for {K} target "
                "frequencies — supply one shared path or one per target."
            )
        outputs.append(outs)

    # --- the common length ---------------------------------------------------
    totals = []
    for cap in caps:
        with cap.reader(ddc_plan.chunk_size, iq_order) as r:
            totals.append(r.total_frames)
    if len(set(totals)) > 1:
        LOG.warning("Captures differ in length; processing the common %d frames.", min(totals))

    mode = "usb" if demod_mode.lower() == "ssb" else demod_mode.lower()
    return DPRun(
        paths=[Path(j.in_path) for j in jobs],
        specs=[c.spec for c in caps],
        sample_rate=sample_rate,
        iq_order=iq_order,
        total_frames=min(totals),
        ddc_plan=ddc_plan,
        rs_plan=rs_plan,
        fs_channel=geo.fs_channel,
        incs=incs,
        nco_res=nco_res,
        kernel_il=interleave_kernel(bandpass_kernel(geo.taps, incs, nco_res), iq_order),
        rs_kernel=resampler_kernel(rs_plan),
        mode=mode,
        # same tau guard as the serial decoder (demod/nfm.py::setup)
        deemph_alpha=math.exp(-1.0 / (geo.fs_channel * max(deemph_us * 1e-6, 1e-6))),
        agc_enabled=agc_enabled,
        outputs=outputs,
        dp=dp,
        seq=seq,
        device=device,
    )


def run_captures_dp(
    jobs: list[CaptureJob],
    *,
    bandwidth: float = 12_500.0,
    demod_mode: str = "nfm",
    fs_ch_target: float = 96_000.0,
    deemph_us: float = 300.0,
    agc_enabled: bool = True,
    iq_order: str = "iq",
    mix_sign_override: int | None = None,
    world: int | None = None,
    device: str = "cuda",
    target_chunk: int = 1 << 18,
    progress_sink: ProgressSink | None = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> DPResult:
    """Process ``len(jobs)`` captures data-parallel over a mesh of ranks.

    Every capture must share sample rate and codec; every job must list
    the same number of targets (the dp rows run one program).

    This starts ``world`` ranks (default :func:`~.mesh.device_count` of
    ``device``, a multiple of the capture count) on a ``dp = len(jobs)``
    mesh and returns rank 0's result.

    ``progress_sink`` receives one "chunks" phase and may request
    cooperative cancellation through its cancel callback (the serial
    pipeline's contract): the run stops at the next chunk boundary, every
    partial output file is deleted, and ``ProcessingCancelled`` is raised.
    """
    options = dict(
        bandwidth=bandwidth, demod_mode=demod_mode, fs_ch_target=fs_ch_target,
        deemph_us=deemph_us, agc_enabled=agc_enabled, iq_order=iq_order,
        mix_sign_override=mix_sign_override, target_chunk=target_chunk,
    )
    G = len(jobs)
    kind = resolve_device(device).type
    n_dev = world or device_count(kind)
    if G < 1 or n_dev % G != 0:
        raise ValueError(f"{n_dev} devices cannot host dp={G} captures evenly")
    run = plan_captures(jobs, dp=G, seq=n_dev // G, device=kind, **options)
    with _progress(run, progress_sink) as (report, cancel):
        out = run_world(
            _rank_main, n_dev, kind, (run,), timeout=timeout,
            on_message=report, cancel=cancel.is_set,
        )[0]
    if out == _CANCELLED:
        raise ProcessingCancelled("Processing cancelled by request.")
    return out


@contextlib.contextmanager
def _progress(run: DPRun, sink: ProgressSink | None):
    """One "chunks" phase on ``sink``: yields the report function rank 0's
    chunk counts go to, and the event the sink's cancel callback sets."""
    tracker = ProgressTracker(sink)
    cancel = threading.Event()
    if sink is not None:
        with contextlib.suppress(AttributeError):
            sink.set_cancel_callback(cancel.set)
    n_chunks = run.n_chunks
    tracker.start([PhaseState("chunks", "Process chunks", float(n_chunks), unit="chunks")])

    def report(chunks_done: int) -> None:
        tracker.advance("chunks", 1.0)
        tracker.status(
            f"chunk {chunks_done}/{n_chunks} "
            f"({run.captures} capture(s) x {run.channels} channel(s))"
        )

    try:
        yield report, cancel
    finally:
        tracker.close()


def _rank_main(ctx, run: DPRun):
    """One rank of a launched run (see :func:`~.launch.run_world`)."""
    mesh = make_mesh(ctx.world, dp=run.dp, device=ctx.device)
    return _run_rank(mesh, run, ctx.post, ctx.cancelled)


def _run_rank(mesh, run: DPRun, report, cancelled) -> DPResult | str | None:
    """The aligned streaming loop of one rank.  Rank 0 returns the
    :class:`DPResult` (or ``"cancelled"``); the others return None."""
    G, K = run.captures, run.channels
    ddc_plan, rs_plan = run.ddc_plan, run.rs_plan
    device = mesh_device(mesh)
    fn, init_state = build_sharded_step(
        mesh, ddc_plan=ddc_plan, rs_plan=rs_plan, num_channels=G * K,
        codec=run.specs[0].codec, iq_order=run.iq_order, mode=run.mode,
        deemph_alpha=run.deemph_alpha, agc_enabled=run.agc_enabled,
        captures=G if G > 1 else 1,
    )
    state = init_state()
    inc_lo, poly_w = local_operands(
        mesh, run.incs, run.kernel_il, ddc_plan.decimation, run.nco_res
    )
    rs_kernel = None if run.rs_kernel is None else torch.from_numpy(run.rs_kernel).to(device)
    row, shard = mesh.get_local_rank("dp"), mesh.get_local_rank("seq")
    lead = dist.get_rank() == 0
    chunk = ddc_plan.chunk_size
    n_local = chunk // run.seq
    g = row if G > 1 else 0
    spec = run.specs[g]
    reader = IQReader(
        run.paths[g], n_local, run.iq_order, spec,
        sample_rate=run.sample_rate if spec.container == "raw" else None,
        prefetch_depth=0,
    )
    writers: list[list[AudioWriter]] = []
    flag = torch.zeros(1, dtype=torch.int32, device=device)
    total_frames, decimation = run.total_frames, ddc_plan.decimation
    n_dec = ddc_plan.out_size
    rs_in = rs_emitted = dec_emitted = processed = 0
    last_audio, last_count = None, 0

    def write(audio: np.ndarray, start: int, stop: int) -> None:
        for gi in range(G):
            for k in range(K):
                raw_seg = audio[gi * K + k, start:stop]
                w = writers[gi][k]
                # the pre-clip peak (the single-capture path's contract:
                # the report shows the amplitude the clipper cost)
                w.peak = max(w.peak, float(np.abs(raw_seg).max(initial=0.0)))
                w.write_s16(np.round(np.clip(raw_seg, -0.99, 0.99) * 32767.0).astype(np.int16))

    t0 = time.perf_counter()
    try:
        with reader:
            if lead:
                for outs in run.outputs:
                    writers.append([AudioWriter(p) for p in outs])
            for c in range(-(-int(total_frames) // chunk)):
                # rank 0 decides, every rank stops at the same chunk
                flag.fill_(1 if lead and cancelled() else 0)
                dist.broadcast(flag, src=0)
                if int(flag.item()):
                    raise ProcessingCancelled("Processing cancelled by request.")
                valid = min(chunk, total_frames - processed)
                reader.seek_frame(c * chunk + shard * n_local)
                raw = np.zeros(2 * n_local, dtype=reader.raw_dtype)
                blk = reader.read_block_raw()
                if blk is not None:
                    raw[: blk.size] = blk[: raw.size]
                rs_offset = 0 if rs_plan.identity else rs_plan.chunk_offset(rs_in)
                state, audio = fn(
                    state, torch.from_numpy(raw).to(device), rs_offset, inc_lo, poly_w, rs_kernel
                )
                processed += valid
                dec_total = -(-processed // decimation)
                dec_valid = dec_total - dec_emitted
                dec_emitted = dec_total
                if rs_plan.identity:
                    count = dec_valid
                else:
                    count = rs_plan.out_count(rs_in, dec_valid)
                    rs_in += n_dec
                if shard != 0:
                    continue  # the rows' audio is gathered on the seq = 0 ranks
                audio_np = gather_rows(mesh, audio).cpu().numpy()  # (G*K, cap)
                if lead:
                    write(audio_np, 0, count)
                    rs_emitted += count
                    last_audio, last_count = audio_np, count
                    report(c + 1)
            if lead and not rs_plan.identity and last_audio is not None:
                extra = rs_plan.final_flush_count(dec_emitted, rs_emitted)
                if extra > 0:
                    write(last_audio, last_count, last_count + extra)
        loop_seconds = time.perf_counter() - t0
    except ProcessingCancelled:
        if not lead:
            return None
        # serial-pipeline parity: delete the partial per-channel outputs,
        # closed first so the unlink cannot race an open handle
        _close_quietly(writers)
        for ws in writers:
            for w in ws:
                with contextlib.suppress(OSError):
                    Path(w.output_path).unlink(missing_ok=True)
        return _CANCELLED
    finally:
        _close_quietly(writers)
    if not lead:
        return None
    return DPResult(
        sample_rate=run.sample_rate,
        decimation=decimation,
        fs_channel=run.fs_channel,
        num_captures=G,
        channels_per_capture=K,
        audio_peaks=[[w.peak for w in ws] for ws in writers],
        frames_processed=processed,
        loop_seconds=loop_seconds,
    )


def _close_quietly(writers: list[list[AudioWriter]]) -> None:
    for ws in writers:
        for w in ws:
            with contextlib.suppress(Exception):
                w.close()
