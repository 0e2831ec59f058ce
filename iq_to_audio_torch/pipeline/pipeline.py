"""Streaming pipeline orchestrator (port of the JAX package's
``pipeline/pipeline.py``).

Drives the chunk step (:mod:`.step`) from a host loop with:

* one to five target frequencies batched through one channelizer pass
  (leading channel axis), one output WAV each,
* dispatch groups of ``super_chunks`` chunks, each read by the reader
  straight into a pinned upload slot and uploaded with
  ``non_blocking=True``; after the first group a worker thread reads the
  next group while the loop enqueues and writes,
* one device-to-host copy per accumulation window, started behind the
  window's compute and drained one window later (checkpointed runs drain
  each window before the next is dispatched),
* exact host-side sample bookkeeping (valid counts for the padded final
  chunk and the resampler come from Python ints, never device syncs),
* progress phases, cooperative cancel with partial-output cleanup, and
  checkpoint/resume,
* the end-of-file resampler flush,
* pass-through slicing (``demod_mode="none"``: the decimated IQ goes out in
  the input's codec), the channel-IQ dump beside the audio, stage snapshots
  of the first chunk, and a ``torch.profiler`` trace of the chunk loop
  (``profile_dir``).
"""

from __future__ import annotations

import contextlib
import hashlib
import logging
import math
import os
import pickle
import queue
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..convert import state_from_jax, state_to_jax
from ..demod import DecoderStats, create_decoder
from ..io.probe import SampleRateProbe
from ..io.writer import AudioWriter, IQDebugWriter, IQSliceWriter
from ..ops.ddc import DDCPlan, bandpass_kernel
from ..utils import spans
from ..utils.device import resolve_device
from .capture import (
    OUTPUT_RATE,
    annotate,
    channel_geometry,
    channel_paths,
    decide_mix_sign,
    is_pass_through,
    nco_increments,
    resampler_kernel,
    resolve_capture,
)
from .config import ProcessingConfig
from .filters import tune_chunk_size
from .progress import PhaseState, ProgressSink, ProgressTracker
from .step import build_chunk_step

LOG = logging.getLogger(__name__)

# layout of the port's checkpoint (state as numpy in the JAX package's
# layout, counters, RMS); bump when it changes
_CKPT_VERSION = 2


@dataclass
class ProcessingResult:
    sample_rate_probe: SampleRateProbe
    center_freq: float
    target_freq: float
    freq_offset: float
    decimation: int
    fs_channel: float
    mix_sign: int
    audio_peak: float
    audio_peaks: list[float] = field(default_factory=list)
    stats: list[DecoderStats] = field(default_factory=list)
    output_paths: list[Path] = field(default_factory=list)
    #: wall-clock seconds spent in the chunk loop
    loop_seconds: float = 0.0
    #: complex input samples consumed
    input_samples: int = 0
    #: chunk steps run on the device, the zero-padded final group included
    dispatched_chunks: int = 0
    #: which channelizer ran: ``conv`` (the hand-written kernel), ``fft``
    #: or ``native``
    channelizer: str = ""


class ProcessingCancelled(RuntimeError):  # noqa: N818 - the JAX package's name
    """Raised when processing is aborted early by user request."""


def _truncate_payload(path: Path, payload_bytes: int) -> None:
    """Truncate a WAV's data payload to ``payload_bytes`` (resume)."""
    from ..io.riff import parse_wav_header

    path = Path(path)
    if not path.exists():
        return
    info = parse_wav_header(path)
    keep = min(payload_bytes, info.data_size)
    with path.open("r+b") as f:
        f.truncate(info.data_offset + keep)


class _PinnedRing:
    """Host staging for dispatch-group uploads and window downloads.

    On the card each slot is pinned memory with an event recorded after its
    copy, and a slot is reused only after its event: two slots let the next
    group be staged while the previous upload is in flight.  On the CPU the
    copies are synchronous and the events are not needed.
    """

    def __init__(self, shape, dtype, device: torch.device, slots: int = 2):
        self.cuda = device.type == "cuda"
        self.bufs = [torch.empty(shape, dtype=dtype, pin_memory=self.cuda) for _ in range(slots)]
        self.events: list = [None] * slots
        self.i = 0

    def next(self) -> tuple[torch.Tensor, int]:
        i = self.i
        self.i = (i + 1) % len(self.bufs)
        self.wait(i)
        return self.bufs[i], i

    def record(self, i: int) -> None:
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.events[i] = ev

    def wait(self, i: int) -> None:
        if self.events[i] is not None:
            with spans.span("iq2a.wait"):
                self.events[i].synchronize()
            self.events[i] = None


def _write(write, samples: np.ndarray) -> None:
    """One writer call (``write`` / ``write_s16``) as an ``iq2a.write`` span."""
    with spans.span("iq2a.write"):
        write(samples)


@contextlib.contextmanager
def _profiled(profile_dir: Path | None, device: torch.device):
    """``torch.profiler`` around the chunk loop, written as a Chrome trace
    (``chunk_loop.trace.json``, readable in Perfetto) under ``profile_dir``.
    Attached only while the loop runs; nothing when ``profile_dir`` is unset."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    trace = out / "chunk_loop.trace.json"
    prof.export_chrome_trace(str(trace))
    spans.reset()  # the trace holds the loop's spans; keep none in process
    LOG.info("Profiler trace written to %s", trace)


class ProcessingPipeline:
    def __init__(self, config: ProcessingConfig):
        self.config = config
        self._cancelled = False
        #: a pass that dispatches every chunk and waits for the device, but
        #: copies nothing back and writes no samples (the outputs stay
        #: empty): the burst executor's warm pass
        #: (``HeteroExecutor.run(device_warm_no_fetch=True)``)
        self.warm_no_fetch = False

    def cancel(self) -> None:
        self._cancelled = True

    # -- main entry ----------------------------------------------------------

    @spans.job
    def run(self, progress_sink: ProgressSink | None = None) -> ProcessingResult:
        cfg = self.config
        device = resolve_device(cfg.device)
        tracker = ProgressTracker(progress_sink)
        output_paths: list[Path] = []
        cancel_logged = False

        def request_cancel() -> None:
            self._cancelled = True
            tracker.cancel()
            tracker.status("Cancelling…")

        def check_cancel(stage: str) -> None:
            nonlocal cancel_logged
            if self._cancelled or tracker.cancelled:
                self._cancelled = True
                if not tracker.cancelled:
                    tracker.cancel()
                    tracker.status("Cancelling…")
                if not cancel_logged:
                    LOG.info("Processing cancelled during %s.", stage)
                    cancel_logged = True
                raise ProcessingCancelled("Processing cancelled by user.")

        if progress_sink is not None:
            with contextlib.suppress(AttributeError):
                progress_sink.set_cancel_callback(request_cancel)

        #: every writer this run opens, closed on all exit paths
        all_writers: list = []

        def close_writers_quietly() -> None:
            for w in all_writers:
                with contextlib.suppress(Exception):
                    w.close()

        try:
            return self._run(cfg, device, tracker, check_cancel, all_writers, output_paths)
        except ProcessingCancelled:
            # delete partial outputs on cancel (reference processing.py:
            # 1205-1211), unless checkpointing is on: the partial output and
            # the checkpoint then let a later run resume
            close_writers_quietly()
            keep_for_resume = cfg.checkpoint_secs and not is_pass_through(cfg.demod_mode)
            if not cfg.probe_only and not keep_for_resume:
                for p in output_paths:
                    try:
                        Path(p).unlink(missing_ok=True)
                    except OSError:
                        LOG.debug("Failed to remove cancelled output %s", p)
            raise
        finally:
            close_writers_quietly()
            tracker.close()

    def _run(
        self, cfg, device, tracker, check_cancel, all_writers, output_paths,
    ) -> ProcessingResult:
        pass_through = is_pass_through(cfg.demod_mode)
        if cfg.target_freq <= 0 and not cfg.probe_only:
            raise ValueError(
                "Target frequency must be positive. Provide --ft or use --interactive."
            )
        if cfg.bandwidth <= 0:
            raise ValueError("Bandwidth must be positive.")
        # --- probing ---------------------------------------------------------
        cap = resolve_capture(
            cfg.in_path, input_format=cfg.input_format, container=cfg.input_container,
            sample_rate=cfg.input_sample_rate, center_freq=cfg.center_freq,
            center_source=cfg.center_freq_source, targets=cfg.all_target_freqs(),
        )
        input_spec, sample_rate, center_freq = cap.spec, cap.sample_rate, cap.center_freq
        cfg.input_format_source = cfg.input_format_source or cap.format_source
        cfg.input_container = cfg.input_container or input_spec.container
        cfg.input_format = cfg.input_format or input_spec.codec
        if cfg.center_freq is None:
            cfg.center_freq, cfg.center_freq_source = center_freq, cap.center_source

        preview_seconds = cfg.max_input_seconds
        if preview_seconds is not None and preview_seconds <= 0:
            preview_seconds = None
        max_input_samples: int | None = None
        if preview_seconds is not None and sample_rate > 0:
            max_input_samples = max(1, int(math.floor(preview_seconds * sample_rate)))
        seg_start = int(cfg.input_start_sample or 0)
        if cfg.input_num_samples is not None:
            seg_n = max(1, int(cfg.input_num_samples))
            max_input_samples = (
                seg_n if max_input_samples is None else min(max_input_samples, seg_n)
            )

        freqs, offsets = cap.freqs, cap.offsets
        target_freq, freq_offset = freqs[0], offsets[0]
        with spans.span("iq2a.setup.build"):
            geo = channel_geometry(sample_rate, cfg.bandwidth, cfg.fs_ch_target, pass_through)
            decimation, fs_channel, taps = geo.decimation, geo.fs_channel, geo.taps
            LOG.info(
                "Input %.2f Hz, center %.0f Hz, target(s) %s (offset(s) %s Hz), "
                "decimation %d -> %.2f Hz, %s, device %s.",
                sample_rate, center_freq, "/".join(f"{f:.0f}" for f in freqs),
                "/".join(f"{o:.0f}" for o in offsets), decimation, fs_channel,
                cfg.demod_mode.upper(), device,
            )

            # --- geometry / plans --------------------------------------------
            target_chunk = tune_chunk_size(sample_rate, cfg.chunk_size)
            if device.type == "cuda" and cfg.chunk_size >= 1_048_576:
                # the card amortises per-chunk launch and copy latency: prefer
                # the 4Mi cap unless the user asked for less
                target_chunk = max(target_chunk, 1 << 22)
            ddc_plan = DDCPlan.create(
                len(taps), decimation, target_chunk=target_chunk, out_align=geo.out_align,
                max_chunk=1 << 22,
            )
            chunk_size = ddc_plan.chunk_size
            rs_plan = geo.resampler(ddc_plan.out_size)
            names = channel_paths(cfg, freqs, cfg.output_path, input_spec)

            # --- checkpoint/resume: carried state + input offset -------------
            resume_data = None
            ckpt_path: Path | None = None
            ckpt_requested = bool(cfg.checkpoint_secs or cfg.resume) and not cfg.probe_only
            if ckpt_requested and pass_through:
                # the slice output would need codec-exact truncation on resume
                LOG.warning(
                    "Checkpoint/resume is not supported in pass-through "
                    "(--demod none) runs; continuing without checkpoints."
                )
                ckpt_requested = False
            if ckpt_requested:
                ckpt_path = Path(str(names[0]) + ".ckpt")
            if cfg.resume and ckpt_path is not None and ckpt_path.exists():
                with ckpt_path.open("rb") as f:
                    resume_data = pickle.load(f)
                LOG.info(
                    "Resuming from %s (%.2f s of input already processed).",
                    ckpt_path, resume_data["counters"]["processed_samples"] / sample_rate,
                )
            resume_frames = resume_data["counters"]["processed_samples"] if resume_data else 0
            if max_input_samples is not None and resume_frames:
                # the reader seeks past the processed samples, so the window
                # budget shrinks by the same amount
                max_input_samples = max(0, max_input_samples - resume_frames)

        reader = cap.reader(chunk_size, cfg.iq_order, start_frame=seg_start + resume_frames)
        with contextlib.ExitStack() as opened:
            with spans.span("iq2a.setup.probe"):
                opened.enter_context(reader)
            total_input_samples = float(reader.total_frames)
            if max_input_samples is not None:
                total_input_samples = (
                    float(min(total_input_samples, max_input_samples))
                    if total_input_samples > 0
                    else float(max_input_samples)
                )
            channel_samples = total_input_samples / max(decimation, 1)
            phases = [
                PhaseState("ingest", "Ingest IQ", total_input_samples, unit="samples"),
                PhaseState("channel", "Channelize", channel_samples, unit="samples"),
                PhaseState("demod", "Demodulate", channel_samples, unit="samples"),
                PhaseState(
                    "encode", "Encode Audio",
                    max(total_input_samples / sample_rate * OUTPUT_RATE, 0.0),
                    unit="samples",
                ),
            ]
            if cfg.dump_iq_path:
                phases.insert(
                    3, PhaseState("dump_iq", "Write IQ Dump", channel_samples, unit="samples")
                )
            tracker.start(phases)
            tracker.status("init dsp")
            check_cancel("initialization")

            # --- warm-up: first block + mixer sign ---------------------------
            with spans.span("iq2a.setup.mix_sign"):
                with spans.span("iq2a.read"):
                    raw_first = reader.read_block_raw()
                if raw_first is None or raw_first.size == 0:
                    raise RuntimeError("Input stream produced no samples.")
                mix_sign = decide_mix_sign(
                    lambda: raw_first, device, input_spec.codec, cfg.iq_order,
                    sample_rate, freq_offset, geo,
                    resumed=resume_data["mix_sign"] if resume_data else None,
                    override=cfg.mix_sign_override,
                )
            LOG.info("Selected mixer sign %d based on warm-up snippet.", mix_sign)
            check_cancel("warm-up")
            if cfg.probe_only:
                tracker.advance("ingest", raw_first.size // 2)
                return ProcessingResult(
                    sample_rate_probe=cap.probe,
                    center_freq=center_freq,
                    target_freq=target_freq,
                    freq_offset=freq_offset,
                    decimation=decimation,
                    fs_channel=fs_channel,
                    mix_sign=mix_sign,
                    audio_peak=0.0,
                )

            with spans.span("iq2a.setup.build"):
                # --- writers -------------------------------------------------
                output_paths.extend(names)
                for p in output_paths:
                    p.parent.mkdir(parents=True, exist_ok=True)
                dump_paths: list[Path | None] = [None] * len(freqs)
                if cfg.dump_iq_path:
                    dump_paths = [
                        annotate(cfg.dump_iq_path, f) if len(freqs) > 1 else cfg.dump_iq_path
                        for f in freqs
                    ]
                appending = resume_data is not None
                if appending:
                    # outputs may hold windows flushed after the checkpoint:
                    # truncate back to the checkpointed position (resume implies
                    # audio mode: pass-through runs write no checkpoint)
                    ctr = resume_data["counters"]
                    for p in output_paths:
                        _truncate_payload(p, ctr["rs_emitted"] * 2)  # mono s16
                    for p in dump_paths:
                        if p is not None and Path(p).exists():
                            with Path(p).open("r+b") as f:
                                f.truncate(ctr["dec_emitted"] * 8)  # cf32 pairs
                audio_writers: list[AudioWriter] = []
                slice_writers: list[IQSliceWriter] = []
                iq_writers = [IQDebugWriter(p, fs_channel, append=appending) for p in dump_paths]
                if pass_through:
                    slice_writers = [
                        IQSliceWriter(p, fs_channel, input_spec, append=appending)
                        for p in output_paths
                    ]
                else:
                    audio_writers = [AudioWriter(p, append=appending) for p in output_paths]
                    if appending:
                        for w, st in zip(audio_writers, resume_data["rms"]):
                            w.seed_rms(*st)
                all_writers.extend([*iq_writers, *slice_writers, *audio_writers])

                # --- build the device step -----------------------------------
                incs, nco_res = nco_increments(offsets, sample_rate, mix_sign)
                decoder = None
                if not pass_through:
                    decoder = create_decoder(
                        cfg.demod_mode, deemph_us=cfg.deemph_us, agc_enabled=cfg.agc_enabled
                    )
                    decoder.setup(fs_channel)
                want_stages = cfg.plot_stages_path is not None
                checkpointing = bool(cfg.checkpoint_secs) and ckpt_path is not None
                # a resumed run sizes its windows as the interrupted run did (for
                # the whole input window, not the part left), so acc_chunks and
                # the fingerprint agree
                geometry_chunks = int(math.ceil((total_input_samples + resume_frames) / chunk_size))
                step = build_chunk_step(
                    ddc_plan=ddc_plan,
                    rs_plan=rs_plan,
                    ddc_kernel_np=bandpass_kernel(taps, incs, nco_res),
                    rs_kernel_np=resampler_kernel(rs_plan),
                    incs_fixed=incs,
                    codec=input_spec.codec,
                    iq_order=cfg.iq_order,
                    decoder=decoder,
                    device=device,
                    pass_through=pass_through,
                    dump_iq=cfg.dump_iq_path is not None,
                    # a stage-snapshot run dispatches chunk by chunk
                    super_chunks=1 if want_stages else None,
                    want_stages=want_stages,
                    taps_np=np.asarray(taps),
                    fft_size=None if cfg.auto_filter_block else int(cfg.filter_block),
                    nco_res=nco_res,
                    est_total_chunks=(
                        None if cfg.fixed_device_geometry else (geometry_chunks or None)
                    ),
                    # checkpoints land on window boundaries: windows no longer
                    # than the checkpoint cadence
                    acc_chunks_cap=(
                        max(1, int(cfg.checkpoint_secs * sample_rate // chunk_size))
                        if checkpointing else None
                    ),
                )
                fingerprint = {
                    # input identity + window: a resume against another capture
                    # or window is rejected, not spliced
                    "in_path": str(Path(cfg.in_path).resolve()),
                    "in_size": os.stat(cfg.in_path).st_size,
                    "in_start": seg_start,
                    "in_num": cfg.input_num_samples,
                    "deemph_us": cfg.deemph_us,
                    "chunk": chunk_size,
                    "decimation": decimation,
                    "sample_rate": sample_rate,
                    "bandwidth": cfg.bandwidth,
                    "taps_sha": hashlib.sha1(taps.tobytes()).hexdigest(),
                    "mode": cfg.demod_mode.lower(),
                    "agc": cfg.agc_enabled,
                    "incs": tuple(incs),
                    "nco_res": tuple(nco_res),
                    "codec": input_spec.codec,
                    "iq_order": cfg.iq_order,
                    "acc_chunks": step.acc_chunks,
                    # the fft channelizer carries another state layout (the
                    # (2, L-1) pair tail) than conv and native, which interchange
                    "channelizer": "fft" if step.channelizer == "fft" else "conv",
                }
                if resume_data is not None:
                    if resume_data.get("version") != _CKPT_VERSION:
                        raise ValueError(
                            f"Checkpoint {ckpt_path} was written by an incompatible "
                            "version (state layout changed); remove it or rerun "
                            "without --resume."
                        )
                    if resume_data["fingerprint"] != fingerprint:
                        raise ValueError(
                            f"Checkpoint {ckpt_path} does not match this "
                            "configuration; remove it or rerun without --resume."
                        )
                on_drained = None
                if checkpointing:
                    cadence = int(cfg.checkpoint_secs * sample_rate)
                    next_ckpt = [resume_frames + cadence]

                    def on_drained(st) -> None:
                        # the phased schedule calls this after every drain, when
                        # the written audio, the counters and ``st`` agree
                        if loop.processed_samples < next_ckpt[0]:
                            return
                        payload = {
                            "version": _CKPT_VERSION,
                            "fingerprint": fingerprint,
                            "mix_sign": mix_sign,
                            "state": state_to_jax(st),
                            "rms": [w.rms_state for w in audio_writers],
                            "counters": loop.counters(),
                        }
                        tmp = ckpt_path.with_suffix(".ckpt.tmp")
                        with tmp.open("wb") as f:
                            pickle.dump(payload, f)
                        tmp.replace(ckpt_path)
                        next_ckpt[0] = loop.processed_samples + cadence
                        LOG.info(
                            "Checkpoint written at %.2f s of input (%s).",
                            loop.processed_samples / sample_rate, ckpt_path,
                        )

                loop = _ChunkLoop(
                    step, reader, raw_first, max_input_samples, decimation,
                    tracker=tracker, check_cancel=check_cancel, on_drained=on_drained,
                    want_stages=want_stages, fetch=not self.warm_no_fetch,
                )
                state = step.init_state(seg_start)
                if resume_data is not None:
                    state = state_from_jax(resume_data["state"], device)
                    loop.restore(resume_data["counters"])
            writers = slice_writers if pass_through else audio_writers
            loop_start = time.perf_counter()
            with _profiled(cfg.profile_dir, device), spans.span("iq2a.loop"):
                loop.run(writers, state, iq_writers=iq_writers)
            loop_seconds = time.perf_counter() - loop_start
            with spans.span("iq2a.flush"):
                if ckpt_path is not None and not loop.limit_exhausted:
                    ckpt_path.unlink(missing_ok=True)  # the run completed
                tracker.status("flush outputs")
                if decoder is not None:
                    decoder.finalize()
                for w in all_writers:
                    w.close()

        if loop.limit_exhausted and preview_seconds is not None:
            LOG.info(
                "Stopped after %.2f s due to preview limit.",
                loop.processed_samples / sample_rate,
            )
        if want_stages and loop.stage_snapshots:
            self._save_stage_plots(loop.stage_snapshots, freqs, center_freq, sample_rate, fs_channel)
        peaks = [w.peak for w in writers]
        rms_list: list[float] = []
        if pass_through:
            for freq, pk in zip(freqs, peaks):
                LOG.info(
                    "[%d] IQ slice peak magnitude %.2f dBFS (complex).",
                    int(freq), 20.0 * math.log10(max(pk, 1e-6)),
                )
        else:
            rms_list = [w.rms_dbfs for w in audio_writers]
            for freq, pk, rms in zip(freqs, peaks, rms_list):
                LOG.info(
                    "[%d] Audio peak level %.2f dBFS, RMS %.2f dBFS.",
                    int(freq), 20.0 * math.log10(max(pk, 1e-6)), rms,
                )
        tracker.status("Processing complete")
        return ProcessingResult(
            sample_rate_probe=cap.probe,
            center_freq=center_freq,
            target_freq=target_freq,
            freq_offset=freq_offset,
            decimation=decimation,
            fs_channel=fs_channel,
            mix_sign=mix_sign,
            audio_peak=peaks[0] if peaks else 0.0,
            audio_peaks=peaks,
            stats=[DecoderStats(rms_dbfs=r) for r in rms_list],
            output_paths=list(output_paths),
            loop_seconds=loop_seconds,
            input_samples=loop.processed_samples,
            dispatched_chunks=loop.dispatched,
            channelizer=step.channelizer,
        )

    def _save_stage_plots(self, snapshots, freqs, center_freq, sample_rate, fs_channel) -> None:
        """One stage-PSD figure per channel from the first chunk's snapshots
        (best effort: a plotting failure does not fail the run)."""
        cfg = self.config
        try:
            from ..analysis.visualize import save_stage_psd

            for c, freq in enumerate(freqs):
                path = (
                    cfg.plot_stages_path
                    if len(freqs) == 1
                    else annotate(cfg.plot_stages_path, freq)
                )
                per_channel = {
                    name: (
                        buf[c] if buf.ndim > 1 else buf,
                        sample_rate if name in {"input", "mixed", "filtered"} else fs_channel,
                    )
                    for name, buf in snapshots.items()
                }
                save_stage_psd(per_channel, path, center_freq, device=cfg.device)
            LOG.info("Saved stage PSD plots to %s", cfg.plot_stages_path)
        except Exception as exc:  # plotting is best effort
            LOG.warning("Failed to save stage plots: %s", exc)


class _ChunkLoop:
    """The window / group / chunk loop with its exact host counters.

    With ``on_drained`` each window is drained before the next one is
    dispatched, and then ``on_drained(state)`` is called: the written
    audio, the counters and the state then describe one point of the stream
    (the checkpoint's schedule).  Otherwise each window is drained one
    window later, behind the next window's compute.  With ``fetch=False`` no
    window is copied back or written; the loop ends by waiting for the
    device.
    """

    _COUNTERS = ("processed_samples", "dec_emitted", "rs_in_device", "rs_in_valid", "rs_emitted")

    def __init__(
        self, step, reader, raw_first, max_input_samples, decimation, *,
        tracker, check_cancel, on_drained=None, want_stages=False, fetch=True,
    ):
        self.step = step
        self.reader = reader
        self.raw_first = raw_first
        self.max_input_samples = max_input_samples
        self.decimation = decimation
        self.tracker = tracker
        self.check_cancel = check_cancel
        self.on_drained = on_drained
        self.want_stages = want_stages
        self.fetch = fetch
        #: stage name -> numpy array of the first chunk (complex for pairs)
        self.stage_snapshots: dict[str, np.ndarray] = {}
        self.limit_exhausted = False
        # the stream as the upload rows take it: the warm-up's block not yet
        # staged, the frames ``max_input_samples`` leaves, the stream's end
        self._first: np.ndarray | None = raw_first
        self._budget = max_input_samples
        self._ended = False
        self.dispatched = 0
        # exact host mirrors of the stream position
        self.processed_samples = 0  # complex input samples consumed
        self.dec_emitted = 0  # decimated samples counted as valid
        self.rs_in_device = 0  # decimated samples consumed by the device
        self.rs_in_valid = 0  # decimated samples that were real (not pad)
        self.rs_emitted = 0  # 48 kHz samples written so far

    def counters(self) -> dict:
        return {k: getattr(self, k) for k in self._COUNTERS}

    def restore(self, counters: dict) -> None:
        for k in self._COUNTERS:
            setattr(self, k, int(counters[k]))

    def _fill(self, row: np.ndarray, lead: bool = False) -> int:
        """Fill one upload row in place and return its valid frames: the
        warm-up's block for the first row of all, else the reader's next
        block read straight into the row, as far as ``max_input_samples``
        leaves; 0 once the stream has ended.  The row's unfilled tail gets
        the raw zero, so a short last block, a budget cut and a silent row
        all decode to 0.0; a group's ``lead`` row that finds nothing is left
        as it is, since its group is dropped."""
        chunk_size = self.step.chunk_size
        frames = 0
        if not self._ended:
            budget = self._budget
            if self._first is not None:
                first, self._first = self._first, None
                avail = first.size // 2
                frames = avail if budget is None else max(0, min(avail, budget))
                row[: 2 * frames] = first[: 2 * frames]
                short, cut = avail < chunk_size, avail > frames
            else:
                want = chunk_size if budget is None else min(chunk_size, budget)
                with spans.span("iq2a.read"):
                    frames = self.reader.read_into(row, want)
                    if frames:
                        spans.count("direct_bytes", 2 * row.itemsize * frames)
                short, cut = frames < want, False
            if budget is not None:
                self._budget = budget = budget - frames
            if budget is not None and budget <= 0:
                # the budget is spent: it cut the capture if a frame is left
                self._ended = True
                self.limit_exhausted = cut or self._frame_left(row.dtype)
            elif short:
                self._ended = True  # the capture ended inside this block
        if frames < chunk_size and (frames or not lead):
            with spans.span("iq2a.pad"):
                # raw-domain pad value decoding to 0.0: u8 is offset-binary
                row[2 * frames :] = 128 if self.step.codec == "pcm_u8" else 0
        return frames

    def _frame_left(self, dtype) -> bool:
        """Whether the capture holds a frame beyond the spent budget (reads
        it, as nothing is read after the budget)."""
        with spans.span("iq2a.read"):
            return self.reader.read_into(np.empty(2, dtype), 1) > 0

    def _fill_group(self, rows: np.ndarray) -> list[int]:
        """Fill a group's rows in place (:meth:`_fill`): valid frames per
        row, ``[0]`` where the stream had ended before the group."""
        valid = [self._fill(rows[0], lead=True)]
        if valid[0]:
            valid += [self._fill(row) for row in rows[1:]]
        return valid

    def _read_ahead(self, uploads: _PinnedRing, free, ready, stop, carried) -> None:
        """The read-ahead worker: fill each slot that ``free`` hands back
        with the next group, once the slot's copy is done, and hand
        (slot, valid, last) on through ``ready`` until the stream ends; an
        exception is handed on in its place.  From its start it alone
        touches the reader and the stream's position."""
        spans.adopt(carried)
        try:
            while True:
                ui = free.get()
                if ui is None or stop.is_set():
                    return
                with spans.span("iq2a.fill"):
                    uploads.wait(ui)
                    valid = self._fill_group(uploads.bufs[ui].numpy())
                ready.put((ui, valid, self._ended))
                if self._ended:
                    return
        except BaseException as exc:  # raised on the loop's thread
            ready.put(exc)

    @staticmethod
    def _take(ready) -> tuple[int, list[int], bool]:
        """The worker's next group, as an ``iq2a.take`` span that counts
        whether it was filled before it was asked for."""
        with spans.span("iq2a.take"):
            spans.count("ahead_groups", 1)
            spans.count("ahead_ready", int(not ready.empty()))
            got = ready.get()
        if isinstance(got, BaseException):
            raise got
        return got

    def _groups(self, uploads: _PinnedRing, device: torch.device):
        """Stage each dispatch group of ``super_chunks`` rows and start its
        copy to the device: yields (the device batch, valid frames per row).
        Each group's rows are filled in place in a pinned slot
        (:meth:`_fill`); a partial final group ends in silent rows that
        count nothing (valid = 0).

        The first group, which holds the warm-up's block, is filled here.
        If the stream goes on past it, a worker thread (:meth:`_read_ahead`)
        fills the next groups while this thread enqueues and writes: a slot
        goes back to it once its copy is queued (on the card, where the
        worker waits for the copy's event) or once the step that read it has
        returned (on the CPU, where the slot is the step's input).  The
        worker is stopped and joined however the loop ends."""
        frame_bytes = 2 * self.raw_first.itemsize  # an interleaved input frame
        free, ready, stop = queue.SimpleQueue(), queue.SimpleQueue(), threading.Event()
        worker = None
        try:
            while True:
                with spans.span("iq2a.stage"):
                    if worker is None:
                        host, ui = uploads.next()
                        valid, last = self._fill_group(host.numpy()), self._ended
                    else:
                        ui, valid, last = self._take(ready)
                        host = uploads.bufs[ui]
                    if valid[0]:
                        raw_dev = host.to(device, non_blocking=True)
                        uploads.record(ui)
                        spans.count("h2d_bytes", host.nbytes)
                        spans.count("input_bytes", sum(valid) * frame_bytes)
                if not valid[0]:
                    return  # the capture ended on the previous group's last row
                if worker is None and not last:
                    for other in range(len(uploads.bufs)):
                        if other != ui:
                            free.put(other)
                    thread = threading.Thread(
                        target=self._read_ahead, name="iq2a-read-ahead",
                        args=(uploads, free, ready, stop, spans.carry()),
                    )
                    thread.start()
                    worker = thread
                if uploads.cuda:
                    free.put(ui)
                yield raw_dev, valid
                if last:
                    return
                if not uploads.cuda:
                    free.put(ui)
        finally:
            if worker is not None:
                stop.set()
                free.put(None)
                worker.join()

    def _snapshot_chunk(self, state, accs, raw, rs_offset, slot):
        """The first chunk through ``fn_stages``; the snapshots come to the
        host at once (a cold path)."""
        state, stages = self.step.fn_stages(state, accs, raw, rs_offset, slot)
        for name, buf in stages.items():
            if isinstance(buf, tuple):  # (re, im)
                arr = buf[0].cpu().numpy() + 1j * buf[1].cpu().numpy()
            else:
                arr = buf.cpu().numpy()
            self.stage_snapshots[name] = arr
        return state

    def run(self, writers: list, state: dict, iq_writers: list | None = None) -> None:
        """``writers`` are the audio writers, or the slice writers of a
        pass-through step; ``iq_writers`` the IQ dump's (audio runs)."""
        step = self.step
        device = step.device
        rs_plan = step.rs_plan
        resampling = rs_plan is not None and not rs_plan.identity
        pass_through = step.pass_through
        dump_iq = step.dump_iq and not pass_through
        n_dec = step.ddc_plan.out_size
        acc_chunks = step.acc_chunks
        audio_cap = step.audio_capacity
        decimation = self.decimation
        tracker = self.tracker
        raw_dtype = torch.from_numpy(self.raw_first[:0]).dtype

        with spans.span("iq2a.alloc"):
            accs = step.init_accs()
            uploads = _PinnedRing(
                (step.super_chunks, 2 * step.chunk_size), raw_dtype, device
            )
            # one host ring per accumulator (audio, iq_r, iq_i), moved in step
            downloads = {
                name: _PinnedRing(tuple(acc.shape), acc.dtype, device)
                for name, acc in accs.items()
            }
        idx = 0  # device-consumed chunks
        pending = None  # (host buffer slot, counts) of a window not yet written
        window: list = []  # (dec_valid, audio_count) of the open window's chunks
        last_audio: dict = {}

        def drain(slot_i, counts):
            with spans.span("iq2a.drain"):
                host = {}
                for name, ring in downloads.items():
                    ring.wait(slot_i)
                    host[name] = ring.bufs[slot_i].numpy()
                if "iq_r" in host:
                    iq_np = host["iq_r"] + 1j * host["iq_i"]
                for s, (dec_valid, audio_count) in enumerate(counts):
                    if pass_through or dump_iq:
                        for c, w in enumerate(writers if pass_through else iq_writers):
                            _write(w.write, iq_np[c, s * n_dec : s * n_dec + dec_valid])
                    if not pass_through:
                        lo = s * audio_cap
                        for c, w in enumerate(writers):
                            audio = host["audio"][c, lo : lo + audio_count]
                            _write(w.write_s16, audio)
                if not pass_through:
                    last_audio.update(
                        buf=host["audio"], slot=len(counts) - 1, count=counts[-1][1]
                    )

        def close_window():
            """Fetch the window (one D2H, queued behind its compute) and
            write the window before it."""
            nonlocal pending
            if not self.fetch:
                return
            with spans.span("iq2a.fetch"):
                for name, ring in downloads.items():
                    host, di = ring.next()
                    host.copy_(accs[name], non_blocking=True)
                    ring.record(di)
            if pending is not None:
                drain(*pending)
            pending = (di, window)
            self.check_cancel(f"chunk {idx} encode")

        with contextlib.closing(self._groups(uploads, device)) as groups:
            for raw_dev, valid in groups:
                if not window:  # a window opens
                    self.check_cancel(f"chunk {idx + 1}")
                    if self.on_drained is not None and pending is not None:
                        drain(*pending)
                        pending = None
                        self.on_drained(state)
                # exact host bookkeeping (Python ints, no syncs)
                slot_base = idx % acc_chunks
                rs_offset = rs_plan.chunk_offset(self.rs_in_device) if resampling else 0
                group_dec = group_audio = 0
                for valid_frames in valid:
                    self.processed_samples += valid_frames
                    dec_total = -(-self.processed_samples // decimation)  # ceil
                    dec_valid = dec_total - self.dec_emitted
                    self.dec_emitted = dec_total
                    if resampling:
                        audio_count = rs_plan.out_count(self.rs_in_device, dec_valid)
                        self.rs_in_device += n_dec
                        self.rs_in_valid += dec_valid
                    else:
                        audio_count = 0 if pass_through else dec_valid
                    self.rs_emitted += audio_count
                    window.append((dec_valid, audio_count))
                    group_dec += dec_valid
                    group_audio += audio_count
                with spans.span("iq2a.step"):
                    if self.want_stages and idx == 0:
                        # stage runs dispatch chunk by chunk (super_chunks == 1)
                        state = self._snapshot_chunk(state, accs, raw_dev[0], rs_offset, slot_base)
                    elif step.super_chunks > 1:
                        state = step.fn_super(state, accs, raw_dev, rs_offset, slot_base)
                    else:
                        state = step.fn(state, accs, raw_dev[0], rs_offset, slot_base)
                    spans.count("chunks", len(valid))
                idx += len(valid)
                # progress from the host counters: no device sync
                tracker.advance("ingest", float(sum(valid)))
                tracker.advance("channel", float(group_dec))
                if dump_iq:
                    tracker.advance("dump_iq", float(group_dec))
                tracker.advance("demod", float(group_dec))
                if not pass_through:
                    tracker.advance("encode", float(group_audio))
                if len(window) == acc_chunks:
                    close_window()
                    window = []
        if window:
            close_window()
        if pending is not None:
            drain(*pending)
        self.dispatched = idx
        if not self.fetch and device.type == "cuda":
            with spans.span("iq2a.wait"):
                torch.cuda.synchronize(device)

        if resampling and "buf" in last_audio:
            # EOF flush: outputs of the final (incomplete) resampler block
            # exist in the last padded accumulator slot
            rs_emitted = self.rs_emitted
            extra = rs_plan.final_flush_count(self.rs_in_valid, rs_emitted)
            if extra > 0:
                buf = last_audio["buf"]
                if n_dec % rs_plan.down == 0:
                    per_chunk_out = (n_dec // rs_plan.down) * rs_plan.up
                    slot = (rs_emitted // per_chunk_out) % acc_chunks
                    lo = slot * audio_cap + (rs_emitted % per_chunk_out)
                    hi = min(lo + extra, (slot + 1) * audio_cap)
                else:
                    lo = last_audio["slot"] * audio_cap + last_audio["count"]
                    hi = min(lo + extra, (last_audio["slot"] + 1) * audio_cap)
                for c, w in enumerate(writers):
                    _write(w.write_s16, buf[c, lo:hi])
        if "buf" in last_audio:
            # the device peak covers the zero-padded tail too; consult it
            # only where the +-0.99 clipper engaged and the writers lost it
            clip_q = round(0.99 * 32767.0) / 32767.0 - 1e-6
            if any(w.peak >= clip_q for w in writers):
                peaks_np = state["peak"].cpu().numpy()
                for c, w in enumerate(writers):
                    if w.peak >= clip_q:
                        w.peak = max(w.peak, float(peaks_np[c]))
