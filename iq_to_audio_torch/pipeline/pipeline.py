"""Streaming pipeline orchestrator (port of the JAX package's
``pipeline/pipeline.py``, reduced to one NFM target).

Drives the chunk step (:mod:`.step`) from a host loop with:

* dispatch groups of ``super_chunks`` chunks, each uploaded from a pinned
  staging buffer with ``non_blocking=True``,
* one device-to-host copy per accumulation window, started behind the
  window's compute and drained one window later,
* exact host-side sample bookkeeping (valid counts for the padded final
  chunk and the resampler come from Python ints, never device syncs),
* the end-of-file resampler flush.

Not carried yet, each rejected with :class:`NotImplementedError` (see
``ROADMAP.md``): checkpoint/resume, pass-through, IQ dumps, stage plots,
progress sinks and cancel, more than one target, and the profiler hook.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..demod import DecoderStats, create_decoder
from ..io.formats import InputFormatSpec, resolve_input_format
from ..io.probe import SampleRateProbe, probe_sample_rate
from ..io.reader import IQReader, convert_to_complex
from ..io.writer import AudioWriter
from ..ops.ddc import DDCPlan, bandpass_kernel
from ..ops.nco import nco_increment_fixed
from ..ops.resample import ResamplePlan, design_resampler_kernel
from ..ref.chain import choose_mix_sign
from ..utils.freq import detect_center_frequency
from .config import ProcessingConfig
from .filters import compute_decimation, design_channel_filter, tune_chunk_size
from .step import build_chunk_step

LOG = logging.getLogger(__name__)

_OUTPUT_RATE = 48_000.0


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


def resolve_device(requested: str | None) -> torch.device:
    """The run's device: ``None`` means the card.  There is no fallback to
    the CPU: without a CUDA device only an explicit ``"cpu"`` runs."""
    device = torch.device(requested or "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "No CUDA device is available; pass device='cpu' to run the "
                "plain torch path on the CPU."
            )
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is True: TF32 misses "
                "the -60 dB audio contract; the pipeline needs full float32."
            )
    return device


def _unsupported(cfg: ProcessingConfig, progress_sink) -> str | None:
    if cfg.checkpoint_secs or cfg.resume:
        return "checkpoint/resume"
    if (cfg.demod_mode or "").lower() in {"none", "pass", "iq"}:
        return "pass-through (--demod none)"
    if cfg.dump_iq_path is not None:
        return "IQ dumps"
    if cfg.plot_stages_path is not None:
        return "stage plots"
    if cfg.profile_dir is not None:
        return "the profiler hook"
    if cfg.extra_target_freqs or cfg.extra_output_paths:
        return "more than one target"
    if progress_sink is not None:
        return "progress sinks and cancel"
    return None


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
        if self.events[i] is not None:
            self.events[i].synchronize()
            self.events[i] = None
        return self.bufs[i], i

    def record(self, i: int) -> None:
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record()
            self.events[i] = ev

    def wait(self, i: int) -> None:
        if self.events[i] is not None:
            self.events[i].synchronize()
            self.events[i] = None


class ProcessingPipeline:
    def __init__(self, config: ProcessingConfig):
        self.config = config
        self._input_spec: InputFormatSpec | None = None

    def run(self, progress_sink=None) -> ProcessingResult:
        cfg = self.config
        missing = _unsupported(cfg, progress_sink)
        if missing is not None:
            raise NotImplementedError(
                f"{missing} is not ported to the torch pipeline yet (see ROADMAP.md)"
            )
        device = resolve_device(cfg.device)
        if self._input_spec is None:
            spec, source = resolve_input_format(
                cfg.in_path, requested=cfg.input_format, container_hint=cfg.input_container
            )
            self._input_spec = spec
            if not cfg.input_format_source:
                cfg.input_format_source = source
            if not cfg.input_container:
                cfg.input_container = spec.container
            if not cfg.input_format:
                cfg.input_format = spec.codec
        input_spec = self._input_spec

        manual_rate = cfg.input_sample_rate
        if manual_rate is not None and manual_rate <= 0:
            raise ValueError("Input sample rate override must be positive.")

        # --- probing ---------------------------------------------------------
        if input_spec.container == "raw":
            if manual_rate is None:
                raise ValueError(
                    "Raw IQ inputs require --input-sample-rate (CLI) or a "
                    "manual entry in the GUI."
                )
            sample_rate = float(manual_rate)
            probe = SampleRateProbe(override=sample_rate)
        else:
            probe = probe_sample_rate(cfg.in_path)
            if manual_rate is not None:
                sample_rate = float(manual_rate)
                probe = dataclasses.replace(probe, override=sample_rate)
            else:
                try:
                    sample_rate = probe.value
                except RuntimeError as exc:
                    raise RuntimeError(
                        "Unable to determine input sample rate automatically. "
                        "Provide --input-sample-rate or enter it manually."
                    ) from exc

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

        if cfg.target_freq <= 0 and not cfg.probe_only:
            raise ValueError(
                "Target frequency must be positive. Provide --ft or use --interactive."
            )
        if cfg.bandwidth <= 0:
            raise ValueError("Bandwidth must be positive.")

        center_freq = cfg.center_freq
        if center_freq is None:
            detection = detect_center_frequency(cfg.in_path)
            if detection.value is None:
                raise ValueError(
                    "Center frequency not supplied and could not be determined "
                    "from metadata or filename. Use --fc to provide it explicitly."
                )
            center_freq = detection.value
            cfg.center_freq = center_freq
            cfg.center_freq_source = detection.source
            LOG.info("Center frequency detected via %s.", detection.source)

        target_freq = cfg.target_freq if cfg.target_freq > 0 else center_freq
        freq_offset = target_freq - center_freq
        decimation, fs_channel = compute_decimation(sample_rate, cfg.fs_ch_target)
        LOG.info(
            "Input %.2f Hz, center %.0f Hz, target %.0f Hz (offset %.0f Hz), "
            "decimation %d -> %.2f Hz, device %s.",
            sample_rate, center_freq, target_freq, freq_offset, decimation,
            fs_channel, device,
        )

        # --- geometry / plans ------------------------------------------------
        taps = design_channel_filter(sample_rate, cfg.bandwidth, decimation)
        target_chunk = tune_chunk_size(sample_rate, cfg.chunk_size)
        if device.type == "cuda" and cfg.chunk_size >= 1_048_576:
            # the card amortises per-chunk launch and copy latency: prefer
            # the 4Mi cap unless the user asked for less
            target_chunk = max(target_chunk, 1 << 22)
        rate_plan = ResamplePlan.create(fs_channel, _OUTPUT_RATE, 1)
        rs_align = 1 if rate_plan.identity else rate_plan.down
        ddc_plan = DDCPlan.create(
            len(taps), decimation, target_chunk=target_chunk, out_align=rs_align,
            max_chunk=1 << 22,
        )
        chunk_size = ddc_plan.chunk_size
        n_dec = ddc_plan.out_size
        rs_plan = ResamplePlan.create(fs_channel, _OUTPUT_RATE, n_dec)

        reader = IQReader(
            cfg.in_path,
            chunk_size,
            cfg.iq_order,
            input_spec,
            sample_rate=sample_rate if input_spec.container == "raw" else None,
            start_frame=seg_start,
            prefetch_depth=0,  # synchronous reads: no Python thread beside dispatch
        )
        audio_writers: list[AudioWriter] = []
        try:
            with reader:
                total_input_samples = float(reader.total_frames)
                if max_input_samples is not None:
                    total_input_samples = (
                        float(min(total_input_samples, max_input_samples))
                        if total_input_samples > 0
                        else float(max_input_samples)
                    )
                estimated_chunks = (
                    int(math.ceil(total_input_samples / chunk_size))
                    if total_input_samples > 0
                    else 0
                )

                # --- warm-up: first block + mixer sign -----------------------
                raw_first = reader.read_block_raw()
                if raw_first is None or raw_first.size == 0:
                    raise RuntimeError("Input stream produced no samples.")
                if cfg.mix_sign_override in (1, -1):
                    mix_sign = cfg.mix_sign_override
                else:
                    probe_len = min(
                        raw_first.size // 2,
                        max(int(sample_rate * 0.05), len(taps) * 4, 131_072),
                    )
                    warm = convert_to_complex(
                        raw_first[: 2 * probe_len], input_spec.codec, cfg.iq_order
                    )
                    mix_sign = choose_mix_sign(warm, sample_rate, freq_offset, taps, decimation)
                LOG.info("Selected mixer sign %d based on warm-up snippet.", mix_sign)
                if cfg.probe_only:
                    return ProcessingResult(
                        sample_rate_probe=probe,
                        center_freq=center_freq,
                        target_freq=target_freq,
                        freq_offset=freq_offset,
                        decimation=decimation,
                        fs_channel=fs_channel,
                        mix_sign=mix_sign,
                        audio_peak=0.0,
                    )

                out_path = cfg.output_path or cfg.in_path.with_name(
                    f"audio_{int(target_freq)}_48k.wav"
                )
                out_path.parent.mkdir(parents=True, exist_ok=True)
                audio_writers = [AudioWriter(out_path)]

                # --- build the device step -----------------------------------
                incs = [nco_increment_fixed(freq_offset, sample_rate, sign=mix_sign)]
                decoder = create_decoder(
                    cfg.demod_mode, deemph_us=cfg.deemph_us, agc_enabled=cfg.agc_enabled
                )
                decoder.setup(fs_channel)
                step = build_chunk_step(
                    ddc_plan=ddc_plan,
                    rs_plan=rs_plan,
                    ddc_kernel_np=bandpass_kernel(taps, incs),
                    rs_kernel_np=(
                        None if rs_plan.identity
                        else design_resampler_kernel(rs_plan.up, rs_plan.down)
                    ),
                    incs_fixed=incs,
                    codec=input_spec.codec,
                    iq_order=cfg.iq_order,
                    decoder=decoder,
                    device=device,
                    est_total_chunks=(
                        None if cfg.fixed_device_geometry else (estimated_chunks or None)
                    ),
                )
                loop = _ChunkLoop(step, reader, raw_first, max_input_samples, decimation)
                loop_start = time.perf_counter()
                loop.run(audio_writers)
                loop_seconds = time.perf_counter() - loop_start
                decoder.finalize()
                for w in audio_writers:
                    w.close()
        finally:
            for w in audio_writers:
                w.close()

        if loop.limit_exhausted and preview_seconds is not None:
            LOG.info(
                "Stopped after %.2f s due to preview limit.",
                loop.processed_samples / sample_rate,
            )
        peaks = [w.peak for w in audio_writers]
        rms_list = [w.rms_dbfs for w in audio_writers]
        LOG.info(
            "[%d] Audio peak level %.2f dBFS, RMS %.2f dBFS.",
            int(target_freq), 20.0 * math.log10(max(peaks[0], 1e-6)), rms_list[0],
        )
        return ProcessingResult(
            sample_rate_probe=probe,
            center_freq=center_freq,
            target_freq=target_freq,
            freq_offset=freq_offset,
            decimation=decimation,
            fs_channel=fs_channel,
            mix_sign=mix_sign,
            audio_peak=peaks[0],
            audio_peaks=peaks,
            stats=[DecoderStats(rms_dbfs=r) for r in rms_list],
            output_paths=[out_path],
            loop_seconds=loop_seconds,
            input_samples=loop.processed_samples,
            dispatched_chunks=loop.dispatched,
        )


class _ChunkLoop:
    """The window / group / chunk loop with its exact host counters."""

    def __init__(self, step, reader, raw_first, max_input_samples, decimation):
        self.step = step
        self.reader = reader
        self.raw_first = raw_first
        self.max_input_samples = max_input_samples
        self.decimation = decimation
        self.limit_exhausted = False
        self.processed_samples = 0
        self.dispatched = 0

    def _raw_blocks(self):
        """Valid-sliced, silence-padded raw blocks (owned arrays)."""
        chunk_size = self.step.chunk_size
        # raw-domain pad value decoding to 0.0: u8 is offset-binary
        raw_zero = 128 if self.step.codec == "pcm_u8" else 0
        consumed = 0
        block = self.raw_first
        while True:
            valid = block.size // 2
            if self.max_input_samples is not None:
                remaining = self.max_input_samples - consumed
                if remaining <= 0:
                    self.limit_exhausted = True
                    return
                if valid > remaining:
                    block = block[: 2 * remaining]
                    valid = remaining
                    self.limit_exhausted = True
            if valid:
                if block.size < 2 * chunk_size:
                    padded = np.full(2 * chunk_size, raw_zero, dtype=block.dtype)
                    padded[: block.size] = block
                    block = padded
                consumed += valid
                yield valid, block
            if self.limit_exhausted:
                return
            nxt = self.reader.read_block_raw()
            if nxt is None or nxt.size == 0:
                return
            block = nxt

    def _groups(self):
        """Groups of ``super_chunks`` blocks; a partial final group is padded
        with silent chunks that count nothing (valid = 0)."""
        s = self.step.super_chunks
        group = []
        for item in self._raw_blocks():
            group.append(item)
            if len(group) == s:
                yield group
                group = []
        if group:
            pad = np.full_like(group[0][1], 128 if self.step.codec == "pcm_u8" else 0)
            while len(group) < s:
                group.append((0, pad))
            yield group

    def _windows(self):
        """Window-sized batches of groups (``acc_chunks`` chunks)."""
        batch, count = [], 0
        for group in self._groups():
            batch.append(group)
            count += len(group)
            if count == self.step.acc_chunks:
                yield batch
                batch, count = [], 0
        if batch:
            yield batch

    def run(self, audio_writers: list[AudioWriter]) -> None:
        step = self.step
        device = step.device
        rs_plan = step.rs_plan
        n_dec = step.ddc_plan.out_size
        acc_chunks = step.acc_chunks
        audio_cap = step.audio_capacity
        decimation = self.decimation
        raw_dtype = torch.from_numpy(self.raw_first[:0]).dtype

        state = step.init_state(int(self.reader.start_frame))
        accs = step.init_accs()
        uploads = _PinnedRing(
            (step.super_chunks, 2 * step.chunk_size), raw_dtype, device
        )
        downloads = _PinnedRing(tuple(accs["audio"].shape), torch.int16, device)
        rs_in_device = 0  # decimated samples consumed by the device
        rs_in_valid = 0  # decimated samples that were real (not pad)
        rs_emitted = 0  # 48 kHz samples written so far
        dec_emitted = 0
        idx = 0  # device-consumed chunks
        pending = None  # (host buffer slot, counts) drained one window later
        last_audio: dict = {}

        def drain(slot_i, counts):
            downloads.wait(slot_i)
            audio_np = downloads.bufs[slot_i].numpy()
            for s, (_dec_valid, audio_count) in enumerate(counts):
                lo = s * audio_cap
                for c, w in enumerate(audio_writers):
                    w.write_s16(audio_np[c, lo : lo + audio_count])
            last_audio.update(buf=audio_np, slot=len(counts) - 1, count=counts[-1][1])

        for wgroups in self._windows():
            window = []
            for group in wgroups:
                # stage and upload the group (async H2D from pinned memory)
                host, ui = uploads.next()
                host_np = host.numpy()
                for s, (_v, blk) in enumerate(group):
                    host_np[s] = blk
                raw_dev = host.to(device, non_blocking=True)
                uploads.record(ui)
                # exact host bookkeeping (Python ints, no syncs)
                slot_base = idx % acc_chunks
                rs_offset = rs_plan.chunk_offset(rs_in_device) if not rs_plan.identity else 0
                for valid_frames, _blk in group:
                    self.processed_samples += valid_frames
                    dec_total = -(-self.processed_samples // decimation)  # ceil
                    dec_valid = dec_total - dec_emitted
                    dec_emitted = dec_total
                    if not rs_plan.identity:
                        audio_count = rs_plan.out_count(rs_in_device, dec_valid)
                        rs_in_device += n_dec
                        rs_in_valid += dec_valid
                        rs_emitted += audio_count
                    else:
                        audio_count = dec_valid
                    window.append((dec_valid, audio_count))
                if step.super_chunks > 1:
                    state = step.fn_super(state, accs, raw_dev, rs_offset, slot_base)
                else:
                    state = step.fn(state, accs, raw_dev[0], rs_offset, slot_base)
                idx += len(group)
            # one D2H per window, queued behind its compute on the stream
            host, di = downloads.next()
            host.copy_(accs["audio"], non_blocking=True)
            downloads.record(di)
            if pending is not None:
                drain(*pending)
            pending = (di, window)
        if pending is not None:
            drain(*pending)
        self.dispatched = idx

        if not rs_plan.identity and "buf" in last_audio:
            # EOF flush: outputs of the final (incomplete) resampler block
            # exist in the last padded accumulator slot
            extra = rs_plan.final_flush_count(rs_in_valid, rs_emitted)
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
                for c, w in enumerate(audio_writers):
                    w.write_s16(buf[c, lo:hi])
        if "buf" in last_audio:
            # the device peak covers the zero-padded tail too; consult it
            # only where the +-0.99 clipper engaged and the writers lost it
            clip_q = round(0.99 * 32767.0) / 32767.0 - 1e-6
            if any(w.peak >= clip_q for w in audio_writers):
                peaks_np = state["peak"].cpu().numpy()
                for c, w in enumerate(audio_writers):
                    if w.peak >= clip_q:
                        w.peak = max(w.peak, float(peaks_np[c]))
