"""Command-line front end of the port (``python -m iq_to_audio_torch``).

Every flag of the JAX package's command line is parsed.  What runs:
``--cli`` with one to five ``--ft``, ``--demod`` (``none`` included),
``--dump-iq``, ``--plot-stages``, ``--spectrum-png``, ``--probe-only``,
``--preview``, ``--benchmark*``, ``--profile-dir``,
``--checkpoint-secs``/``--resume``, burst mode (``--burst-segments N``
above 1 with ``--burst-cpu-workers K``: the capture is split between the
device stream and K host-CPU worker processes, :mod:`.pipeline.hetero`),
sequence parallelism (``--seq-parallel``: one capture sharded over one rank
per device, :mod:`.parallel`), and several ``--in``: batched one capture
per ``dp`` row of the mesh when the device count is a multiple of the
capture count and the run is a plain demodulation, else one capture after
the other.  One flag is the port's own: ``--device`` (default ``cuda``;
``cpu`` runs each kernel's plain version, with ``IQ2A_CPU_RANKS`` ranks for
the sharded paths), where the JAX package reads ``JAX_PLATFORMS``; the
burst mode's CPU workers run on the CPU whatever it says.

The front ends of the JAX command line run too, with its exit codes and
messages: ``--audio-post*`` (batch squelch of finished WAVs, host numpy,
:mod:`.post.squelch`), the ``digital`` subcommand (a decoder in the backend
container, :mod:`.post.docker_backend`), and the GUI (``--interactive``, or
no ``--cli``): the window's snapshot runs on ``--device``, and its confirmed
configs run through the serial pipeline (or burst mode) here.  Without
PySide6 the GUI runs only under ``IQ2A_QT=headless``; without matplotlib,
no ``--cli`` falls back to terminal mode.
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
from pathlib import Path

from . import __version__
from .io.formats import parse_user_format
from .pipeline.benchmark import run_benchmark
from .pipeline.capture import MAX_TARGETS, channel_paths
from .pipeline.config import ProcessingConfig
from .pipeline.pipeline import ProcessingCancelled, ProcessingPipeline, ProcessingResult
from .pipeline.preview import run_preview
from .pipeline.progress import TqdmProgressSink
from .post.digital import DEFAULT_DECODER_KEY, DIGITAL_DECODERS, get_decoder
from .post.squelch import (
    AudioPostOptions,
    SquelchConfig,
    gather_audio_targets,
    process_audio_batch,
)

LOG = logging.getLogger("iq_to_audio_torch")


def positive_float(value: str) -> float:
    """argparse type: a strictly positive float."""
    try:
        parsed = float(value)
    except ValueError as exc:
        raise argparse.ArgumentTypeError(str(exc)) from exc
    if parsed <= 0:
        raise argparse.ArgumentTypeError("Expected a positive value.")
    return parsed


def _die(what: str, exc: Exception, verbose: bool) -> int:
    """Uniform failure exit used by every CLI mode: one ERROR line, full
    traceback only under ``--verbose``.  Must be called from inside the
    ``except`` block so ``LOG.exception`` sees the active exception."""
    LOG.error("%s: %s", what, exc)
    if verbose:
        LOG.exception("%s — debug traceback", what)
    return 1


DIGITAL_DECODER_KEYS: tuple[str, ...] = tuple(d.key for d in DIGITAL_DECODERS)


def _add_digital_subcommand(parser: argparse.ArgumentParser) -> None:
    sub = parser.add_subparsers(dest="subcommand", metavar="command")
    digital = sub.add_parser(
        "digital",
        help="Run a digital decoder inside the backend container.",
        description=(
            "Bind-mounts a directory of exported audio into the "
            "iq-to-audio backend container and runs a decoder preset "
            "(e.g. DSD-FME), or an explicit command, over it."
        ),
    )
    digital.add_argument("--audio-dir", type=Path, required=True,
                         help="Directory of exported audio to mount inside the container.")
    digital.add_argument("--decoder", choices=DIGITAL_DECODER_KEYS, default=DEFAULT_DECODER_KEY,
                         help="Decoder preset to run (default: %(default)s).")
    digital.add_argument("--image", default=None, help="Override the backend Docker image.")
    digital.add_argument("--no-pull", dest="pull", action="store_false", default=True,
                         help="Never pull the backend image; fail if it is missing locally.")
    digital.add_argument("decoder_args", nargs=argparse.REMAINDER,
                         help="Explicit container command (prefix with -- to pass flags).")


def _digital_command_tokens(args: argparse.Namespace) -> tuple[str, ...]:
    """The container command: an explicit trailing command wins, otherwise
    the selected preset's default.  Raises ValueError on unusable input."""
    tokens = list(getattr(args, "decoder_args", None) or [])
    if tokens[:1] == ["--"]:
        tokens = tokens[1:]
    if tokens:
        return tuple(tokens)
    try:
        preset = get_decoder(args.decoder)
    except KeyError as exc:
        raise ValueError(f"Unsupported decoder preset: {args.decoder}") from exc
    if not preset.default_command:
        raise ValueError("No command specified for backend container.")
    return preset.default_command


def _existing_dir(path: Path) -> Path:
    if not path.exists():
        raise ValueError(f"Audio directory does not exist: {path}")
    if not path.is_dir():
        raise ValueError(f"Audio path is not a directory: {path}")
    return path


def run_digital_command(args: argparse.Namespace) -> int:
    """``iq-to-audio-torch digital …``: one linear flow, every user error
    funneled through ValueError/DockerBackendError into a single exit path."""
    from .post import docker_backend as db

    try:
        command = _digital_command_tokens(args)
        launch = db.DockerLaunchRequest(
            command=command,
            audio_dir=_existing_dir(args.audio_dir),
            decoder_key=args.decoder,
            pull_if_missing=bool(args.pull),
        )
        backend = db.DockerBackend(
            config=db.DockerBackendConfig(image=args.image or db.DEFAULT_IMAGE)
        )
        backend.ensure_connection()
        LOG.info("Backend decoder '%s': %s", args.decoder, " ".join(command))
        backend.run_and_stream(
            launch, log_callback=lambda text: print(text, end="", flush=True)
        )
    except (ValueError, db.DockerBackendError) as exc:
        LOG.error("%s", exc)
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description=(
            "Extract and demodulate narrowband channels from SDR baseband "
            "recordings (PyTorch/CUDA engine)."
        ),
    )
    parser.add_argument("--in", dest="input_path", required=False, type=Path,
                        action="append", default=None,
                        help="Input SDR++ baseband WAV file (repeat to process several "
                             "captures: batched over the devices when their count is a "
                             "multiple of the capture count, else one after the other).")
    parser.add_argument("--ft", dest="target_freqs", type=positive_float, action="append",
                        default=None,
                        help="Target RF frequency in Hz. Supply up to five times to batch additional channels.")
    parser.add_argument("--bw", dest="bandwidth", type=positive_float, default=12_500.0,
                        help="Channel bandwidth in Hz (default: 12500).")
    parser.add_argument("--fc", dest="center_freq", type=positive_float,
                        help="Override center frequency in Hz if filename parsing fails.")
    parser.add_argument("--fs-ch", dest="fs_ch", type=positive_float, default=96_000.0,
                        help="Desired complex channel sample rate prior to demod (default: 96 kHz).")
    parser.add_argument("--demod", dest="demod",
                        choices=["nfm", "am", "usb", "lsb", "ssb", "none"], default="nfm",
                        help="Demodulator (nfm, am, usb, lsb, ssb=alias for usb, none=no demodulation). Default: nfm.")
    parser.add_argument("--deemph", dest="deemph_us", type=positive_float, default=300.0,
                        help="FM de-emphasis time constant in microseconds (default: 300).")
    parser.add_argument("--no-agc", dest="agc_enabled", action="store_false",
                        help="Disable automatic gain control in supported demodulators.")
    parser.add_argument("--out", dest="output_path", type=Path,
                        help="Output WAV path. Defaults to audio_<FT>_48k.wav alongside input.")
    parser.add_argument("--dump-iq", dest="dump_iq", type=Path,
                        help="Optional path to write channelized complex float32 IQ (cf32).")
    parser.add_argument("--plot-stages", dest="plot_stages", type=Path,
                        help="Save PSD plots for major pipeline stages to the given PNG path.")
    parser.add_argument("--spectrum-png", dest="spectrum_png", type=Path,
                        help="Render the capture's averaged PSD + waterfall to this PNG "
                             "(headless analogue of the GUI snapshot; usable without --ft).")
    parser.add_argument("--spectrum-seconds", dest="spectrum_seconds",
                        type=positive_float, default=4.0,
                        help="Seconds of IQ streamed into --spectrum-png (default: 4.0).")
    parser.add_argument("--chunk", dest="chunk_size", type=int, default=1_048_576,
                        help="Complex samples per processing chunk (default: 1,048,576).")
    parser.add_argument("--fft-workers", dest="fft_workers", type=int,
                        help="Accepted for compatibility; torch owns FFT parallelism.")
    parser.add_argument("--filter-block", dest="filter_block", type=int, default=65_536,
                        help="FFT block size hint for the overlap-save channel filter (default: 65536).")
    parser.add_argument("--strict-filter-block", dest="auto_filter_block", action="store_false",
                        help="Honor --filter-block verbatim instead of auto-optimizing the FFT size.")
    parser.add_argument("--iq-order", dest="iq_order",
                        choices=["iq", "qi", "iq_inv", "qi_inv"], default="iq",
                        help="Interpretation of the stereo channels: iq (default), qi, iq_inv, qi_inv.")
    parser.add_argument("--input-format", dest="input_format", type=str,
                        help="Override input encoding (wav-s16, wav-u8, wav-f32, raw-cu8, raw-cs16, raw-cf32).")
    parser.add_argument("--input-sample-rate", dest="input_sample_rate", type=positive_float,
                        help="Manual input sample rate in Hz (used when headers are missing).")
    parser.add_argument("--mix-sign", dest="mix_sign", type=int, choices=[-1, 1],
                        help="Override automatic mixer sign selection.")
    parser.add_argument("--probe-only", dest="probe_only", action="store_true",
                        help="Probe metadata and exit without demodulating.")
    parser.add_argument("--interactive", dest="interactive", action="store_true",
                        help="Launch interactive spectrum viewer to pick frequency/bandwidth.")
    parser.add_argument("--interactive-seconds", dest="interactive_seconds",
                        type=positive_float, default=2.0,
                        help="Duration of IQ snapshot (seconds) for interactive mode (default: 2.0).")
    parser.add_argument("--preview", dest="preview_seconds", type=positive_float,
                        help="Preview only the first SECONDS of the recording and exit.")
    parser.add_argument("--benchmark", dest="benchmark", action="store_true",
                        help="Run a synthetic throughput benchmark and exit.")
    parser.add_argument("--benchmark-seconds", dest="benchmark_seconds",
                        type=positive_float, default=5.0,
                        help="Duration of synthetic capture in seconds when benchmarking (default: 5).")
    parser.add_argument("--benchmark-sample-rate", dest="benchmark_sample_rate",
                        type=positive_float, default=2_500_000.0,
                        help="Sample rate in Hz for synthetic benchmark captures (default: 2.5e6).")
    parser.add_argument("--benchmark-offset", dest="benchmark_offset", type=float,
                        default=25_000.0,
                        help="Frequency offset (Hz) between center and target for benchmark tone (default: 25 kHz).")
    parser.add_argument("--benchmark-channels", dest="benchmark_channels", type=int,
                        default=1, choices=range(1, 6), metavar="N",
                        help="Batch N channels through the shared channelizer pass when benchmarking (default: 1).")
    parser.add_argument("--cli", dest="cli", action="store_true",
                        help="Run in CLI mode (default launches the interactive GUI when available).")
    parser.add_argument("--audio-post", dest="audio_post_path", type=Path,
                        help="Apply audio post-processing (auto squelch) to the given file or directory.")
    parser.add_argument("--audio-post-mode", dest="audio_post_mode",
                        choices=["adaptive", "static", "transient"], default="adaptive",
                        help="Squelch algorithm to use when --audio-post is supplied (default: adaptive).")
    parser.add_argument("--audio-post-noise-floor", dest="audio_post_noise_floor", type=float,
                        help="Manual noise floor in dBFS for --audio-post (auto-detected by default).")
    parser.add_argument("--audio-post-noise-percentile", dest="audio_post_percentile",
                        type=float, default=0.2,
                        help="Percentile used for auto noise floor estimation (default: 0.2).")
    parser.add_argument("--audio-post-threshold", dest="audio_post_threshold", type=float,
                        default=6.0,
                        help="Margin above noise floor in dBFS for the squelch threshold (default: 6).")
    parser.add_argument("--audio-post-lead", dest="audio_post_lead", type=float, default=0.15,
                        help="Lead-in seconds retained when trimming silence (default: 0.15).")
    parser.add_argument("--audio-post-trail", dest="audio_post_trail", type=float, default=0.35,
                        help="Trailing seconds retained when trimming silence (default: 0.35).")
    parser.add_argument("--audio-post-no-trim", dest="audio_post_trim", action="store_false",
                        help="Disable silence trimming when performing --audio-post.")
    parser.add_argument("--audio-post-overwrite", dest="audio_post_overwrite",
                        action="store_true",
                        help="Overwrite original files when performing --audio-post.")
    parser.add_argument("--audio-post-suffix", dest="audio_post_suffix", default="-cleaned",
                        help="Suffix to append when writing cleaned copies (default: -cleaned).")
    parser.add_argument("--audio-post-stream-mb", dest="audio_post_stream_mb",
                        type=positive_float, default=None,
                        help="WAVs with more data than this many MiB are squelched by the "
                             "bounded-memory streaming engine (byte-identical output; default "
                             "256 MiB, or $IQ2A_POST_BLOCK_BYTES).")
    parser.add_argument("--profile-dir", dest="profile_dir", type=Path,
                        help="Write a torch.profiler Chrome trace of the chunk loop to this directory.")
    parser.add_argument("--checkpoint-secs", dest="checkpoint_secs", type=positive_float,
                        help="Checkpoint the stream state every N seconds of input for --resume.")
    parser.add_argument("--resume", dest="resume", action="store_true",
                        help="Resume an interrupted run from its checkpoint (requires --checkpoint-secs on the original run).")
    parser.add_argument("--burst-segments", dest="burst_segments", type=int, default=0,
                        help="Burst mode: split the capture into N frame-aligned segments processed "
                             "concurrently by the device stream and host-CPU workers, then splice "
                             "the audio (0 or 1 = off).")
    parser.add_argument("--burst-cpu-workers", dest="burst_cpu_workers", type=int, default=1,
                        help="Host-CPU worker subprocesses for --burst-segments (0 = device stream only).")
    parser.add_argument("--seq-parallel", dest="seq_parallel",
                        choices=["auto", "on", "off"], default="auto",
                        help="Shard one capture across the devices, one rank per device "
                             "(auto: when at least two are visible; on: always, failing "
                             "loudly when the run cannot shard; off: never).  With "
                             "--device cpu the ranks are IQ2A_CPU_RANKS (default 1).")
    parser.add_argument("--device", dest="device", default="cuda",
                        help="torch device of the run (default: cuda; there is no "
                             "fallback: without a card only --device cpu runs).")
    parser.add_argument("--verbose", dest="verbose", action="store_true",
                        help="Enable debug logging.")
    parser.add_argument("--version", action="version", version=__version__,
                        help="Print the version and exit.")
    parser.set_defaults(agc_enabled=True)
    parser.set_defaults(audio_post_trim=True)
    parser.set_defaults(auto_filter_block=True)
    _add_digital_subcommand(parser)
    return parser


# --audio-post-* flag -> SquelchConfig field plumbing, declaratively
_SQUELCH_FLAG_FIELDS = {
    "method": "audio_post_mode",
    "manual_noise_floor_db": "audio_post_noise_floor",
    "noise_floor_percentile": "audio_post_percentile",
    "threshold_margin_db": "audio_post_threshold",
    "trim_silence": "audio_post_trim",
    "trim_lead_seconds": "audio_post_lead",
    "trim_trail_seconds": "audio_post_trail",
}


def _post_options(args: argparse.Namespace) -> AudioPostOptions:
    fields = {dst: getattr(args, src) for dst, src in _SQUELCH_FLAG_FIELDS.items()}
    fields["auto_noise_floor"] = args.audio_post_noise_floor is None
    return AudioPostOptions(
        config=SquelchConfig(**fields),
        overwrite=args.audio_post_overwrite,
        cleaned_suffix=args.audio_post_suffix,
        stream_threshold_bytes=(
            int(args.audio_post_stream_mb * 1024 * 1024)
            if args.audio_post_stream_mb is not None else None
        ),
    )


def _run_audio_post(args: argparse.Namespace) -> int:
    post_options = _post_options(args)
    try:
        post_targets = gather_audio_targets(args.audio_post_path, post_options)
    except Exception as exc:
        return _die("Unable to enumerate audio targets", exc, args.verbose)
    if not post_targets:
        LOG.error("No audio files found at %s.", args.audio_post_path)
        return 1
    naming = (
        "overwrite"
        if post_options.overwrite
        else f"suffix '{post_options.cleaned_suffix}'"
    )
    LOG.info(
        "Audio post-processing %d file(s) via %s squelch (%s).",
        len(post_targets),
        post_options.config.method,
        naming,
    )

    def _progress(completed: int, total: int, current: Path) -> None:
        if total > 0:
            pct = 100.0 * min(max(completed, 0), total) / total
            LOG.info(" [%6.2f%%] %s", pct, current)
        else:
            LOG.info("Processing %s", current)

    summary = process_audio_batch(post_targets, post_options, progress_cb=_progress)
    for item in summary.results:
        LOG.info(
            "%s -> %s | %.2fs -> %.2fs | %.1f%% retained | floor %.1f dB "
            "| threshold %.1f dB",
            item.input_path, item.output_path, item.duration_in,
            item.duration_out, item.retained_ratio * 100.0,
            item.noise_floor_db, item.threshold_db,
        )
    if summary.errors:
        LOG.error("Audio post-processing failed on %d file(s).", summary.failed)
        for path, error in summary.errors:
            LOG.error(" - %s: %s", path, error)
        return 1
    LOG.info(
        "Audio post-processing complete: delta-size %+d bytes, delta-duration %+0.2f s.",
        summary.aggregate_size_delta(),
        summary.aggregate_duration_delta(),
    )
    return 0


def _render_capture_spectrum(
    args: argparse.Namespace,
    input_fmt: tuple[str | None, str | None, str | None],
) -> None:
    """``--spectrum-png``: stream a snapshot of the capture into a PSD +
    waterfall PNG (the headless analogue of the GUI snapshot page)."""
    from .analysis.visualize import save_capture_spectrum
    from .io.formats import resolve_input_format
    from .io.probe import probe_sample_rate
    from .utils.freq import detect_center_frequency

    codec, container, _src = input_fmt
    spec, _source = resolve_input_format(
        args.input_path, requested=codec, container_hint=container
    )
    if args.input_sample_rate is not None:
        sample_rate = float(args.input_sample_rate)
    elif spec.requires_sample_rate:
        raise ValueError(
            "Raw captures need --input-sample-rate for --spectrum-png."
        )
    else:
        sample_rate = probe_sample_rate(args.input_path).value
    center = args.center_freq
    if center is None:
        center = detect_center_frequency(args.input_path).value
    out = save_capture_spectrum(
        args.input_path,
        args.spectrum_png,
        spec=spec,
        sample_rate=sample_rate,
        seconds=args.spectrum_seconds,
        center_freq=center,
        iq_order=args.iq_order,
        device=args.device,
    )
    LOG.info("Capture spectrum written to %s", out)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if getattr(args, "subcommand", None) == "digital":
        logging.basicConfig(
            level=logging.DEBUG if getattr(args, "verbose", False) else logging.INFO,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        )
        return run_digital_command(args)

    if args.cli and args.interactive:
        parser.error("--cli cannot be combined with --interactive.")
    if args.audio_post_path and args.interactive:
        parser.error("--audio-post cannot be combined with --interactive.")
    if args.audio_post_path and args.benchmark:
        parser.error("--audio-post cannot be combined with --benchmark.")
    if args.audio_post_path and not 0.0 <= args.audio_post_percentile <= 1.0:
        parser.error("--audio-post-noise-percentile must be between 0.0 and 1.0.")
    if args.benchmark and args.interactive:
        parser.error("--benchmark cannot be combined with --interactive.")

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )

    if args.audio_post_path:
        return _run_audio_post(args)

    frequencies: list[float] = list(args.target_freqs or [])
    # keep the list for the multi-capture loop, the first path everywhere else
    input_paths: list[Path] = list(args.input_path or [])
    args.input_path = input_paths[0] if input_paths else None

    # (codec, container, source) from an explicit --input-format override
    input_fmt: tuple[str | None, str | None, str | None] = (None, None, None)
    if args.input_format:
        try:
            container, codec = parse_user_format(args.input_format, default_container=None)
        except ValueError as exc:
            parser.error(f"--input-format: {exc}")
        input_fmt = (codec, container, "cli")

    if len(frequencies) > MAX_TARGETS:
        parser.error("At most five target frequencies are supported per run.")
    for n, freq in enumerate(frequencies):
        if any(
            math.isclose(freq, prior, rel_tol=0.0, abs_tol=0.5)
            for prior in frequencies[:n]
        ):
            parser.error("Duplicate target frequencies are not allowed.")

    # flags whose dest already IS the ProcessingConfig field name pass
    # straight through; everything renamed or derived is listed explicitly
    shared_kwargs = {
        name: getattr(args, name)
        for name in (
            "bandwidth",
            "center_freq",
            "deemph_us",
            "agc_enabled",
            "chunk_size",
            "filter_block",
            "auto_filter_block",
            "iq_order",
            "probe_only",
            "fft_workers",
            "input_sample_rate",
            "profile_dir",
            "checkpoint_secs",
            "resume",
            "device",
        )
    }
    shared_kwargs |= {
        "center_freq_source": "cli" if args.center_freq is not None else None,
        "demod_mode": args.demod,
        "fs_ch_target": args.fs_ch,
        "mix_sign_override": args.mix_sign,
        "input_format": input_fmt[0],
        "input_container": input_fmt[1],
        "input_format_source": input_fmt[2],
    }
    base_kwargs = {
        **shared_kwargs,
        "target_freq": frequencies[0] if frequencies else 0.0,
        "output_path": args.output_path,
        "dump_iq_path": args.dump_iq,
        "plot_stages_path": args.plot_stages,
    }

    if args.benchmark:
        try:
            results: dict = {}
            rc = run_benchmark(
                seconds=args.benchmark_seconds,
                sample_rate=args.benchmark_sample_rate,
                freq_offset=args.benchmark_offset,
                center_freq=args.center_freq,
                target_freq=frequencies[0] if frequencies else None,
                base_kwargs=base_kwargs,
                channels=args.benchmark_channels,
                results_out=results,
            )
        except Exception as exc:
            return _die("Benchmark failed", exc, args.verbose)
        print(
            f"Benchmark: {results['iq_samples']:.0f} IQ samples in "
            f"{results['elapsed']:.2f} s ({results['realtime_factor']:.2f} x realtime, "
            f"{results['msps']:.2f} Msps); audio peak {results['audio_peak_dbfs']:.2f} dBFS"
        )
        return rc

    progress_sink = None
    configs: list[ProcessingConfig] = []
    launch_gui = args.interactive or not args.cli

    if launch_gui:
        try:
            from .interactive.app import launch_interactive_session
        except ImportError as exc:
            if args.interactive:
                LOG.error("Interactive mode unavailable: %s", exc)
                return 1
            LOG.info("Interactive GUI unavailable (%s); falling back to CLI mode.", exc)
            launch_gui = False
        else:
            try:
                session = launch_interactive_session(
                    input_path=args.input_path,
                    base_kwargs={**base_kwargs, "target_freqs": list(frequencies)},
                    snapshot_seconds=args.interactive_seconds,
                )
            except KeyboardInterrupt:
                LOG.info("Interactive session cancelled.")
                return 0
            except Exception as exc:
                return _die("Interactive session failed", exc, args.verbose)
            configs = list(session.configs)
            progress_sink = session.progress_sink
            if session.burst_segments and not args.burst_segments:
                # the GUI's Channel-panel burst setting applies unless the
                # command line already pinned one
                args.burst_segments = session.burst_segments

    if launch_gui:
        if args.preview_seconds is not None:
            LOG.warning(
                "--preview is ignored in interactive mode; use the GUI preview button instead."
            )
    else:
        if args.input_path is None:
            parser.error("--in is required in CLI mode.")
        if not frequencies and not args.probe_only and not args.spectrum_png:
            parser.error("Provide at least one --ft target frequency in CLI mode.")
        if args.spectrum_png:
            try:
                _render_capture_spectrum(args, input_fmt)
            except Exception as exc:
                return _die("Spectrum rendering failed", exc, args.verbose)
            if not frequencies and not args.probe_only:
                return 0  # spectrum-only invocation
        if args.preview_seconds is not None:
            return _run_cli_preview(args, frequencies, shared_kwargs)
        if len(input_paths) > 1:
            return _run_multi_capture(args, input_paths, frequencies, shared_kwargs)
        sp_rc = _maybe_run_seq_parallel(args, frequencies, shared_kwargs)
        if sp_rc is not None:
            return sp_rc
        configs = [_build_batched_config(args, frequencies, shared_kwargs)]

    if not configs:
        LOG.info("No target frequencies to process.")
        return 0
    return _run_configs(args, configs, progress_sink)


def _run_cli_preview(
    args: argparse.Namespace, frequencies: list[float], shared_kwargs: dict
) -> int:
    """``--preview SECONDS`` in CLI mode: render the first seconds and exit."""
    config = _build_batched_config(args, frequencies, shared_kwargs)
    LOG.info(
        "=== Previewing %d target(s): %s ===",
        max(1, len(frequencies)),
        "/".join(f"{f:.0f}" for f in frequencies) or "(center)",
    )
    try:
        _, preview_path = run_preview(
            config, args.preview_seconds, progress_sink=_make_sink()
        )
    except ProcessingCancelled:
        LOG.info("Preview cancelled by user.")
        return 0
    except Exception as exc:
        return _die("Preview failed", exc, args.verbose)
    LOG.info("Preview written to %s", preview_path)
    return 0


def _run_configs(args: argparse.Namespace, configs: list[ProcessingConfig], progress_sink) -> int:
    """Run each config through the serial pipeline (or one burst executor),
    then print the probe or the peak levels.  The first config reports to
    the GUI session's sink when something still observes it."""
    results: list[tuple[ProcessingConfig, ProcessingResult]] = []
    hetero_ex = _burst_executor(args)
    try:
        for index, config in enumerate(configs, start=1):
            freq_list = [f for f in config.all_target_freqs() if f > 0]
            LOG.info(
                "=== Processing %d target(s): %s (%d/%d) ===",
                max(1, len(freq_list)),
                "/".join(f"{f:.0f}" for f in freq_list) or "(probe)",
                index,
                len(configs),
            )
            use_session_sink = (
                index == 1
                and progress_sink is not None
                and getattr(progress_sink, "is_live", True)
            )
            sink = progress_sink if use_session_sink else _make_sink()
            try:
                if hetero_ex is not None:
                    result = hetero_ex.run(config, progress_sink=sink)
                else:
                    result = ProcessingPipeline(config).run(progress_sink=sink)
            except ProcessingCancelled:
                LOG.info("Processing cancelled by user.")
                return 0
            except Exception as exc:
                return _die("Processing failed", exc, args.verbose)
            results.append((config, result))
    finally:
        if hetero_ex is not None:
            hetero_ex.close()

    for config, result in results:
        if args.probe_only:
            info = result.sample_rate_probe
            tag = int(round(result.target_freq))
            print(
                f"[{tag}] Sample rate: {info.value:.2f} Hz "
                f"(header={info.header}, wave={info.wave}, override={info.override})"
            )
            print(
                f"[{tag}] Center frequency: {result.center_freq:.0f} Hz, "
                f"target: {result.target_freq:.0f} Hz, offset: {result.freq_offset:.0f} Hz"
            )
            print(
                f"[{tag}] Channel decimation: {result.decimation} "
                f"-> {result.fs_channel:.2f} Hz, mixer sign {result.mix_sign}"
            )
            continue
        freq_list = [f for f in config.all_target_freqs() if f > 0]
        mode = (config.demod_mode or "").lower()
        for freq, peak in zip(freq_list, result.audio_peaks or [result.audio_peak]):
            if peak > 0:
                peak_db = 20.0 * math.log10(peak)
                what = "IQ slice peak magnitude" if mode == "none" else "Audio peak level"
                print(f"[{int(round(freq))}] {what}: {peak_db:.2f} dBFS")
    return 0


def _make_sink():
    try:
        return TqdmProgressSink()
    except RuntimeError as exc:
        LOG.warning("Progress reporting disabled: %s", exc)
        return None


def _burst_executor(args: argparse.Namespace):
    """The burst-mode executor of ``--burst-segments`` above 1, else None."""
    if args.burst_segments <= 1:
        return None
    from .pipeline.hetero import HeteroExecutor

    return HeteroExecutor(
        cpu_workers=max(0, args.burst_cpu_workers),
        n_segments=args.burst_segments,
    )


def _plain_demod(args: argparse.Namespace) -> str | None:
    """The run's demodulator when it is one the sharded step runs
    (``ssb`` is the documented alias of ``usb``), else None."""
    demod = "usb" if args.demod == "ssb" else args.demod
    return demod if demod in {"nfm", "am", "usb", "lsb"} else None


def _shardable(args: argparse.Namespace, frequencies: list[float]) -> bool:
    """A plain demodulation the sharded runner can take: no probe, preview,
    dump, stage, checkpoint or burst mode (an explicit burst request wins
    over the mesh)."""
    return bool(
        frequencies
        and args.burst_segments <= 1
        and not args.probe_only
        and args.preview_seconds is None
        and args.dump_iq is None
        and args.plot_stages is None
        and not args.resume
        and not args.checkpoint_secs
        and _plain_demod(args) is not None
    )


def _run_dp(args: argparse.Namespace, jobs: list):
    """:func:`.parallel.dp_runner.run_captures_dp` with the run's options."""
    from .parallel.dp_runner import run_captures_dp

    return run_captures_dp(
        jobs,
        bandwidth=args.bandwidth,
        demod_mode=_plain_demod(args),
        fs_ch_target=args.fs_ch,
        deemph_us=args.deemph_us,
        agc_enabled=args.agc_enabled,
        iq_order=args.iq_order,
        mix_sign_override=args.mix_sign,
        device=args.device,
        progress_sink=_make_sink(),
    )


def _maybe_run_seq_parallel(
    args: argparse.Namespace,
    frequencies: list[float],
    shared_kwargs: dict,
) -> int | None:
    """Shard ONE capture over one rank per device (sequence parallelism):
    :func:`.parallel.dp_runner.run_captures_dp` with a single job is the
    pure seq-over-devices instance (dp = 1).  Engaged for plain demod runs
    when ``--seq-parallel`` is ``on``, or ``auto`` with more than one
    device.  Returns an exit code, or None to fall back to the serial
    pipeline."""
    if args.seq_parallel == "off":
        return None
    from .parallel.mesh import device_count

    n_dev = device_count(args.device)
    eligible = (
        _shardable(args, frequencies)
        and args.spectrum_png is None
        and args.profile_dir is None
    )
    if args.seq_parallel == "auto" and n_dev < 2:
        return None
    if not eligible:
        if args.seq_parallel == "on":
            LOG.error(
                "--seq-parallel on: this run cannot shard (sequence "
                "parallelism supports plain nfm/am/usb/lsb demodulation "
                "without probe/preview/dump/stage/checkpoint/burst modes)."
            )
            return 1
        return None

    from .parallel.dp_runner import CaptureJob

    # serial-parity output naming: the per-channel paths the serial
    # pipeline would write (shared --out hints get _<freq> suffixes when
    # batching; defaults are audio_<FT>_48k.wav beside the input)
    config = _build_batched_config(args, frequencies, shared_kwargs)
    paths = channel_paths(config, list(frequencies), args.output_path)
    for p in paths:
        p.parent.mkdir(parents=True, exist_ok=True)
    job = CaptureJob(
        in_path=args.input_path,
        target_freqs=list(frequencies),
        output_paths=paths,
        center_freq=args.center_freq,
        input_format=args.input_format,
        input_sample_rate=args.input_sample_rate,
    )
    LOG.info(
        "=== Processing %d target(s): %s (sequence-parallel over %d device(s)) ===",
        len(frequencies), "/".join(f"{f:.0f}" for f in frequencies), n_dev,
    )
    try:
        res = _run_dp(args, [job])
    except ProcessingCancelled:
        LOG.info("Processing cancelled by user.")
        return 0  # serial-path parity: cancel is a clean exit
    except ValueError as exc:
        if args.seq_parallel == "on":
            return _die("Sequence-parallel run failed", exc, args.verbose)
        LOG.info("Sequence-parallel execution unavailable (%s); running the serial pipeline.", exc)
        return None
    except Exception as exc:
        return _die("Processing failed", exc, args.verbose)
    for freq, peak in zip(frequencies, res.audio_peaks[0]):
        if peak > 0:
            print(f"[{int(round(freq))}] Audio peak level: {20.0 * math.log10(peak):.2f} dBFS")
    return 0


def _run_multi_capture(
    args: argparse.Namespace,
    paths: list[Path],
    frequencies: list[float],
    shared_kwargs: dict,
) -> int:
    """Several ``--in`` captures.

    When the device count is a multiple of the capture count and the run is
    a plain demodulation (no probe/preview/dump/stage/checkpoint/burst
    modes), the captures batch through ONE sharded step, one per ``dp``
    row (:mod:`.parallel.dp_runner`).  Anything else, or a geometry the
    mesh refuses, runs them one after the other (:func:`_run_captures_in_turn`).
    Outputs carry a per-capture tag: the input's stem, made unique when two
    captures share a filename (``day1/cap.wav`` and ``day2/cap.wav`` must not
    write to the same output)."""
    from .parallel.mesh import device_count

    tags: list[str] = []
    for i, p in enumerate(paths):
        tag = p.stem
        if sum(1 for q in paths if q.stem == tag) > 1:
            tag = f"{tag}{i + 1}"
        tags.append(tag)
    n_dev = device_count(args.device)
    if _shardable(args, frequencies) and n_dev >= len(paths) and n_dev % len(paths) == 0:
        from .parallel.dp_runner import CaptureJob

        jobs = [
            CaptureJob(
                in_path=p,
                target_freqs=list(frequencies),
                output_paths=[] if args.output_path is None else [_per_capture(args.output_path, tag)],
                center_freq=args.center_freq,
                input_format=args.input_format,
                input_sample_rate=args.input_sample_rate,
            )
            for p, tag in zip(paths, tags)
        ]
        try:
            res = _run_dp(args, jobs)
        except ProcessingCancelled:
            LOG.info("Processing cancelled by user.")
            return 0
        except ValueError as exc:
            LOG.info(
                "Data-parallel multi-capture unavailable (%s); processing captures "
                "sequentially.", exc
            )
        except Exception as exc:
            return _die("Processing failed", exc, args.verbose)
        else:
            for g, peaks in enumerate(res.audio_peaks):
                for k, peak in enumerate(peaks):
                    LOG.info(
                        "[%s @ %.0f] audio peak %.2f dBFS", paths[g].name, frequencies[k],
                        20.0 * math.log10(max(peak, 1e-9)),
                    )
            return 0
    return _run_captures_in_turn(args, paths, tags, frequencies, shared_kwargs)


def _per_capture(base: Path | None, tag: str) -> Path | None:
    """A shared artifact hint with a per-capture suffix: every capture would
    otherwise overwrite the previous one's file."""
    if base is None:
        return None
    return base.with_name(f"{base.stem}_{tag}{base.suffix}")


def _run_captures_in_turn(
    args: argparse.Namespace,
    paths: list[Path],
    tags: list[str],
    frequencies: list[float],
    shared_kwargs: dict,
) -> int:
    """One run per capture, one after the other: through the serial
    pipeline, or with ``--burst-segments`` through one burst executor.  The
    shared ``--out``, ``--dump-iq`` and ``--plot-stages`` hints get the
    capture's tag.  A failed capture is reported and the loop goes on; the
    exit status is then 1."""
    rc = 0
    out_base, dump_base, plot_base = args.output_path, args.dump_iq, args.plot_stages
    hetero_ex = _burst_executor(args)
    try:
        for p, tag in zip(paths, tags):
            args.input_path = p
            args.output_path = _per_capture(out_base, tag)
            args.dump_iq = _per_capture(dump_base, tag)
            args.plot_stages = _per_capture(plot_base, tag)
            config = _build_batched_config(args, frequencies, shared_kwargs)
            LOG.info("=== Processing capture %s ===", p)
            try:
                if hetero_ex is not None:
                    hetero_ex.run(config, progress_sink=_make_sink())
                else:
                    ProcessingPipeline(config).run(progress_sink=_make_sink())
            except ProcessingCancelled:
                LOG.info("Processing cancelled by user.")
                return 0
            except Exception as exc:
                rc = _die(f"Processing failed for {p}", exc, args.verbose)
    finally:
        if hetero_ex is not None:
            hetero_ex.close()
    return rc


def _build_batched_config(
    args: argparse.Namespace, frequencies: list[float], shared_kwargs: dict
) -> ProcessingConfig:
    """One config with all targets riding the batched channel axis."""
    return ProcessingConfig(
        in_path=args.input_path,
        target_freq=frequencies[0] if frequencies else 0.0,
        extra_target_freqs=list(frequencies[1:]),
        output_path=args.output_path,
        dump_iq_path=args.dump_iq,
        plot_stages_path=args.plot_stages,
        **shared_kwargs,
    )


if __name__ == "__main__":
    sys.exit(main())
