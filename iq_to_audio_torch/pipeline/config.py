"""Run configuration — the single source of truth for one processing run.

Field-for-field copy of the JAX package's ``ProcessingConfig`` (itself a
capability match with the reference ``processing.py:38-62``), so a config
built for one package builds for the other.  Two fields differ in meaning:

* ``device`` names the torch device.  ``None`` means ``"cuda"``: the
  pipeline runs on the card unless the caller asks for the CPU (the tests
  pass ``device="cpu"``), and it raises when no card is present.
* ``profile_dir`` receives a ``torch.profiler`` Chrome trace of the chunk
  loop (``chunk_loop.trace.json``).

``filter_block``/``auto_filter_block`` act on the ``fft`` channelizer
(``IQ2A_CHANNELIZER=fft``, or the CPU's default when the native library is
missing): with ``auto_filter_block`` (the default) the overlap-save planner
picks the FFT size; without it ``filter_block`` is the FFT size, rounded up
to a power of two that holds the filter.  The FIR channelizers have no such
size.  ``fft_workers`` is accepted and ignored (torch owns FFT threading).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class ProcessingConfig:
    in_path: Path
    target_freq: float = 0.0
    bandwidth: float = 12_500.0
    center_freq: float | None = None
    center_freq_source: str | None = None
    demod_mode: str = "nfm"
    fs_ch_target: float = 96_000.0
    deemph_us: float = 300.0
    agc_enabled: bool = True
    output_path: Path | None = None
    dump_iq_path: Path | None = None
    chunk_size: int = 1_048_576  # requested complex samples per chunk
    filter_block: int = 65_536  # FFT size of the fft channelizer (see above)
    iq_order: str = "iq"
    probe_only: bool = False
    mix_sign_override: int | None = None
    plot_stages_path: Path | None = None
    fft_workers: int | None = None  # accepted, ignored (torch owns threading)
    max_input_seconds: float | None = None
    input_container: str | None = None
    input_format: str | None = None
    input_format_source: str | None = None
    input_sample_rate: float | None = None

    # --- framework extensions (same names as the JAX package) ---------------
    #: additional target frequencies batched through the same channelizer
    #: pass (leading channel axis).  ``target_freq`` is channel 0.
    extra_target_freqs: list[float] = field(default_factory=list)
    #: per-extra-channel output paths (parallel to extra_target_freqs)
    extra_output_paths: list[Path | None] = field(default_factory=list)
    #: let the overlap-save planner pick the FFT size instead of taking
    #: ``filter_block`` verbatim
    auto_filter_block: bool = True
    #: torch device for the chunk step; None = "cuda" (no silent CPU
    #: fallback: a run without a card raises unless "cpu" is asked for)
    device: str | None = None
    #: directory for a torch.profiler Chrome trace of the chunk loop
    profile_dir: Path | None = None
    #: checkpoint cadence in seconds of input; the checkpoint is written
    #: next to output 0 as ``<output>.ckpt``
    checkpoint_secs: float | None = None
    #: resume from that checkpoint when it exists
    resume: bool = False
    #: process only the input window starting at this absolute complex-sample
    #: index; the NCO is phase-seeded from the absolute index.
    input_start_sample: int | None = None
    #: process at most this many complex samples from ``input_start_sample``
    input_num_samples: int | None = None
    #: size the accumulator/dispatch groups as for an unbounded capture
    fixed_device_geometry: bool = False

    def all_target_freqs(self) -> list[float]:
        return [self.target_freq, *self.extra_target_freqs]
