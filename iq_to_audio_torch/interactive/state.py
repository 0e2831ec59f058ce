"""UI session state (reference ``interactive/state.py``).

Pure-Python (no Qt imports): owns the knobs the GUI edits and converts them
back into ProcessingConfig kwargs.  Unit-testable without a display.  Port
of the JAX package's ``interactive/state.py``; the configs it builds carry
the session's ``device``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path

from ..pipeline.capture import MAX_TARGETS, is_pass_through

# Plot themes: the reference's five palettes (reference
# interactive/state.py:11-52 — default/contrast/night/paper/aurora, same
# color values and grid linestyles) plus two first-party extras.
SPECTRUM_THEMES: dict[str, dict[str, str]] = {
    "Default": {"bg": "white", "fg": "black", "line": "#1f77b4",
                "grid": "#d0d0d0", "grid_style": ":"},
    "Contrast": {"bg": "#101010", "fg": "white", "line": "#ff7600",
                 "grid": "#444444", "grid_style": "--"},
    "Night": {"bg": "#0b1a2a", "fg": "#f0f4ff", "line": "#7fffd4",
              "grid": "#223347", "grid_style": ":"},
    "Paper": {"bg": "#f6f1e1", "fg": "#2f2a1d", "line": "#b15d1c",
              "grid": "#d7c9a0", "grid_style": ":"},
    "Aurora": {"bg": "#061622", "fg": "#c3f1ff", "line": "#6cf584",
               "grid": "#1b3646", "grid_style": "--"},
    "Amber": {"bg": "#16130b", "fg": "#ffd37a", "line": "#ffb52e",
              "grid": "#3a3422", "grid_style": ":"},
    "Ice": {"bg": "#0c1420", "fg": "#d2e4f5", "line": "#6fd3ff",
            "grid": "#1e3148", "grid_style": ":"},
}

WATERFALL_COLORMAPS = ["viridis", "magma", "inferno", "plasma", "turbo"]


@dataclass
class InteractiveState:
    """Mutable session state mirrored into the widgets."""

    base_kwargs: dict = field(default_factory=dict)
    input_path: Path | None = None
    center_freq: float | None = None
    center_freq_source: str = "unavailable"
    sample_rate: float | None = None
    sample_rate_override: float | None = None
    input_format_override: str | None = None
    snapshot_seconds: float = 2.0
    output_dir: Path | None = None

    targets: list[float] = field(default_factory=list)
    bandwidth: float = 12_500.0
    demod_mode: str = "nfm"
    agc_enabled: bool = True
    _agc_preferred: bool = True
    #: burst mode for the confirmed run: split the capture into this many
    #: concurrently-processed segments (0 = serial; pipeline/hetero.py)
    burst_segments: int = 0

    # spectrum display knobs
    spectrum_nfft: int = 262_144
    spectrum_smoothing: int = 3
    spectrum_dynamic_range: float = 90.0
    spectrum_theme: str = "Night"

    # waterfall knobs
    waterfall_slices: int = 400
    waterfall_floor_db: float = -110.0
    waterfall_colormap: str = "viridis"

    # --- targets ------------------------------------------------------------

    def add_target(self, freq: float) -> bool:
        """Add a target (dedup at 0.5 Hz, max 5; reference state.py:208-221)."""
        if freq <= 0:
            return False
        for existing in self.targets:
            if math.isclose(freq, existing, rel_tol=0.0, abs_tol=0.5):
                return False
        if len(self.targets) >= MAX_TARGETS:
            return False
        self.targets.append(freq)
        return True

    def remove_target(self, index: int) -> None:
        if 0 <= index < len(self.targets):
            self.targets.pop(index)

    def clear_targets(self) -> None:
        self.targets.clear()

    # --- demod/AGC coupling ---------------------------------------------------

    def set_demod(self, mode: str) -> None:
        """NFM/AM have no AGC; restore the user's preference when returning
        to an AGC-capable mode (reference state semantics)."""
        mode = mode.lower()
        if self.demod_mode in {"usb", "lsb", "ssb"}:
            self._agc_preferred = self.agc_enabled
        self.demod_mode = mode
        if mode in {"usb", "lsb", "ssb"}:
            self.agc_enabled = self._agc_preferred
        else:
            self.agc_enabled = not is_pass_through(mode) and self.agc_enabled

    @property
    def agc_applicable(self) -> bool:
        return self.demod_mode in {"usb", "lsb", "ssb"}

    @property
    def effective_sample_rate(self) -> float | None:
        return self.sample_rate_override or self.sample_rate

    # --- config assembly ------------------------------------------------------

    _PROCESSING_FIELDS = {
        "bandwidth",
        "center_freq",
        "center_freq_source",
        "demod_mode",
        "fs_ch_target",
        "deemph_us",
        "agc_enabled",
        "chunk_size",
        "filter_block",
        "auto_filter_block",
        "iq_order",
        "probe_only",
        "mix_sign_override",
        "fft_workers",
        "input_format",
        "input_container",
        "input_format_source",
        "input_sample_rate",
        "profile_dir",
        "checkpoint_secs",
        "resume",
        # the port's own field: the command line's --device reaches the
        # confirmed run and the preview (None means the card)
        "device",
    }

    def build_configs(self):
        """One batched ProcessingConfig covering all selected targets."""
        from ..pipeline.config import ProcessingConfig

        if self.input_path is None or not self.targets:
            return []
        kwargs = {
            k: v for k, v in self.base_kwargs.items() if k in self._PROCESSING_FIELDS
        }
        kwargs.update(
            bandwidth=self.bandwidth,
            center_freq=self.center_freq,
            center_freq_source=self.center_freq_source,
            demod_mode=self.demod_mode,
            agc_enabled=self.agc_enabled,
            input_sample_rate=self.sample_rate_override
            or kwargs.get("input_sample_rate"),
        )
        if self.input_format_override:
            from ..io.formats import parse_user_format

            container, codec = parse_user_format(self.input_format_override)
            kwargs.update(
                input_format=codec, input_container=container, input_format_source="gui"
            )
        output = None
        if self.output_dir is not None:
            output = self.output_dir / f"audio_{int(self.targets[0])}_48k.wav"
        config = ProcessingConfig(
            in_path=self.input_path,
            target_freq=self.targets[0],
            extra_target_freqs=list(self.targets[1:]),
            output_path=output,
            **kwargs,
        )
        return [config]
