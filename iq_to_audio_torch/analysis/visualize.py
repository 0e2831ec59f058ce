"""Stage PSD plotting (reference ``visualize.py:32-97``).

Headless matplotlib (Agg) multi-panel PNG of pipeline stage snapshots:
input/mixed/filtered/decimated plus the decoder intermediates.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from .spectrum import compute_psd

LOG = logging.getLogger(__name__)

_STAGE_ORDER = [
    "input",
    "mixed",
    "filtered",
    "decimated",
    "demod",
    "deemph",
    "envelope",
    "analytic",
    "dc_block",
    "agc",
    "audio",
]


def plot_psd(
    ax, samples: np.ndarray, sample_rate: float, title: str, center_freq: float = 0.0,
    *, device=None,
):
    """PSD panel of one stage; the FFT runs on ``device`` (``None``: the
    card)."""
    samples = np.asarray(samples)
    nfft = min(1 << 16, max(256, 1 << int(np.floor(np.log2(max(samples.size, 256))))))
    if np.iscomplexobj(samples):
        freqs, psd_db = compute_psd(samples, sample_rate, nfft=nfft, device=device)
    else:
        # real signal: use analytic-style PSD of the real samples
        freqs, psd_db = compute_psd(
            samples.astype(np.complex64), sample_rate, nfft=nfft, device=device
        )
    ax.plot(freqs / 1e3, psd_db, linewidth=0.7)
    ax.set_title(title, fontsize=9)
    ax.set_xlabel("Frequency (kHz)", fontsize=8)
    ax.set_ylabel("dBFS/Hz", fontsize=8)
    ax.grid(True, alpha=0.3)
    if center_freq:
        sec = ax.secondary_xaxis(
            "top",
            functions=(
                lambda f: (f * 1e3 + center_freq) / 1e6,
                lambda f: (f * 1e6 - center_freq) / 1e3,
            ),
        )
        sec.set_xlabel("Absolute (MHz)", fontsize=7)


def save_stage_psd(
    snapshots: dict[str, tuple[np.ndarray, float]],
    output_path: Path | str,
    center_freq: float | None = None,
    *,
    device=None,
) -> None:
    """Save a multi-panel PNG of per-stage PSDs, computed on ``device``
    (``None``: the card; without one only ``"cpu"`` runs)."""
    from ..utils.device import resolve_device

    device = resolve_device(device)  # before the per-panel best effort below
    # direct Agg canvas, no pyplot: switching the PROCESS-wide backend
    # would silently break a later interactive matplotlib figure (the
    # SpanSelector picker) in the same process
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    stages = [s for s in _STAGE_ORDER if s in snapshots]
    stages += [s for s in snapshots if s not in stages]
    if not stages:
        raise ValueError("No stage snapshots to plot.")
    cols = 2
    rows = (len(stages) + cols - 1) // cols
    fig = Figure(figsize=(11, 3.0 * rows))
    FigureCanvasAgg(fig)
    axes = fig.subplots(rows, cols, squeeze=False)
    for i, name in enumerate(stages):
        buf, rate = snapshots[name]
        ax = axes[i // cols][i % cols]
        try:
            plot_psd(
                ax,
                np.asarray(buf).reshape(-1),
                rate,
                f"{name} ({rate / 1e3:.1f} kS/s)",
                center_freq or 0.0,
                device=device,
            )
        except Exception as exc:  # pragma: no cover - defensive per-panel
            LOG.debug("Stage plot failed for %s: %s", name, exc)
            ax.set_visible(False)
    for i in range(len(stages), rows * cols):
        axes[i // cols][i % cols].set_visible(False)
    fig.tight_layout()
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=110)


def save_capture_spectrum(
    input_path: Path | str,
    output_path: Path | str,
    *,
    spec,
    sample_rate: float,
    seconds: float = 4.0,
    center_freq: float | None = None,
    iq_order: str = "iq",
    nfft: int = 8192,
    max_slices: int = 400,
    colormap: str = "viridis",
    device=None,
) -> Path:
    """Headless capture PSD + waterfall PNG — the CLI analogue of the GUI
    snapshot page (the reference renders waterfalls only inside its Qt GUI:
    reference ``interactive/workers.py:36-161`` + the app canvas).

    Streams the first ``seconds`` of the capture through the bounded-memory
    waterfall accumulator and renders a two-panel figure: averaged PSD (with
    an absolute-frequency top axis when ``center_freq`` is known) above the
    time/frequency waterfall.  The FFTs run on ``device`` (``None``: the
    card; without one only ``"cpu"`` runs).
    """
    import math as _math

    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    from ..io.reader import IQReader
    from .spectrum import streaming_waterfall

    input_path = Path(input_path)
    total = max(1, int(seconds * sample_rate))
    # clamp to what the capture can actually supply (file size over frame
    # bytes slightly overestimates for WAV headers — harmless, reads stop
    # at EOF and the clamp only sizes the FFT)
    try:
        avail = int(input_path.stat().st_size // max(spec.bytes_per_frame, 1))
    except OSError:
        avail = total
    total = max(1, min(total, avail))
    # never ask for an FFT longer than the streamed span
    nfft = max(1024, min(nfft, 1 << int(_math.floor(_math.log2(total)))))
    chunk = max(nfft, 1 << 18)

    def _chunks():
        consumed = 0
        with IQReader(
            input_path,
            chunk,
            iq_order,
            spec,
            sample_rate=sample_rate if spec.container == "raw" else None,
        ) as reader:
            for block in reader:
                remaining = total - consumed
                if remaining <= 0:
                    return
                if block.size > remaining:
                    block = block[:remaining]
                consumed += block.size
                yield block

    freqs, avg_psd, waterfall, frames = streaming_waterfall(
        _chunks(), sample_rate, nfft=nfft, max_slices=max_slices, device=device
    )
    LOG.info(
        "Capture spectrum: %d FFT frames (%d-point), %d waterfall slices.",
        frames,
        nfft,
        waterfall.matrix.shape[0],
    )
    span = (
        float(waterfall.times[-1]) + nfft / sample_rate
        if waterfall.times.size
        else seconds
    )

    fig = Figure(figsize=(11, 7))
    FigureCanvasAgg(fig)
    ax_psd, ax_wf = fig.subplots(
        2, 1, sharex=True, height_ratios=[1, 2], squeeze=True
    )
    ax_psd.plot(freqs / 1e3, avg_psd, lw=0.6)
    ax_psd.set_ylabel("dBFS/Hz", fontsize=9)
    ax_psd.set_title(
        f"{input_path.name} — averaged PSD ({span:.2f} s)", fontsize=10
    )
    ax_psd.grid(True, alpha=0.3)
    if center_freq:
        sec = ax_psd.secondary_xaxis(
            "top",
            functions=(
                lambda f: (f * 1e3 + center_freq) / 1e6,
                lambda f: (f * 1e6 - center_freq) / 1e3,
            ),
        )
        sec.set_xlabel("Absolute (MHz)", fontsize=8)
    times = waterfall.times
    # anchor the color floor near the noise floor (20th percentile, the
    # squelch module's noise-floor convention) so signals stand out
    vmin = float(np.percentile(waterfall.matrix, 20.0))
    vmax = float(waterfall.matrix.max())
    ax_wf.imshow(
        waterfall.matrix,
        aspect="auto",
        origin="upper",
        cmap=colormap,
        vmin=vmin,
        vmax=vmax,
        extent=(
            float(freqs[0]) / 1e3,
            float(freqs[-1]) / 1e3,
            float(times[-1]) if times.size else span,
            float(times[0]) if times.size else 0.0,
        ),
    )
    ax_wf.set_xlabel("Frequency (kHz)", fontsize=9)
    ax_wf.set_ylabel("Time (s)", fontsize=9)
    fig.tight_layout()
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output_path, dpi=110)
    return output_path


def interactive_select_frequency(
    samples: np.ndarray,
    sample_rate: float,
    center_freq: float = 0.0,
    *,
    nfft: int = 1 << 16,
    device=None,
) -> tuple[float | None, float | None]:
    """Minimal matplotlib SpanSelector frequency/bandwidth picker.

    Legacy fallback (reference ``visualize.py:106-191``) superseded by the Qt
    GUI; kept for environments with matplotlib but no PySide6.  Returns
    ``(target_freq, bandwidth)`` or ``(None, None)`` if the window is closed
    without a selection.
    """
    import matplotlib.pyplot as plt
    from matplotlib.widgets import SpanSelector

    freqs, psd_db = compute_psd(np.asarray(samples), sample_rate, nfft=nfft, device=device)
    fig, ax = plt.subplots(figsize=(11, 5))
    ax.plot(freqs + center_freq, psd_db, lw=0.6)
    ax.set_xlabel("Frequency (Hz)")
    ax.set_ylabel("dBFS/Hz")
    ax.set_title("Drag to select a channel (close the window to confirm)")
    selection: dict[str, float] = {}

    def _on_select(xmin: float, xmax: float):
        if xmax > xmin:
            selection["target"] = 0.5 * (xmin + xmax)
            selection["bandwidth"] = xmax - xmin
            ax.set_title(
                f"Selected {selection['target'] / 1e6:.6f} MHz, "
                f"bw {selection['bandwidth'] / 1e3:.2f} kHz — close to confirm"
            )
            fig.canvas.draw_idle()

    _selector = SpanSelector(
        ax, _on_select, "horizontal", useblit=True, props={"alpha": 0.3}
    )
    plt.show()
    del _selector
    return selection.get("target"), selection.get("bandwidth")
