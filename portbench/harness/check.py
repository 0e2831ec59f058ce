"""What decides ``correct``: the WAVs the timed jobs wrote, against the plain
reference run over the same capture.

Each compared WAV gives three numbers, and a run reports the worst of each
over its WAVs (the limits are the cell's ``limits/<cell>.json``):

* ``len_gap``: the difference in samples between the WAV and the reference
  (exact: limit 0);
* ``mean_gap_lsb``: the mean absolute difference between the WAV's s16
  codes and the reference's, in s16 steps;
* ``trim_gap_lsb``: the same mean without the WAV's ``TRIM`` largest
  differences.  The discriminator ``angle(z[n] conj(z[n-1]))`` is
  ill-conditioned where the phase step lies at +-pi: float32 and float64
  may land on opposite branches, a step of 2 pi that de-emphasis turns into
  one click of a few tens of samples (about 0.05 of ``mean_gap_lsb`` in a
  40 s WAV).  Without those few samples the number is steady from seed to
  seed; ``mean_gap_lsb`` keeps what is localised (one altered block, a
  glitch at each chunk boundary).
"""

from __future__ import annotations

import wave
from pathlib import Path

import numpy as np
import torch

from ..reference import chain, design

#: the reference's precision, and the control's
REFERENCE = "f64"
CONTROL = "tf32"
#: largest differences left out of ``trim_gap_lsb``: room for some eight
#: discriminator clicks
TRIM = 256
#: a difference above this many s16 steps is counted as a spike (stderr)
SPIKE_LSB = 64


def read_s16(path: Path) -> torch.Tensor:
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: not mono s16")
        return torch.from_numpy(np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float64))


class Reference:
    """Reference codes per (offset, sign, samples), computed once each on
    ``device`` from the capture file."""

    def __init__(self, capture: Path, container, config: dict, device, prec: str = REFERENCE):
        self.capture = capture
        self.container = container
        self.config = config
        self.device = device
        self.prec = prec
        self.fs = float(config["sample_rate"])
        self._iq: dict[int, torch.Tensor] = {}
        self._codes: dict = {}
        self._signs: dict = {}

    def iq(self, n: int) -> torch.Tensor:
        if n not in self._iq:
            self._iq.clear()
            self._iq[n] = self.container.read(self.capture, n, self.device)
        return self._iq[n]

    def sign(self, offset: float) -> int:
        """The mixer sign the upstream's warm-up probe picks for a job whose
        first target is ``offset`` (it applies to all of the job's targets)."""
        if offset not in self._signs:
            p = self.config["pipeline"]
            d, _ = design.decimation(self.fs, p["fs_ch_target"])
            taps = design.channel_taps(self.fs, p["bandwidth"], d)
            head = self.container.read(self.capture, 1 << 18, "cpu").numpy()
            self._signs[offset] = design.mix_sign(head, self.fs, offset, taps, d)
        return self._signs[offset]

    def codes(self, offset: float, sign: int, n: int) -> torch.Tensor:
        key = (offset, sign, n)
        if key not in self._codes:
            audio = chain.channel_audio(
                self.iq(n), self.fs, offset, sign, self.config["pipeline"], self.prec,
                float(self.config["output_rate"]),
            )
            self._codes[key] = chain.encode_s16(audio).cpu()
        return self._codes[key]


NUMBERS = ("len_gap", "mean_gap_lsb", "trim_gap_lsb")


def gaps(program: torch.Tensor, reference: torch.Tensor) -> dict:
    n = min(program.numel(), reference.numel())
    diff = (program[:n] - reference[:n]).abs()
    if n <= TRIM:
        return {"len_gap": abs(program.numel() - reference.numel()), "mean_gap_lsb": float("inf"),
                "trim_gap_lsb": float("inf"), "spikes": 0, "spike_at": -1}
    kept = torch.sort(diff).values[: n - TRIM]
    return {
        "len_gap": abs(program.numel() - reference.numel()),
        "mean_gap_lsb": float(diff.mean()),
        "trim_gap_lsb": float(kept.mean()),
        "spikes": int((diff > SPIKE_LSB).sum()),
        "spike_at": int(diff.argmax()) if float(diff.max()) > SPIKE_LSB else -1,
    }


def compare(jobs: list, ref: Reference, log=None, each: list | None = None) -> dict:
    """Worst numbers over every WAV of ``jobs`` (each with ``offsets``,
    ``input_samples`` and ``outputs``, one per offset); with ``log``, one
    line per WAV that holds a spike; with ``each``, every WAV's numbers
    appended to it."""
    worst = {k: 0 for k in NUMBERS} | {"wavs": 0, "spikes": 0}
    for job in jobs:
        sign = ref.sign(job.offsets[0])
        for off, path in zip(job.offsets, job.outputs):
            g = gaps(read_s16(path), ref.codes(off, sign, job.input_samples))
            if each is not None:
                each.append(g)
            for k in NUMBERS:
                worst[k] = max(worst[k], g[k])
            worst["wavs"] += 1
            worst["spikes"] += g["spikes"]
            if g["spikes"] and log is not None:
                print(
                    f"spikes: job {job.index} offset {off:+.0f} Hz: {g['spikes']} samples over "
                    f"{SPIKE_LSB} steps, the largest at sample {g['spike_at']}; mean "
                    f"{g['mean_gap_lsb']:.5f}, trimmed {g['trim_gap_lsb']:.5f}", file=log,
                )
    return worst


def verdict(worst: dict, limits: dict, failed: int = 0) -> tuple[bool, dict]:
    """``correct``, and the numbers compared, each with its limit: no job
    failed, at least one WAV compared, every number within its limit."""
    checks = {
        "failed_jobs": {"value": failed, "limit": 0},
        "wavs_compared": {"value": worst["wavs"], "limit": 1},
    }
    for name in NUMBERS:
        checks[name] = {"value": worst[name], "limit": limits[name]}
    correct = failed == 0 and worst["wavs"] >= 1 and all(worst[n] <= limits[n] for n in NUMBERS)
    return bool(correct), checks
