"""Functional decoder interface (port of the JAX package's ``demod/base.py``).

* ``setup(sample_rate)``               — host-side constant precomputation
* ``init_state(batch_shape, device)``  — the carried state as a dict of tensors
* ``process(state, yr, yi)``           — consumes the decimated baseband as a
  float32 (re, im) pair and returns ``(audio, new_state, intermediates)``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass

import torch


@dataclass
class DecoderStats:
    """Runtime statistics from a decoder stage (reference ``decoders/base.py:9-13``)."""

    rms_dbfs: float


class Decoder(ABC):
    name: str = "decoder"

    @abstractmethod
    def setup(self, sample_rate: float) -> None:
        """Precompute host constants for the given channel sample rate."""

    @abstractmethod
    def init_state(
        self, batch_shape: tuple[int, ...], device: torch.device
    ) -> dict[str, torch.Tensor]:
        """Return the carried state for ``batch_shape`` channels."""

    @abstractmethod
    def process(self, state: dict[str, torch.Tensor], yr: torch.Tensor, yi: torch.Tensor):
        """``(audio, new_state, intermediates)``."""

    def finalize(self) -> None:
        """Flush pending state (no decoder currently buffers output)."""
        return
