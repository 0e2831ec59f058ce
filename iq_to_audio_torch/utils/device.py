"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(requested: str | torch.device | None) -> torch.device:
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
