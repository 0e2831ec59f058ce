"""AM envelope detector with DC blocking (port of the JAX package's
``demod/am.py``; reference ``decoders/am.py``), in float32.  The chain is
the span ``iq2a.am`` (:mod:`iq_to_audio_torch.utils.spans`): the host's
enqueue of its kernels, once per chunk."""

from __future__ import annotations

import torch

from ..ops.iir import dc_blocker
from ..utils import spans
from .base import Decoder
from .ssb import DC_RADIUS


class AMDecoder(Decoder):
    name = "am"

    def __init__(self, dc_radius: float = DC_RADIUS):
        if not 0.0 < dc_radius < 1.0:
            raise ValueError("radius must be between 0 and 1")
        self.dc_radius = dc_radius

    def setup(self, sample_rate: float) -> None:
        return

    def init_state(self, batch_shape, device):
        return {
            "dc_x": torch.zeros(batch_shape, dtype=torch.float32, device=device),
            "dc_y": torch.zeros(batch_shape, dtype=torch.float32, device=device),
        }

    def process(self, state, yr, yi):
        with spans.span("iq2a.am"):
            envelope = torch.sqrt(yr * yr + yi * yi)
            audio, (x_last, y_last) = dc_blocker(
                envelope, self.dc_radius, state["dc_x"], state["dc_y"]
            )
            new_state = {"dc_x": x_last.clone(), "dc_y": y_last.clone()}
        inter = {"envelope": envelope, "dc_block": audio, "audio": audio}
        return audio, new_state, inter
