"""SSB (USB/LSB) demodulator with DC blocking and feedback AGC (port of the
JAX package's ``demod/ssb.py``).

Reference semantics: ``decoders/ssb.py``.  The channel filter has already
band-limited the complex baseband, so USB audio is ``real(x)`` and LSB is
``real(conj(x))``, which is the same real part; then the one-pole DC blocker
and, optionally, the feedback AGC, whose gain is carried across chunks
(chunked == whole).  The whole chain is the span ``iq2a.ssb``
(:mod:`iq_to_audio_torch.utils.spans`): the host's enqueue of its kernels.

The DC blocker and the AGC run in float64 (the carried state stays
float32), where the JAX package runs them in float32.  The AGC's update
``target / |x|`` turns a rounding of ``x`` near the audio's zero crossings
into a gain step that lasts some thousand samples, so float32 rounding made
whole s16 steps of difference, and made the audio depend on where chunks
start: a segmented run against a serial one read -52 to -77 dB over seven
tone offsets in float32, -108 to -127 dB in float64 (CPU, 250 kHz captures).
"""

from __future__ import annotations

import torch

from ..ops.iir import dc_blocker, feedback_agc
from ..utils import spans
from .base import Decoder

#: reference AGC and DC-blocker defaults (``decoders/ssb.py:67-80``)
AGC_TARGET_DBFS = -12.0
AGC_DECAY = 0.001
DC_RADIUS = 0.995


class SSBDecoder(Decoder):
    name = "ssb"

    def __init__(
        self,
        sideband: str,
        agc_enabled: bool,
        dc_radius: float = DC_RADIUS,
        agc_target_dbfs: float = AGC_TARGET_DBFS,
        agc_decay: float = AGC_DECAY,
    ):
        sideband = sideband.lower()
        if sideband not in {"usb", "lsb"}:
            raise ValueError("sideband must be 'usb' or 'lsb'")
        self.sideband = sideband
        self.agc_enabled = agc_enabled
        self.dc_radius = dc_radius
        self.agc_target = 10.0 ** (agc_target_dbfs / 20.0)
        self.agc_decay = agc_decay

    def setup(self, sample_rate: float) -> None:
        return

    def init_state(self, batch_shape, device):
        state = {
            "dc_x": torch.zeros(batch_shape, dtype=torch.float32, device=device),
            "dc_y": torch.zeros(batch_shape, dtype=torch.float32, device=device),
        }
        if self.agc_enabled:
            state["agc_gain"] = torch.ones(batch_shape, dtype=torch.float32, device=device)
        return state

    def process(self, state, yr, yi):
        with spans.span("iq2a.ssb"):
            # real(conj(x)) == real(x): both sidebands take the real part
            baseband = yr.double()
            dc_audio, (x_last, y_last) = dc_blocker(
                baseband, self.dc_radius, state["dc_x"], state["dc_y"]
            )
            new_state = {"dc_x": x_last.float(), "dc_y": y_last.float()}
            inter = {"analytic": baseband, "dc_block": dc_audio}
            if self.agc_enabled:
                audio, gain_last = feedback_agc(
                    dc_audio, self.agc_target, self.agc_decay, state["agc_gain"]
                )
                new_state["agc_gain"] = gain_last.float()
                inter["agc"] = audio
            else:
                audio = dc_audio
            audio = audio.float()
            inter["audio"] = audio
        return audio, new_state, inter
