"""Analysis/observability: PSD, streaming waterfall, stage plots."""

from .spectrum import WaterfallResult, compute_psd, streaming_waterfall

__all__ = ["WaterfallResult", "compute_psd", "streaming_waterfall"]
