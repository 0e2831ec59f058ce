"""A preview: ``run_preview(config, seconds)`` over the head of the capture,
as the GUI's ``PreviewWorker`` calls it."""


def run(config, traffic):
    from iq_to_audio_torch.pipeline.preview import run_preview

    result, _ = run_preview(config, float(traffic["preview_seconds"]))
    return result
