"""A confirmed conversion: ``ProcessingPipeline(config).run()``, as the
command line and the GUI's confirmed run call it."""


def run(config, traffic):
    from iq_to_audio_torch.pipeline.pipeline import ProcessingPipeline

    return ProcessingPipeline(config).run()
