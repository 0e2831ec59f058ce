"""Device DSP ops in torch, and the hand-written CUDA channelizer kernel.

Each op has a float64 reference twin in :mod:`iq_to_audio_torch.ref` and a
JAX counterpart in the reference package that the tests hold it against.
"""
