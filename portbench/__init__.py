"""The benchmark of ``iq_to_audio_torch``: ``python3 portbench/run.py``."""
