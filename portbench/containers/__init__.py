"""Capture files, one module per container: ``<name>.py`` with
``write(path, iq, sample_rate)`` and ``read(path, n, device) -> complex128 tensor``."""
