"""One reader per metric, ``<name>.py`` with ``read(run) -> float | None``.

``run`` carries ``config``, ``traffic``, ``setup_s``, ``window_s``, the
window's completed ``jobs`` (``wall_s``, ``loop_s``, ``input_samples``,
``dispatched_chunks``, ``capture_s``, ``offsets``), ``trace`` (the traced
run's :class:`~portbench.harness.tracing.Trace`, else None), ``peaks``
(``peaks.json``) and ``device_kind``.
A reader that finds nothing to read returns None, and the metric is left
out of the line.
"""
