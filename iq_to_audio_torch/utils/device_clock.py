"""Resident-rate timing on the device's clock.

A loop of eager calls between two CUDA events times the host's launches as
much as the device: one channelizer call of ~0.06 ms of kernel time took
0.3-0.6 ms that way.  The JAX package times one compiled ``fori_loop``
instead.  The port's counterpart is a CUDA graph: ``calls`` calls of the
work are captured once on a side stream and the graph is replayed between
two events, so the window holds the device's work and the graph's own
launch gaps, and no Python.

Capture needs work that neither synchronises with the host nor copies from
pageable host memory.  The body is run twice on the capture stream first:
that fills the caches keyed on the stream (the hand kernel's split taps,
``ops/poly_fir.py::_packed_taps``), the scan constants and the allocator,
so the graph holds only the work of the calls.  Where capture fails the
rate comes from the profiler's device-busy time of the same calls run
eagerly (``"method": "profiler_busy"``); on the CPU from the host clock
(``"method": "host_clock"``).
"""

from __future__ import annotations

import logging
import time
from collections.abc import Callable

import torch

LOG = logging.getLogger(__name__)


class CaptureFailed(RuntimeError):
    """The work ran eagerly but could not be captured in a CUDA graph."""


def capture_graph(body: Callable[[int], object], calls: int, device: torch.device):
    """``body(0) .. body(calls - 1)`` captured in one CUDA graph on a side
    stream of ``device``; returns ``(graph, stream)``.  A failure of the
    eager warm-up calls (a kernel that does not load or launch) is raised
    as it is; one of the capture as :class:`CaptureFailed`."""
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    graph = torch.cuda.CUDAGraph()
    # capture_begin/capture_end, not ``torch.cuda.graph``: that context also
    # synchronises the device and runs the garbage collector, which costs
    # the burst executor's first device claim a large part of a short run
    with torch.cuda.stream(stream):
        for i in range(2):
            body(i)
        try:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                for i in range(calls):
                    body(i)
            finally:
                graph.capture_end()
        except RuntimeError as exc:
            raise CaptureFailed(str(exc)) from exc
    return graph, stream


def replay_seconds(graph, stream, replays: int) -> float:
    """Device seconds of ``replays`` back-to-back replays, between two
    events on the capture stream, after one untimed replay."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        graph.replay()
        start.record()
        for _ in range(replays):
            graph.replay()
        stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3


def device_busy(run: Callable[[], object], device: torch.device, name: str = ""):
    """Device-busy seconds of one ``run()`` under ``torch.profiler`` (the
    sum of every kernel's, copy's and fill's own device time), and the
    count of device events whose name holds ``name``.  ``(None, 0)`` where
    the profiler reports no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(device)
    busy_us = 0.0
    hits = 0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # an operator's row repeats its kernels
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        busy_us += us
        if name and name in ev.key:
            hits += ev.count
    if busy_us <= 0.0:
        return None, 0
    return busy_us / 1e6, hits


def resident_rate(
    body: Callable[[int], object],
    samples_per_call: int,
    device: torch.device,
    *,
    calls: int,
    seconds_target: float,
    kernel_name: str = "",
    busy: bool = False,
) -> dict:
    """Input Msps of ``body`` on resident data.

    On a CUDA device: ``calls`` calls captured in one graph, replayed for
    about ``seconds_target`` of device time (``"method": "cuda_graph"``);
    with ``busy``, also the rate the profiler's device-busy time of one
    replay implies (``busy_msps``) and the device events of that replay
    whose name holds ``kernel_name`` (``kernel_events``); a replay in which
    the profiler sees no device time, or no such event, raises.  Where
    capture fails, the profiler's busy time of ``calls`` eager calls
    (``"profiler_busy"``).
    On the CPU, the host clock around ``calls`` eager calls, after one
    (``"host_clock"``).
    """
    out = {"calls": calls, "device": str(device)}
    samples = calls * samples_per_call

    def eager() -> None:
        for i in range(calls):
            body(i)

    if device.type != "cuda":
        body(0)
        t0 = time.perf_counter()
        eager()
        elapsed = time.perf_counter() - t0
        return {**out, "method": "host_clock", "replays": 1, "elapsed_s": elapsed,
                "msps": samples / max(elapsed, 1e-9) / 1e6}
    try:
        graph, stream = capture_graph(body, calls, device)
    except CaptureFailed as exc:
        LOG.warning("resident rate: the work cannot be captured in a CUDA graph (%s); "
                    "reporting the profiler's device-busy time", exc)
        torch.cuda.synchronize(device)
        busy_s, _ = device_busy(eager, device)
        if busy_s is None:
            raise RuntimeError("resident rate: no graph and no device time from the profiler")
        return {**out, "method": "profiler_busy", "replays": 1, "elapsed_s": busy_s,
                "msps": samples / busy_s / 1e6}
    rough = replay_seconds(graph, stream, 1)
    replays = int(min(max(seconds_target / max(rough, 1e-6), 1), 4096))
    elapsed = replay_seconds(graph, stream, replays)
    out.update(method="cuda_graph", replays=replays, elapsed_s=elapsed,
               msps=replays * samples / max(elapsed, 1e-9) / 1e6)
    if busy:
        def replay() -> None:
            with torch.cuda.stream(stream):
                graph.replay()

        busy_s, hits = device_busy(replay, device, kernel_name)
        if busy_s is None or (kernel_name and hits == 0):
            raise RuntimeError(
                f"resident rate: the profiler saw {busy_s} s of device time and "
                f"{hits} '{kernel_name}' events in a graph replay"
            )
        out.update(kernel_events=hits, busy_msps=samples / busy_s / 1e6)
    return out
