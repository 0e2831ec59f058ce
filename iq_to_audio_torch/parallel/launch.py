"""Start a world of ranks, one per device, and run one function on each.

:func:`run_world` runs ``fn(rank_ctx, *args)`` on ``world`` ranks of a
``torch.distributed`` group: NCCL on ``cuda`` (rank ``r`` on card ``r``),
gloo on ``cpu`` (one thread per rank).  The group meets through a
``file://`` store in a fresh temporary directory, so worlds started side by
side never share a port.  Every collective has ``timeout`` seconds.

A world of one runs in the calling process on a real one-rank group, so the
collectives' code runs there as well.  A larger world is spawned
(``torch.multiprocessing``, start method ``spawn``) with the semantics of
``mp.spawn(join=True)``: when any rank fails, the others are stopped and
:class:`RankFailed` is raised in the parent with every failed rank's traceback.

Ranks talk to the parent through their :class:`RankContext`:
``post(message)`` hands a message to the parent's ``on_message`` (rank 0's
progress), and ``cancelled()`` reads the parent's ``cancel()`` (polled by
the parent and passed to the spawned ranks through a shared event).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import queue
import tempfile
from collections.abc import Callable
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: seconds each collective may wait before the rank fails
DEFAULT_TIMEOUT = 300.0


class RankFailed(RuntimeError):
    """A rank of a spawned world raised or died; the message carries the
    traceback of every rank that raised."""


@dataclass
class RankContext:
    """What a rank knows of its world: its rank, the world size, its device
    and the two channels to the parent."""

    rank: int
    world: int
    device: torch.device
    post: Callable[[object], None]
    cancelled: Callable[[], bool]


def _init_group(rank: int, world: int, kind: str, store: Path, timeout: float,
                device: torch.device | None = None) -> torch.device:
    """Join the world as ``rank``; a CUDA rank runs on ``device`` (default:
    card ``rank``), which becomes the current device."""
    if kind == "cuda":
        device = device or torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        "nccl" if kind == "cuda" else "gloo",
        init_method=store.as_uri(),
        rank=rank,
        world_size=world,
        timeout=timedelta(seconds=timeout),
        device_id=device if kind == "cuda" else None,
    )
    return device


def _spawned_rank(rank, world, kind, store, timeout, fn, args, messages, results, cancel_event):
    if kind == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    device = _init_group(rank, world, kind, Path(store), timeout)
    ctx = RankContext(rank, world, device, messages.put, cancel_event.is_set)
    # no ``finally``: a rank that raises keeps its group until its traceback
    # is written and the process exits, so a peer's failure in a collective
    # cannot come first
    results.put((rank, fn(ctx, *args)))
    dist.destroy_process_group()


def run_world(
    fn: Callable,
    world: int,
    device: str | torch.device = "cuda",
    args: tuple = (),
    *,
    timeout: float = DEFAULT_TIMEOUT,
    on_message: Callable[[object], None] | None = None,
    cancel: Callable[[], bool] | None = None,
) -> list:
    """Run ``fn(ctx, *args)`` on ``world`` ranks; returns every rank's
    return value, by rank.  ``fn`` and ``args`` are pickled for a spawned
    world (``fn`` by its import path)."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if world < 1:
        raise ValueError(f"a world needs at least one rank, got {world}")
    if kind == "cuda" and world > torch.cuda.device_count():
        raise ValueError(
            f"{world} ranks need {world} cards; {torch.cuda.device_count()} visible"
        )
    on_message = on_message or (lambda _msg: None)
    cancel = cancel or (lambda: False)
    with tempfile.TemporaryDirectory(prefix="iq2a-world-") as tmp:
        store = Path(tmp) / "store"
        if world == 1:
            return [_run_in_process(fn, args, kind, store, timeout, on_message, cancel)]
        return _run_spawned(fn, args, world, kind, store, timeout, on_message, cancel)


def _run_in_process(fn, args, kind, store, timeout, on_message, cancel):
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is already initialised in this process; call the "
            "rank function with a mesh of that world instead"
        )
    current = torch.device("cuda", torch.cuda.current_device()) if kind == "cuda" else None
    rank_device = _init_group(0, 1, kind, store, timeout, current)
    try:
        return fn(RankContext(0, 1, rank_device, on_message, cancel), *args)
    finally:
        dist.destroy_process_group()


def _run_spawned(fn, args, world, kind, store, timeout, on_message, cancel):
    ctx = mp.get_context("spawn")
    messages, results, cancel_event = ctx.Queue(), ctx.Queue(), ctx.Event()

    def drain() -> None:
        while True:
            try:
                msg = messages.get_nowait()
            except queue.Empty:
                return
            on_message(msg)

    if cancel():  # asked before the ranks start: they stop at the first chunk
        cancel_event.set()
    procs = mp.start_processes(
        _spawned_rank,
        args=(world, kind, str(store), timeout, fn, args, messages, results, cancel_event),
        nprocs=world,
        join=False,
        start_method="spawn",
    )
    out: dict = {}

    def collect() -> None:
        # read results while the ranks run: a rank cannot exit before the
        # pipe has taken all it put
        while True:
            try:
                rank, value = results.get_nowait()
            except queue.Empty:
                return
            out[rank] = value

    try:
        while True:
            try:
                done = procs.join(timeout=0.05)
            except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
                raise RankFailed(_rank_errors(procs) or str(exc)) from None
            if cancel():
                cancel_event.set()
            drain()
            collect()
            if done:
                break
        while len(out) < world:
            rank, value = results.get(timeout=timeout)
            out[rank] = value
        return [out[r] for r in range(world)]
    finally:
        for proc in procs.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join(timeout=10)
        drain()


def _rank_errors(procs) -> str:
    """The traceback of every rank that raised, by rank.  The rank seen
    failing first is not always the cause: a rank whose peer died fails in
    its collective too."""
    parts = []
    for rank, path in enumerate(procs.error_files):
        if os.access(path, os.R_OK):
            with open(path, "rb") as fh:
                parts.append(f"-- rank {rank}:\n{pickle.load(fh)}")
            with contextlib.suppress(OSError):
                os.unlink(path)
    return "\n".join(parts)
