"""Segment-worker subprocess: a persistent pipeline executor on stdin/stdout
(port of the JAX package's ``pipeline/seg_worker.py``).

One worker process runs its segments on one torch device, named by
``IQ2A_WORKER_PLATFORM`` (``cpu`` by default; ``cuda`` is allowed).  That
device overrides the ``device`` of every config it is sent: the wired config
is the parent's, whose ``device`` is ``None`` (the card) for a run on the
card, and a worker that trusted it would open the card from a second
process.  Requests are JSON lines:

    {"idx": 3, "config": {<ProcessingConfig fields, paths as strings>}}

and each gets one JSON line back:

    {"idx": 3, "ok": true, "peak": 0.29, "samples": 180000, "seconds": 0.41}

The process stays up across segments, so its imports, the channelizer's
native build (made before the handshake) and the allocator's pools are paid
once.  Used by
:mod:`.hetero` to run host-CPU segment workers beside the in-process device
stream; the heavy data rides the filesystem (input capture windows, output
segment WAVs), not the pipe.  It imports nothing of JAX.

Run as ``python -m iq_to_audio_torch.pipeline.seg_worker``; it prints the
handshake ``{"ready": true, "backend": "<device type>"}`` first, stops on
``{"cmd": "exit"}`` or end of input, and exits with status 130 when a
process-group interrupt cancels it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import sys
import time
from pathlib import Path

_PATH_FIELDS = {
    "in_path",
    "output_path",
    "dump_iq_path",
    "plot_stages_path",
    "profile_dir",
}


def config_to_wire(cfg) -> dict:
    """JSON-safe dict for one ``ProcessingConfig`` (every field)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in _PATH_FIELDS:
            out[f.name] = str(v) if v is not None else None
        elif f.name == "extra_output_paths":
            out[f.name] = [str(p) if p is not None else None for p in v]
        else:
            out[f.name] = v
    return out


def config_from_wire(data: dict):
    """Inverse of :func:`config_to_wire`."""
    from .config import ProcessingConfig

    kwargs = dict(data)
    for name in _PATH_FIELDS:
        if kwargs.get(name) is not None:
            kwargs[name] = Path(kwargs[name])
    kwargs["extra_output_paths"] = [
        Path(p) if p is not None else None
        for p in kwargs.get("extra_output_paths", [])
    ]
    return ProcessingConfig(**kwargs)


def main() -> int:
    logging.basicConfig(
        level=logging.WARNING,
        stream=sys.stderr,
        format="seg-worker %(levelname)s %(message)s",
    )
    # change the scheduling priority when asked (a negative value needs
    # root).  Done here, child-side, because preexec_fn is fork-unsafe in
    # threaded parents.
    nice_req = os.environ.get("IQ2A_WORKER_NICE")
    if nice_req:
        try:
            os.nice(int(nice_req))
        except (OSError, ValueError):
            pass

    from ..utils.device import resolve_device
    from .pipeline import ProcessingPipeline
    from .step import choose_channelizer

    # raises (no handshake: the parent reports the start failure) when the
    # platform names a card this machine does not have
    device = resolve_device(os.environ.get("IQ2A_WORKER_PLATFORM", "cpu"))
    # the CPU's channelizer choice builds native/ddc.cpp on first use: pay
    # that before the handshake, not inside the first segment, whose rate
    # the parent sizes its next claims from
    choose_channelizer(device, want_stages=False, have_taps=True)

    # handshake so the parent can fail fast on a broken environment
    print(json.dumps({"ready": True, "backend": device.type}), flush=True)

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        req = json.loads(line)
        if req.get("cmd") == "exit":
            break
        idx = req.get("idx")
        try:
            cfg = dataclasses.replace(config_from_wire(req["config"]), device=str(device))
            start = time.perf_counter()
            result = ProcessingPipeline(cfg).run(None)
            reply = {
                "idx": idx,
                "ok": True,
                "peak": result.audio_peak,
                "samples": result.input_samples,
                "seconds": time.perf_counter() - start,
                "device": str(device),
            }
        except (KeyboardInterrupt, SystemExit):
            # a process-group SIGINT is a cancellation, not a segment
            # failure: exit so the parent sees EOF (which it reports as a
            # cancellation when the user-cancel flag is set) instead of a
            # misleading "segment worker failed: KeyboardInterrupt"
            return 130
        except Exception as exc:  # surface every failure to the parent
            reply = {"idx": idx, "ok": False, "error": f"{type(exc).__name__}: {exc}"}
        print(json.dumps(reply), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
