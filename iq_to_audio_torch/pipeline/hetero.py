"""Heterogeneous segmented execution: the device stream + host-CPU workers
(port of the JAX package's ``pipeline/hetero.py``).

Runs one capture's frame-aligned segment plan (:mod:`.segmented`) on two
kinds of compute at once: the in-process pipeline on the run's device
(``resolve_device(config.device)``: the card unless the caller asks for the
CPU), and one or more persistent host-CPU worker subprocesses
(:mod:`.seg_worker`, whose device is ``IQ2A_WORKER_PLATFORM``, ``cpu`` by
default, whatever the wired config says).  A shared work queue balances
itself: the device stream takes segments from the front, CPU workers steal
from the back, so whichever side is faster processes more of the capture —
no calibration pass needed.

The scheduling is the JAX package's: rate-sized contiguous claims with
slow-start growth, a wire-health probe plus a resident-compute probe that
predict the device's rate before its first claim, and device abstention
when even one segment would outlast the CPU side draining the whole queue.
Whether splitting pays depends on the machine: the device stream's loop is
host work in Python, and a CPU worker takes host cores from it.

Exactness: identical to segmented/burst mode — frame-aligned windows,
uint32 phase-seeded NCO, discarded lead-ins for the exponentially
convergent carries; segment-vs-serial agreement is held to -60 dB in
``tests/test_torch_segmented.py`` and ``tests/test_torch_hetero*.py``.  The
card's channelizer (3xTF32 on the tensor cores) and the CPU's (native C++
or the FFT bank) agree within 1 LSB of s16 except with the SSB feedback
AGC, whose recurrence amplifies ulp-level input differences; splits of
SSB+AGC captures across the two are gated by ``IQ2A_SSB_AGC_SPLIT``.

On a CUDA device no failure of the hand-written kernel (build, load or
launch) is swallowed: the resident-compute probe, the wire probe and every
device claim re-raise it from :meth:`HeteroExecutor.run`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import select
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..demod import DecoderStats
from ..ops import _cuda_build
from ..ops.ddc import DDCPlan, ddc_apply_il
from ..ops.poly_fir import build_poly_kernel
from ..utils.device import resolve_device
from ..utils.device_clock import resident_rate
from .capture import (
    OUTPUT_RATE,
    Capture,
    ChannelGeometry,
    annotate,
    channel_geometry,
    channel_paths,
    decide_mix_sign,
    is_pass_through,
    resolve_capture,
    warm_frames,
)
from .config import ProcessingConfig
from .pipeline import ProcessingCancelled, ProcessingPipeline, ProcessingResult
from .progress import PhaseState, ProgressSink, ProgressTracker
from .seg_worker import config_to_wire
from .segmented import (
    Segment,
    plan_segments,
    splice_audio,
    splice_iq_slices,
    warm_seconds_for,
)
from .step import choose_channelizer

LOG = logging.getLogger(__name__)

#: prior of the device's resident channelizer rate (input Msps) for the
#: wire-probe prediction until the resident-compute probe has measured it.
#: An arbitrary, deliberately low value, not a measurement: on a CUDA device
#: the probe replaces it before the first claim is sized, and a CPU device
#: measures its rate on its first real claim.
_DEFAULT_DEVICE_MSPS = "100"
#: channelizer calls captured in the resident probe's CUDA graph
_PROBE_GRAPH_CALLS = 4
#: device seconds of graph replays the probe times: short before the device
#: stream's first claim, which waits for it while the CPU workers already
#: drain the queue; longer for :meth:`HeteroExecutor.measure_resident_compute`
_PROBE_SECONDS_CLAIM = 0.005
_PROBE_SECONDS_BENCH = 0.05


@dataclass
class HeteroPlan:
    """The resolved capture, its channel geometry and mixer sign, and the
    segment plan for one run."""

    segments: list[Segment]
    capture: Capture
    geometry: ChannelGeometry
    mix_sign: int
    total_samples: int
    #: ``--demod none``: segments write IQ slices instead of audio
    pass_through: bool = False


def _plan(config: ProcessingConfig, n_segments: int,
          warm_seconds: float | None, front_split: int = 1) -> HeteroPlan:
    """Probe the capture on the host and plan its segments (no device work)."""
    cap = resolve_capture(
        config.in_path, input_format=config.input_format, container=config.input_container,
        sample_rate=config.input_sample_rate, center_freq=config.center_freq,
        center_source=config.center_freq_source, targets=config.all_target_freqs(),
    )
    sample_rate = cap.sample_rate
    pass_through = is_pass_through(config.demod_mode)
    geo = channel_geometry(sample_rate, config.bandwidth, config.fs_ch_target, pass_through)
    with cap.reader(warm_frames(sample_rate, len(geo.taps)), config.iq_order) as reader:
        total = int(reader.total_frames)
        if total <= 0:
            # the serial pipeline reports this cleanly at warm-up; a
            # mix_sign_override would otherwise skip the probe and plan
            # phantom segments that all die late at splice time
            raise ValueError(f"Input {config.in_path} contains no samples.")
        if config.max_input_seconds and config.max_input_seconds > 0:
            total = min(total, max(1, int(math.floor(config.max_input_seconds * sample_rate))))
        mix_sign = decide_mix_sign(
            reader.read_block_raw, resolve_device(config.device), cap.spec.codec,
            config.iq_order, sample_rate, cap.offsets[0], geo,
            override=config.mix_sign_override,
        )

    if warm_seconds is None:
        # mode-aware lead-in (segmented.warm_seconds_for): NFM/AM converge
        # orders of magnitude faster than the blanket 0.5 s ceiling, and
        # lead-ins are pure overhead whenever one side drains the plan
        warm_seconds = warm_seconds_for(
            config.demod_mode, config.agc_enabled, geo.fs_channel, len(geo.taps),
            sample_rate, deemph_us=config.deemph_us,
        )
    # slices stay at the decimated rate
    rs_up, rs_down = (geo.ratio.up, geo.ratio.down) if geo.ratio else (1, 1)
    segments = plan_segments(
        total, sample_rate, geo.decimation, rs_up, rs_down, n_segments,
        warm_seconds=warm_seconds, front_split=front_split,
    )
    return HeteroPlan(segments, cap, geo, mix_sign, total, pass_through)


def hetero_eligible(config: ProcessingConfig) -> bool:
    """True when the heterogeneous runner supports this configuration.

    Diagnostic/stateful modes stay on the serial pipeline: probe-only and
    stage plots are single-stream by meaning, dump-iq writes a side stream
    the splicer does not reassemble, checkpointed or resumed runs carry
    one serial state, and explicit input windows are already segments.
    Multi-target batches ARE eligible (every segment pipeline batches the
    channels through its shared channelizer pass; each channel's output is
    spliced separately), as is pass-through slicing (segments write
    codec-preserving IQ slices, spliced frame-exactly).
    """
    return not (
        config.probe_only
        or config.dump_iq_path is not None
        or config.plot_stages_path is not None
        or config.profile_dir is not None  # one whole-run trace, not N shards
        or config.checkpoint_secs
        or config.resume
        or config.input_start_sample
        or config.input_num_samples is not None
    )


def _load_device_kernels(device: torch.device) -> None:
    """Build and load the hand-written channelizer before the device
    stream's first claim is timed.  Its first load compiles
    ``csrc/poly_fir.cu`` with ``nvcc`` (seconds); inside a claim that cost
    would enter the claim's measured rate, from which the next claims are
    sized."""
    if device.type == "cuda" and choose_channelizer(
        device, want_stages=False, have_taps=True
    ) == "conv":
        _cuda_build.load("poly_fir")


class HeteroExecutor:
    """Persistent heterogeneous segment executor.

    Owns ``cpu_workers`` :mod:`.seg_worker` subprocesses (kept up across
    ``run`` calls so their imports and builds amortise) plus the in-process
    device stream.  Use as a context manager, or call :meth:`close`
    explicitly.
    """

    def __init__(
        self,
        *,
        cpu_workers: int = 1,
        n_segments: int = 8,
        warm_seconds: float | None = None,
        child_env: dict[str, str] | None = None,
    ):
        self.cpu_workers = max(0, int(cpu_workers))
        self.n_segments = max(1, int(n_segments))
        #: None = mode-aware auto (segmented.warm_seconds_for)
        self.warm_seconds = None if warm_seconds is None else float(warm_seconds)
        self._child_env = dict(child_env or {})
        self._procs: list[subprocess.Popen] = []
        self._cancel = threading.Event()
        #: the previous run's worker threads + claim queue/lock, kept so a
        #: failed run's stale threads can be quiesced before the next run
        self._run_threads: list[threading.Thread] = []
        self._run_queue: deque | None = None
        self._run_lock: threading.Lock | None = None
        self._user_cancelled = False
        #: bound on worker spawn (torch import) before the missing
        #: ready-handshake is surfaced as an error
        self.spawn_timeout_seconds = float(
            os.environ.get("IQ2A_WORKER_SPAWN_TIMEOUT", "180")
        )
        self._active_pipeline: ProcessingPipeline | None = None
        self._plan_cache: dict[tuple, HeteroPlan] = {}
        #: the device stream's torch device, resolved from each run's config
        self._device: torch.device | None = None
        #: observed throughputs (seconds-of-signal per wall second, with
        #: their measurement timestamps) per side, persisted across runs,
        #: so later runs size their first device claim from the previous
        #: run's measurement instead of re-probing
        self._rates: dict = {"device": None, "cpu": None}
        #: device-rate measurements older than this re-probe; a probe claim
        #: is a single segment
        self.rate_ttl_seconds = float(os.environ.get("IQ2A_RATE_TTL", "180"))
        #: slow-start device claim floor (seconds of signal): rates
        #: measured on tiny claims UNDERESTIMATE the device's marginal
        #: throughput (the per-run fixed cost dominates), so the claim
        #: doubles while the device is not the straggler and halves when
        #: it is — the measured rate on ever-larger claims then converges
        #: to the true marginal rate
        self._device_take_secs = 0.0
        #: fractional-claim granularity: the plan's FIRST segment is
        #: subdivided into up to this many frame-aligned sub-segments
        #: (plan_segments front_split), so a slow device claiming from the
        #: front can contribute a share smaller than 1/n_segments instead
        #: of abstaining; back-of-queue (CPU) claims merge contiguous runs,
        #: so a side that drains the whole plan pays no extra lead-ins
        self.front_split = max(1, int(os.environ.get("IQ2A_FRONT_SPLIT", "4")))
        #: True while rates["device"] holds a wire-probe PREDICTION rather
        #: than a measured end-to-end segment rate (see _wire_probe_rate)
        self._device_rate_estimated = False
        #: device compute throughput for the wire-probe prediction (input
        #: Msps with data resident).  Starts as a prior (IQ2A_DEVICE_MSPS,
        #: default _DEFAULT_DEVICE_MSPS) and is REPLACED by a one-off
        #: resident-compute measurement the first wire probe performs on a
        #: CUDA device (:meth:`_maybe_measure_compute`) unless the env var
        #: pinned it explicitly.  Only the go/no-go decision uses it; a real
        #: one-segment claim re-measures end-to-end immediately after.
        self.device_compute_msps = float(
            os.environ.get("IQ2A_DEVICE_MSPS", _DEFAULT_DEVICE_MSPS)
        )
        #: cached one-off resident-compute measurement (input Msps)
        self._measured_msps: float | None = None
        #: the last resident-compute probe: its rate, method (``cuda_graph``,
        #: ``profiler_busy`` or ``host_clock``), calls, replays and geometry
        self.last_compute_probe: dict = {}
        #: per-run scheduling telemetry, for logs and benches
        self.last_stats: dict = {}
        #: most recent wire-health probe measurements (bandwidths in B/s),
        #: kept for bench artifacts: {"bw_up", "bw_down", "t_fetch"}
        self.last_wire_probe: dict = {}
        #: every wire probe this executor ever ran, timestamped (epoch
        #: seconds), so a change of the link's rate within a campaign stays
        #: visible instead of being collapsed into one snapshot
        self.wire_probe_log: list[dict] = []

    def reset_rates(self) -> None:
        """Forget observed side throughputs (e.g. after a run whose device
        timing absorbed a one-off cost such as a connection toll), and the
        slow-start claim floor grown alongside them."""
        self._rates["device"] = None
        self._rates["cpu"] = None
        self._device_take_secs = 0.0
        self._device_rate_estimated = False

    # -- lifecycle ---------------------------------------------------------

    def __enter__(self) -> "HeteroExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for proc in self._procs:
            with contextlib.suppress(Exception):
                if proc.poll() is None:
                    proc.stdin.write(json.dumps({"cmd": "exit"}) + "\n")
                    proc.stdin.flush()
                    proc.wait(timeout=10)
        for proc in self._procs:
            with contextlib.suppress(Exception):
                if proc.poll() is None:
                    proc.terminate()
                    proc.wait(timeout=10)
        self._procs.clear()

    def _quiesce_stale_threads(self) -> None:
        """Retire the previous run's worker threads before a new run starts.

        A failed or cancelled run can exit :meth:`run` while its threads
        are still alive — a CPU thread blocked in ``readline()`` on a
        worker pipe, or the device thread inside an uncancellable device
        op.  Left alone, clearing ``_cancel`` for the next run would wake
        them into the DEAD run's still-populated queue and interleave
        their worker-pipe traffic with the new run's threads.  Drain the
        old queue (a woken thread then exits claim-less), terminate the
        worker subprocesses so blocked reads return (the next run
        respawns via ``_ensure_workers``), and join what can be joined."""
        stale = [t for t in self._run_threads if t.is_alive()]
        if not stale:
            self._run_threads = []
            return
        self._cancel.set()
        if self._run_lock is not None and self._run_queue is not None:
            with self._run_lock:
                self._run_queue.clear()
        for proc in self._procs:
            with contextlib.suppress(Exception):
                if proc.poll() is None:
                    proc.terminate()
        for t in stale:
            t.join(timeout=15.0)
        still = [t for t in stale if t.is_alive()]
        if still:
            LOG.warning(
                "hetero: %d worker thread(s) from the previous run are "
                "still busy; their queue is drained so they exit without "
                "touching this run", len(still),
            )
        self._run_threads = still

    def cancel(self) -> None:
        """Cancel the run: the device pipeline stops at its next chunk
        boundary; CPU worker subprocesses are terminated (their in-flight
        segment is discarded with the run) and respawned on the next run."""
        self._user_cancelled = True
        self._cancel.set()
        pipe = self._active_pipeline
        if pipe is not None:
            pipe.cancel()
        for proc in self._procs:
            with contextlib.suppress(Exception):
                if proc.poll() is None:
                    proc.terminate()

    def _drain_stderr(self, proc: subprocess.Popen, tail: deque) -> None:
        """Drain a worker's stderr (avoids a pipe-full deadlock), keeping a
        tail for failure diagnostics and logging each line at DEBUG."""
        try:
            for line in proc.stderr:
                line = line.rstrip()
                if line:
                    tail.append(line)
                    LOG.debug("seg-worker stderr: %s", line)
        except (OSError, ValueError):
            pass

    def _ensure_workers(self) -> None:
        self._procs = [p for p in self._procs if p.poll() is None]
        repo_root = str(Path(__file__).resolve().parents[2])
        while len(self._procs) < self.cpu_workers:
            env = dict(os.environ)
            env.update(self._child_env)
            env.setdefault("IQ2A_WORKER_PLATFORM", "cpu")
            env["PYTHONPATH"] = os.pathsep.join(
                [repo_root, env.get("PYTHONPATH", "")]
            ).rstrip(os.pathsep)
            # fork + exec: safe after CUDA was initialised in this process,
            # which a forked (not exec'd) child would not be
            proc = subprocess.Popen(
                [sys.executable, "-m", "iq_to_audio_torch.pipeline.seg_worker"],
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
                env=env,
                cwd=repo_root,
            )
            stderr_tail: deque = deque(maxlen=40)
            threading.Thread(
                target=self._drain_stderr, args=(proc, stderr_tail),
                daemon=True,
            ).start()
            proc.stderr_tail = stderr_tail  # type: ignore[attr-defined]
            ready = self._read_reply(proc, timeout=self.spawn_timeout_seconds)
            try:
                handshake = json.loads(ready) if ready else {}
            except json.JSONDecodeError:
                handshake = {}
            if not handshake.get("ready"):
                proc.terminate()
                detail = "; ".join(list(stderr_tail)[-5:])
                raise RuntimeError(
                    "segment worker failed to start (no ready handshake"
                    + (f"; stderr: {detail}" if detail else "")
                    + ")"
                )
            LOG.info("segment worker up (backend=%s)", handshake.get("backend"))
            self._procs.append(proc)

    @staticmethod
    def _read_reply(proc: subprocess.Popen, timeout: float) -> str:
        """One stdout line from the worker, or "" on timeout/EOF (the
        caller surfaces both as a handshake/reply failure)."""
        deadline = time.monotonic() + timeout
        while True:
            wait = deadline - time.monotonic()
            if wait <= 0:
                return ""
            readable, _, _ = select.select([proc.stdout], [], [], min(wait, 5.0))
            if readable:
                return proc.stdout.readline()
            if proc.poll() is not None:
                return ""

    # -- execution ---------------------------------------------------------

    def _maybe_measure_compute(
        self, num_taps: int, decimation: int, should_abort=None,
    ) -> None:
        """Replace the device-compute PRIOR with a one-off measured rate.

        Times the production channelizer on resident input at the run's
        real tap count and decimation (:meth:`_measure_compute_msps`).
        Cached for the executor's lifetime; an explicit ``IQ2A_DEVICE_MSPS``
        pins the prior and skips the measurement entirely.  Skipped on a
        CPU device unless ``IQ2A_MEASURE_MSPS=1`` (there the "device" stream
        IS a CPU pipeline whose rate real claims measure immediately).
        """
        if os.environ.get("IQ2A_DEVICE_MSPS"):
            return  # user/test pinned the prior
        if self._measured_msps is not None:
            self.device_compute_msps = self._measured_msps
            return
        device = self._device
        if device.type == "cpu" and os.environ.get("IQ2A_MEASURE_MSPS") != "1":
            return
        msps = self._measure_compute_msps(num_taps, decimation, should_abort, device)
        if msps is not None:
            self._measured_msps = msps
            self.device_compute_msps = msps

    def measure_resident_compute(
        self, num_taps: int, decimation: int,
        device: str | torch.device | None = None,
    ) -> float | None:
        """Measure (and cache) the device's resident-compute rate, input Msps.

        Unconditional variant for bench artifacts: runs even when
        ``IQ2A_DEVICE_MSPS`` pinned the scheduling prior — the pin keeps
        steering claim sizing, but the artifact must state what the device
        itself measures.  ``device`` is the card unless the caller asks for
        the CPU.  Returns None on a CPU device without
        ``IQ2A_MEASURE_MSPS=1``; on a CUDA device a failure raises.
        """
        dev = resolve_device(device)
        if dev.type == "cpu" and os.environ.get("IQ2A_MEASURE_MSPS") != "1":
            return None
        if self._measured_msps is not None:
            return self._measured_msps
        msps = self._measure_compute_msps(num_taps, decimation, None, dev, bench=True)
        if msps is not None:
            self._measured_msps = msps
            if not os.environ.get("IQ2A_DEVICE_MSPS"):
                self.device_compute_msps = msps
        return msps

    def _measure_compute_msps(
        self, num_taps: int, decimation: int, should_abort, device: torch.device,
        *, bench: bool = False,
    ) -> float | None:
        """Measurement core shared by the prior-replacement path and the
        bench-facing :meth:`measure_resident_compute` (``bench``: a longer
        window, and the rate the profiler's device-busy time implies beside
        it): the production channelizer, ``ops/ddc.py::ddc_apply_il`` with
        the hand kernel's taps (``ops/poly_fir.py::poly_fir_il``), over one
        resident chunk of ``IQ2A_MSPS_PROBE_CHUNK`` samples, timed by
        :func:`~iq_to_audio_torch.utils.device_clock.resident_rate`.  The
        whole result, with the probe's wall seconds, lands in
        :attr:`last_compute_probe`.  Returns input Msps, or None on abort;
        on a CPU device also None on failure (the prior stays), on a CUDA
        device a failure raises."""
        if should_abort is not None and should_abort():
            return None
        on_card = device.type == "cuda"
        t0 = time.perf_counter()
        try:
            L = max(int(num_taps), 2)
            chunk_target = int(
                os.environ.get("IQ2A_MSPS_PROBE_CHUNK", str(1 << 22))
            )
            plan = DDCPlan.create(
                L, max(int(decimation), 1), target_chunk=chunk_target
            )
            rng = np.random.default_rng(0)
            # an interleaved (2C = 2, 1, 2L) conv kernel, repacked for the
            # hand kernel as the chunk step does
            kernel_il = (rng.standard_normal((2, 1, 2 * L)) * 1e-2).astype(np.float32)
            poly_w = torch.from_numpy(
                build_poly_kernel(kernel_il, 2 * plan.decimation)
            ).to(device)
            # drawn where it is used: no host draw and upload of the chunk
            # before the device stream's first claim
            gen = torch.Generator(device=device).manual_seed(0)
            x = torch.empty(2 * plan.chunk_size, dtype=torch.float32, device=device)
            x.uniform_(-1.0, 1.0, generator=gen)
            tail = torch.zeros(2 * (L - 1), dtype=torch.float32, device=device)
            phase0 = torch.zeros(1, dtype=torch.int64, device=device)
            inc_lo = torch.full((1,), 123_456_789, dtype=torch.int64, device=device)

            def call(_i: int) -> None:
                ddc_apply_il(plan, poly_w, x, tail, phase0, inc_lo)

            # CUDA graph replays on the card (the device's clock, no Python
            # launches in the window), the host clock on the CPU
            if should_abort is not None and should_abort():
                return None
            probe = resident_rate(
                call, plan.chunk_size, device, calls=_PROBE_GRAPH_CALLS if on_card else 2,
                seconds_target=_PROBE_SECONDS_BENCH if bench else _PROBE_SECONDS_CLAIM,
                kernel_name="poly_fir_kernel", busy=bench,
            )
            self.last_compute_probe = {**probe, "chunk_size": plan.chunk_size, "taps": L,
                                       "decimation": plan.decimation,
                                       "wall_s": time.perf_counter() - t0}
            msps = probe["msps"]
            LOG.info(
                "hetero: resident-compute probe measured %.0f Msps "
                "(%d taps, decim %d, %d calls x %d replays, %s, %s, %.3f s) — replaces "
                "the %.0f Msps prior",
                msps, L, plan.decimation, probe["calls"], probe["replays"], probe["method"],
                device, self.last_compute_probe["wall_s"], self.device_compute_msps,
            )
            return msps
        except Exception as exc:
            if on_card:
                raise  # a kernel that fails to build, load or launch
            LOG.debug("hetero: resident-compute probe failed (%s); keeping "
                      "the %.0f Msps prior", exc, self.device_compute_msps)
            return None

    def _wire_probe_rate(
        self, seg_seconds: float, seg_bytes: int, seg_samples: int,
        audio_bytes: int, should_abort=None,
        num_taps: int = 0, decimation: int = 1,
    ) -> float | None:
        """Predict the device stream's seconds-of-signal-per-wall-second
        rate for a single-segment claim from a cheap wire-health probe.

        Times a small H2D upload of pageable host memory (1 MiB, refined
        with 8 MiB only when the link looks fast — a slow link must not
        spend seconds probing) and one small D2H fetch, each leg between
        two ``torch.cuda.synchronize`` calls, then models a segment claim as
        upload + resident compute (at ``device_compute_msps``) +
        max(fetch latency, output fetch).  The point is the go/no-go
        decision WITHOUT committing a full segment to a slow link.  A "go"
        still claims only one real segment, whose measured end-to-end rate
        immediately replaces this estimate.  Returns None when
        ``should_abort`` says the probe became moot mid-flight (e.g. the
        queue drained).
        """
        device = self._device
        on_card = device.type == "cuda"

        def _sync() -> None:
            if on_card:
                torch.cuda.synchronize(device)

        def _up(host: torch.Tensor) -> float:
            _sync()
            t0 = time.perf_counter()
            host.to(device)
            _sync()
            return max(time.perf_counter() - t0, 1e-6)

        small_up = torch.zeros(1 << 18, dtype=torch.float32)  # 1 MiB
        bw_up = small_up.numel() * 4 / _up(small_up)
        if should_abort is not None and should_abort():
            return None
        probe = torch.zeros(2 * (1 << 20), dtype=torch.float32)  # 8 MiB refinement
        if probe.numel() * 4 / bw_up < 2.0:
            # fast link: the 1 MiB sample understates it — refine with a
            # transfer big enough to amortise the setup
            bw_up = probe.numel() * 4 / _up(probe)
        if should_abort is not None and should_abort():
            return None
        down = torch.zeros(1 << 18, dtype=torch.float32, device=device)  # 1 MiB
        _sync()
        t0 = time.perf_counter()
        down.cpu()
        _sync()
        t_fetch = max(time.perf_counter() - t0, 1e-6)
        bw_down = down.numel() * 4 / t_fetch
        self.last_wire_probe = {
            "bw_up": bw_up, "bw_down": bw_down, "t_fetch": t_fetch,
        }
        self.wire_probe_log.append(dict(self.last_wire_probe, t=time.time()))
        del self.wire_probe_log[:-200]  # bound the log across long campaigns
        self._maybe_measure_compute(num_taps, decimation, should_abort=should_abort)
        t_seg = (
            seg_bytes / bw_up
            + seg_samples / max(self.device_compute_msps * 1e6, 1e-9)
            + max(t_fetch, audio_bytes / max(bw_down, 1e-9))
        )
        rate = seg_seconds / max(t_seg, 1e-9)
        LOG.info(
            "hetero: wire probe %.1f MB/s up, %.1f MB/s down (%.4f s fetch) "
            "-> predicted %.1fx device segment rate",
            bw_up / 1e6, bw_down / 1e6, t_fetch, rate,
        )
        return rate

    def run(
        self,
        config: ProcessingConfig,
        progress_sink: ProgressSink | None = None,
        *,
        device_warm_no_fetch: bool = False,
    ) -> ProcessingResult | None:
        """Process ``config`` heterogeneously; fall back to the serial
        pipeline when the config is ineligible or the plan is degenerate.

        The device stream runs on ``resolve_device(config.device)`` (the card
        unless the config asks for the CPU; without a card and without that
        request this raises).  With ``device_warm_no_fetch`` the device
        stream dispatches its segments without fetching and nothing is
        spliced (bench warm passes); returns None in that mode.
        """
        self._quiesce_stale_threads()
        self._cancel.clear()
        self._user_cancelled = False
        device = resolve_device(config.device)
        self._device = device

        def _serial_fallback(reason: str) -> ProcessingResult | None:
            LOG.info("hetero: %s; running serial pipeline", reason)
            pipe = ProcessingPipeline(config)
            pipe.warm_no_fetch = device_warm_no_fetch
            result = pipe.run(progress_sink)
            return None if device_warm_no_fetch else result

        if not hetero_eligible(config):
            return _serial_fallback("config not segmentable")

        plan = self._plan_or_none(config)
        if plan is None or len(plan.segments) < 2:
            return _serial_fallback("capture too short to segment")
        cap, geo = plan.capture, plan.geometry

        # Cross-device determinism gate: the feedback-AGC recurrence
        # amplifies ulp-level differences between the card's channelizer
        # (3xTF32 on the tensor cores) and the CPU workers' (native C++ or
        # the FFT bank), so splitting ONE SSB+AGC capture across both is
        # audible in principle.  Policy via IQ2A_SSB_AGC_SPLIT: "warn"
        # (default) proceeds with a WARNING; "pin" keeps the run on the CPU
        # workers (one device, deterministic vs the worker's own serial run).
        pin_device_out = False
        mode_l = (config.demod_mode or "").lower()
        if (
            mode_l in {"usb", "lsb", "ssb"}
            and config.agc_enabled
            and self.cpu_workers > 0
            and not device_warm_no_fetch
            and device.type != "cpu"
        ):
            policy = os.environ.get("IQ2A_SSB_AGC_SPLIT", "warn").lower()
            if policy == "pin":
                LOG.info(
                    "hetero: SSB+AGC capture pinned to the host-CPU workers "
                    "(IQ2A_SSB_AGC_SPLIT=pin): splits of the feedback-AGC "
                    "recurrence across devices diverge at the ulp level"
                )
                pin_device_out = True
            else:
                LOG.warning(
                    "hetero: splitting an SSB+AGC capture across the %s "
                    "stream and CPU workers — the feedback-AGC recurrence "
                    "amplifies ulp-level channelizer differences between "
                    "the two.  Set IQ2A_SSB_AGC_SPLIT=pin to keep such runs "
                    "on one device.", device,
                )

        # final per-channel output paths, named exactly like the serial
        # pipeline's (shared --out hints get the _<freq> suffix when
        # batching, explicit per-channel extras are honoured verbatim)
        if config.target_freq <= 0:
            # the serial pipeline targets the detected center when no
            # explicit frequency is given (pipeline.py fallback) — rare
            # library-caller path, keep its exact semantics there
            return _serial_fallback("no explicit target frequency")
        freqs = cap.freqs
        final_paths = channel_paths(config, freqs, config.output_path, cap.spec)
        multi = len(freqs) > 1
        out_path = final_paths[0]
        for p in final_paths:  # serial parity: every channel's parent
            p.parent.mkdir(parents=True, exist_ok=True)

        tracker = ProgressTracker(progress_sink)
        tracker.start(
            [
                PhaseState(
                    "segments", "Process segments", float(len(plan.segments)),
                    unit="segments",
                )
            ]
        )
        with contextlib.suppress(AttributeError):
            if progress_sink is not None:
                progress_sink.set_cancel_callback(self.cancel)

        try:
            if self.cpu_workers:
                self._ensure_workers()

            queue: deque[Segment] = deque(plan.segments)
            lock = threading.Lock()
            # retained for _quiesce_stale_threads if this run errors out
            self._run_queue = queue
            self._run_lock = lock
            errors: list[BaseException] = []
            #: finished spans: {"first": idx, "span": n_segments, "path": ...,
            #: "skip": audio_skip}
            completed: list[dict] = []
            stats = {
                "device_segments": 0,
                "cpu_segments": 0,
                "device_runs": 0,
                "device_seconds": 0.0,
                "cpu_seconds": 0.0,
                # seconds-of-signal each side processed (per-side realtime
                # factors for logs/benches: signal_seconds / wall seconds)
                "device_signal_seconds": 0.0,
                "cpu_signal_seconds": 0.0,
                "device_abstained": False,
            }
            rates = self._rates
            sr = max(cap.sample_rate, 1e-9)

            def _secs(segs) -> float:
                """Owned signal seconds across an iterable of segments."""
                return sum(s.length for s in segs) / sr

            total_sec = _secs(plan.segments)

            #: True while the device may still defer a marginal-estimate claim
            #: waiting for a CPU-side measurement (cleared after a bounded
            #: wait so a wedged CPU side cannot park the device forever)
            blind_wait = [True]

            def _device_claim_size() -> int:
                """Contiguous FRONT segments the device should claim (called
                under ``lock`` with a non-empty queue); 0 = abstain, -1 =
                defer (marginal estimate, waiting on a CPU measurement).

                Sized in SECONDS of signal, not entry counts: the plan's
                front segments are finer-grained (``front_split``), so a
                slow device can claim a share smaller than one full segment
                instead of abstaining outright.  Each device run has a fixed
                cost (building the chunk step, the first uploads, the
                closing fetch), so the claim is one contiguous run of front
                entries — one pipeline run, one lead-in.  Until a real claim
                has been measured the rate is a wire-probe PREDICTION
                (``_refresh_device_estimate``) gating a one-entry probe
                claim; with no CPU side (or in a warm pass) it takes
                everything.

                When even the SMALLEST front entry would outlast the CPU
                side draining the whole queue, the device ABSTAINS and lets
                the CPU side process the capture; its stale rate expires
                after ``rate_ttl_seconds`` so a later run re-probes.
                """
                remaining = len(queue)
                if not self.cpu_workers or device_warm_no_fetch:
                    return remaining
                now = time.monotonic()
                dev = rates["device"]
                if dev is not None and now - dev[1] > self.rate_ttl_seconds:
                    dev = None  # stale — the loop wire-probes before claiming
                cpu = rates["cpu"]
                if cpu is not None and now - cpu[1] > self.rate_ttl_seconds:
                    cpu = None  # stale — the CPU side refreshes on its claims
                front_sec = queue[0].length / sr
                rem_sec = _secs(queue)
                if dev is not None and self._device_rate_estimated:
                    # wire-probe PREDICTION (no measured claim yet): the point
                    # is only the go/no-go — a "go" claims ONE real entry,
                    # whose measured rate replaces the estimate.  Abstention
                    # on a prediction needs a wide margin (3x vs the measured
                    # path's 0.8x) because small-transfer bandwidth can
                    # understate the link
                    r_d = dev[0]
                    if cpu is None:
                        # no CPU measurement yet: a catastrophic prediction
                        # (slower than realtime) abstains outright, an
                        # overwhelming one (>=20x — even 8x estimate error
                        # cannot make it the straggler) goes immediately, and
                        # the marginal band DEFERS until the first CPU claim
                        # lands (a blind claim in that band can straggle
                        # behind a fast CPU side)
                        if r_d < 1.0:
                            return 0
                        if r_d >= 20.0 or not blind_wait[0]:
                            return 1
                        return -1  # defer: the loop waits for a cpu rate
                    total_cpu = cpu[0] * max(1, len(self._procs))
                    if (front_sec / max(r_d, 1e-9)
                            > 3.0 * rem_sec / max(total_cpu, 1e-9)):
                        return 0
                    return 1
                if dev is None or cpu is None:
                    return 1
                r_d, r_c = dev[0], cpu[0]
                total_cpu = r_c * max(1, len(self._procs))
                t_cpu_all = rem_sec / max(total_cpu, 1e-9)
                # participation helps only when max(T_dev(claim), T_cpu(rest))
                # beats the CPU-only wall T_cpu(all); since T_cpu(rest) always
                # does, the device must clear T_dev(smallest claim) <
                # T_cpu(all) — and CLEARLY so (0.8 slack), because a marginal
                # device claim that misses its estimate straggles the whole
                # run
                if front_sec / max(r_d, 1e-9) > 0.8 * t_cpu_all:
                    return 0
                share = r_d / max(r_d + total_cpu, 1e-9)
                want_sec = max(rem_sec * share, self._device_take_secs)
                # keep at least one entry per CPU worker in the pool so the
                # fast side never idles behind a mis-estimated device claim
                max_take = remaining - min(remaining - 1, len(self._procs))
                take, acc = 0, 0.0
                for s in list(queue)[:max_take]:
                    s_sec = s.length / sr
                    # never grow the claim past the share target or the
                    # straggler bound — a too-big claim IS the tail
                    if take > 0 and (
                        acc >= want_sec
                        or (acc + s_sec) / max(r_d, 1e-9) > 0.8 * t_cpu_all
                    ):
                        break
                    acc += s_sec
                    take += 1
                return max(1, take)

            def _merge(claims: list[Segment]) -> Segment:
                """One contiguous run of segments as a single window (claims
                are adjacent front-of-queue segments, so owned regions tile)."""
                first = claims[0]
                return Segment(
                    index=first.index,
                    start=first.start,
                    length=sum(c.length for c in claims),
                    lead=first.lead,
                    audio_skip=first.audio_skip,
                )

            def _seg_channel_paths(seg_path: Path) -> list[Path]:
                """Per-channel files one segment run writes (channel 0 gets the
                _<freq> suffix when batching — capture.channel_paths rules)."""
                if not multi:
                    return [seg_path]
                first = annotate(seg_path, freqs[0])
                extras = [
                    seg_path.with_name(f"{seg_path.stem}_ch{i}{seg_path.suffix}")
                    for i in range(1, len(freqs))
                ]
                return [first, *extras]

            def _segment_config(seg: Segment, seg_path: Path) -> ProcessingConfig:
                return dataclasses.replace(
                    config,
                    output_path=seg_path,
                    extra_output_paths=_seg_channel_paths(seg_path)[1:],
                    center_freq=cap.center_freq,
                    center_freq_source=cap.center_source,
                    mix_sign_override=plan.mix_sign,
                    input_start_sample=seg.read_start,
                    input_num_samples=seg.read_samples,
                    max_input_seconds=None,
                    input_container=cap.spec.container,
                    input_format=cap.spec.codec,
                    # claims vary in length; one accumulator geometry for all
                    fixed_device_geometry=True,
                )

            #: set when every planned segment has a completed span (or a side
            #: errored) — the run waits on THIS, not on thread joins: a device
            #: thread stuck in an uncancellable op must not hold the finished
            #: run hostage
            done = threading.Event()

            def _note_progress_locked() -> None:
                if sum(c["span"] for c in completed) == len(plan.segments):
                    done.set()

            #: True while the device stream is still taking/processing claims;
            #: a lone CPU worker claims the whole remaining queue once False
            device_active = [True]
            #: CPU requests currently in flight (straggler detection: a device
            #: claim that finishes while work remains anywhere wasn't the tail)
            cpu_busy = [0]

            def _device_worker(tmpdir: Path) -> None:
                # every failure of the device side (the kernel's build, the
                # probes, a claim) fails the run: none is left to the CPU
                # workers to hide
                try:
                    _load_device_kernels(device)
                    _device_loop(tmpdir)
                except BaseException as exc:
                    with lock:
                        errors.append(exc)
                    self._cancel.set()
                    done.set()
                finally:
                    device_active[0] = False

            def _refresh_device_estimate() -> None:
                """Wire-probe a missing/stale device rate (outside the lock)."""
                if not self.cpu_workers or device_warm_no_fetch:
                    return
                dev = rates["device"]
                if dev is not None and (
                    time.monotonic() - dev[1] <= self.rate_ttl_seconds
                ):
                    return
                # model the claim the device would actually take: the FRONT
                # entry (finer-grained under front_split, so the probe's
                # go/no-go prices the real fractional claim, not a full
                # segment the device would never be offered)
                with lock:
                    seg = queue[0] if queue else plan.segments[-1]
                seg_sec = seg.length / sr
                bpf = cap.spec.bytes_per_frame
                if plan.pass_through:
                    out_bytes = seg_sec * geo.fs_channel * bpf
                else:
                    out_bytes = seg_sec * OUTPUT_RATE * 2 * len(freqs)
                try:
                    est = self._wire_probe_rate(
                        seg_sec, int(seg.read_samples) * bpf,
                        int(seg.read_samples), int(out_bytes),
                        should_abort=lambda: self._cancel.is_set() or not queue,
                        num_taps=len(geo.taps),
                        decimation=geo.decimation,
                    )
                except Exception as exc:
                    if device.type == "cuda":
                        raise  # a failed copy or kernel on the card
                    LOG.debug("hetero: wire probe failed (%s); falling back to "
                              "a one-segment probe claim", exc)
                    return
                if est is None:
                    return  # moot mid-probe (queue drained / cancelled)
                with lock:
                    rates["device"] = (est, time.monotonic())
                    self._device_rate_estimated = True

            def _device_loop(tmpdir: Path) -> None:
                if pin_device_out:
                    stats["device_abstained"] = True
                    return
                defer_started = None
                while not self._cancel.is_set():
                    _refresh_device_estimate()
                    with lock:
                        if not queue:
                            return
                        take = _device_claim_size()
                    if take < 0:
                        # marginal estimate, no CPU measurement yet: wait for
                        # the first CPU claim to land (bounded — a wedged CPU
                        # side must not park the device forever)
                        now = time.monotonic()
                        if defer_started is None:
                            defer_started = now
                        if now - defer_started > 10.0:
                            blind_wait[0] = False  # proceed with a blind claim
                        time.sleep(0.1)
                        continue
                    with lock:
                        if not queue:
                            return
                        take = min(take, len(queue))
                        if take == 0:
                            stats["device_abstained"] = True
                            cpu_rate = rates["cpu"]
                            LOG.info(
                                "hetero: device stream abstains (%s %.2fx vs "
                                "cpu-side %s x%d) — CPU workers drain the "
                                "remaining %d segment(s)",
                                "predicted" if self._device_rate_estimated
                                else "measured",
                                rates["device"][0],
                                f"{cpu_rate[0]:.2f}x" if cpu_rate else "unmeasured",
                                max(1, len(self._procs)), len(queue),
                            )
                            return
                        claims = [queue.popleft() for _ in range(take)]
                    seg = _merge(claims)
                    seg_path = tmpdir / f"seg{seg.index:03d}.wav"
                    pipe = ProcessingPipeline(_segment_config(seg, seg_path))
                    pipe.warm_no_fetch = device_warm_no_fetch
                    self._active_pipeline = pipe
                    start = time.perf_counter()
                    try:
                        pipe.run(None)
                    finally:
                        self._active_pipeline = None
                    elapsed = time.perf_counter() - start
                    with lock:
                        completed.append(
                            {"first": seg.index, "span": len(claims),
                             "path": seg_path, "skip": seg.audio_skip}
                        )
                        stats["device_segments"] += len(claims)
                        stats["device_runs"] += 1
                        stats["device_seconds"] += elapsed
                        stats["device_signal_seconds"] += (
                            seg.length / cap.sample_rate
                        )
                        _note_progress_locked()
                        more_work = bool(queue) or cpu_busy[0] > 0
                        if not device_warm_no_fetch:
                            # fetch-free warm runs are artificially fast; they
                            # must not seed the claim-sizing rate estimate
                            rates["device"] = (
                                seg.length / cap.sample_rate / max(elapsed, 1e-9),
                                time.monotonic(),
                            )
                            self._device_rate_estimated = False
                            # slow-start: grow while not the straggler (the
                            # next, larger claim measures a better-amortised
                            # rate), shrink when we were the tail
                            claim_sec = seg.length / sr
                            if more_work:
                                self._device_take_secs = min(
                                    claim_sec * 2.0, total_sec
                                )
                            else:
                                self._device_take_secs = claim_sec / 2.0
                    tracker.advance("segments", float(len(claims)))
                    tracker.status(
                        f"segments {seg.index}..{seg.index + len(claims) - 1} "
                        "done (device)"
                    )

            def _cpu_claim_size(remaining: int) -> int:
                """Contiguous segments one CPU worker should claim (back of
                the queue; called under ``lock``).  While other workers are
                still in the pool the claim halves the per-worker share so
                stealing can rebalance; once this worker is effectively
                alone (device abstained or finished, no sibling CPU workers)
                it takes everything — one pipeline run, one lead-in.  With
                both sides' rates known the share is throughput-proportional
                (a near-dead device no longer shrinks CPU claims to slivers
                while it probes); otherwise it falls back to an equal split.
                Sized in SECONDS so the front-split plan's uneven entry
                lengths cannot skew the share."""
                others = max(0, len(self._procs) - 1) + int(device_active[0])
                if others == 0:
                    return remaining
                dev, cpu = rates["device"], rates["cpu"]
                if device_active[0] and dev is not None and cpu is not None:
                    n_c = max(1, len(self._procs))
                    share = cpu[0] / max(dev[0] + n_c * cpu[0], 1e-9)
                else:
                    share = 1.0 / (others + 1)
                want_sec = _secs(queue) * share / 2.0
                take, acc = 0, 0.0
                for s in reversed(list(queue)):
                    if take > 0 and acc >= want_sec:
                        break
                    acc += s.length / sr
                    take += 1
                return max(1, min(take, remaining))

            def _cpu_worker(proc: subprocess.Popen, tmpdir: Path) -> None:
                while not self._cancel.is_set():
                    with lock:
                        if not queue:
                            return
                        take = _cpu_claim_size(len(queue))
                        # back of the queue: pop the LAST `take` segments,
                        # which are contiguous, then restore ascending order
                        claims = [queue.pop() for _ in range(take)][::-1]
                        cpu_busy[0] += 1
                    seg = _merge(claims)
                    seg_path = tmpdir / f"seg{seg.index:03d}.wav"
                    req = {
                        "idx": seg.index,
                        "config": config_to_wire(_segment_config(seg, seg_path)),
                    }
                    start = time.perf_counter()
                    try:
                        proc.stdin.write(json.dumps(req) + "\n")
                        proc.stdin.flush()
                        line = proc.stdout.readline()
                        reply = json.loads(line) if line else {}
                    except (OSError, json.JSONDecodeError) as exc:
                        with lock:
                            cpu_busy[0] -= 1
                            errors.append(
                                RuntimeError(f"segment worker pipe failed: {exc}")
                            )
                        self._cancel.set()
                        done.set()
                        return
                    if not reply.get("ok"):
                        with lock:
                            cpu_busy[0] -= 1
                            errors.append(
                                RuntimeError(
                                    "segment worker failed on segment "
                                    f"{seg.index}: {reply.get('error', 'no reply')}"
                                )
                            )
                        self._cancel.set()
                        done.set()
                        return
                    elapsed = time.perf_counter() - start
                    with lock:
                        cpu_busy[0] -= 1
                        completed.append(
                            {"first": seg.index, "span": len(claims),
                             "path": seg_path, "skip": seg.audio_skip}
                        )
                        stats["cpu_segments"] += len(claims)
                        stats["cpu_seconds"] += elapsed
                        stats["cpu_signal_seconds"] += (
                            seg.length / cap.sample_rate
                        )
                        _note_progress_locked()
                        rate = seg.length / cap.sample_rate / max(elapsed, 1e-9)
                        prev = rates["cpu"]
                        rates["cpu"] = (
                            rate if prev is None else 0.5 * (prev[0] + rate),
                            time.monotonic(),
                        )
                    tracker.advance("segments", float(len(claims)))
                    tracker.status(
                        f"segments {seg.index}..{seg.index + len(claims) - 1} "
                        "done (cpu)"
                    )

            loop_start = time.perf_counter()
            # ignore_cleanup_errors: on cancel/error paths a still-busy
            # device thread can be mid-claim writing segment files while the
            # directory is removed — the race is benign, the files are temp
            with tempfile.TemporaryDirectory(
                dir=out_path.parent, ignore_cleanup_errors=True
            ) as tmp:
                tmpdir = Path(tmp)
                threads = [
                    threading.Thread(
                        target=_device_worker, args=(tmpdir,), daemon=True,
                        name="hetero-device",
                    )
                ]
                if not device_warm_no_fetch:
                    threads += [
                        threading.Thread(
                            target=_cpu_worker, args=(proc, tmpdir), daemon=True,
                            name=f"hetero-cpu{i}",
                        )
                        for i, proc in enumerate(self._procs)
                    ]
                self._run_threads = threads
                for t in threads:
                    t.start()
                # wait for COMPLETION (every span finished, or an error), not
                # for thread joins: a device thread stuck in an uncancellable
                # op must not hold the finished run hostage.  A stuck probe
                # aborts itself when it unblocks (should_abort sees the
                # drained queue); in-flight CLAIMS own segments, so
                # completion implies none are pending.
                while not done.is_set():
                    if self._user_cancelled:
                        break
                    if not any(t.is_alive() for t in threads):
                        break  # all sides exited; tiling check below verdicts
                    done.wait(0.25)
                if device.type == "cuda":
                    # a failure on the card (the kernel's build, a probe)
                    # must reach the caller even when the CPU workers
                    # finished every segment first; with every segment
                    # done the device thread is at most in a probe or the
                    # build, and no CUDA call stays blocked the way a
                    # remote link can
                    threads[0].join()
                loop_seconds = time.perf_counter() - loop_start
                # per-side realtime factors (signal seconds per wall second
                # of that side's own runs) — the honest split behind the
                # merged wall number, machine-readable for bench artifacts
                dev_x = (
                    stats["device_signal_seconds"] / stats["device_seconds"]
                    if stats["device_seconds"] > 0 else None
                )
                cpu_x = (
                    stats["cpu_signal_seconds"] / stats["cpu_seconds"]
                    if stats["cpu_seconds"] > 0 else None
                )
                self.last_stats = dict(
                    stats,
                    loop_seconds=loop_seconds,
                    device_x=dev_x,
                    cpu_x=cpu_x,
                    wire_probe=dict(self.last_wire_probe),
                    device=str(device),
                )

                if self._user_cancelled:
                    # a terminated worker's pipe error is a CONSEQUENCE of the
                    # cancel, not the cause — report the cancellation
                    raise ProcessingCancelled("Processing cancelled by request.")
                if errors:
                    raise errors[0]
                if self._cancel.is_set():
                    raise ProcessingCancelled("Processing cancelled by request.")
                if device_warm_no_fetch:
                    return None

                ordered = sorted(completed, key=lambda c: c["first"])
                expect = 0
                for item in ordered:
                    if item["first"] != expect:
                        raise RuntimeError(
                            f"hetero: segment {expect} never completed "
                            f"(next finished span starts at {item['first']})"
                        )
                    expect += item["span"]
                if expect != len(plan.segments):
                    raise RuntimeError(
                        f"hetero: segments {expect}..{len(plan.segments) - 1} "
                        "never completed"
                    )
                peaks: list[float] = []
                rms_list: list[float] = []
                for c, final in enumerate(final_paths):
                    paths_c = [_seg_channel_paths(item["path"])[c] for item in ordered]
                    skips_c = [item["skip"] for item in ordered]
                    if plan.pass_through:
                        peak_c, _total = splice_iq_slices(
                            paths_c, skips_c, final,
                            geo.fs_channel, cap.spec,
                        )
                    else:
                        peak_c, _total, rms_c = splice_audio(paths_c, skips_c, final)
                        rms_list.append(rms_c)
                    peaks.append(peak_c)

            LOG.info(
                "hetero: %d segments (device %d in %d run(s), %.2f s%s; "
                "cpu %d in %.2f s%s), %.3f s wall",
                len(plan.segments),
                stats["device_segments"],
                stats["device_runs"],
                stats["device_seconds"],
                f" = {dev_x:.1f}x" if dev_x is not None else "",
                stats["cpu_segments"],
                stats["cpu_seconds"],
                f" = {cpu_x:.1f}x" if cpu_x is not None else "",
                loop_seconds,
            )
            peak_label = (
                "IQ slice peak magnitude" if plan.pass_through
                else "Audio peak level"
            )
            for c, (freq, peak_c) in enumerate(zip(freqs, peaks)):
                peak_db = 20.0 * math.log10(peak_c) if peak_c > 0 else -120.0
                if c < len(rms_list):  # serial-parity log line (pipeline.py)
                    LOG.info("[%.0f] %s %.2f dBFS, RMS %.2f dBFS.", freq,
                             peak_label, peak_db, rms_list[c])
                else:
                    LOG.info("[%.0f] %s %.2f dBFS.", freq, peak_label, peak_db)
            return ProcessingResult(
                sample_rate_probe=cap.probe,
                center_freq=cap.center_freq,
                target_freq=cap.freqs[0],
                freq_offset=cap.offsets[0],
                decimation=geo.decimation,
                fs_channel=geo.fs_channel,
                mix_sign=plan.mix_sign,
                audio_peak=peaks[0] if peaks else 0.0,
                audio_peaks=peaks,
                stats=[DecoderStats(rms_dbfs=r) for r in rms_list],
                output_paths=final_paths,
                loop_seconds=loop_seconds,
                input_samples=plan.total_samples,
            )
        finally:
            # the sink contract is close-exactly-once at teardown —
            # including the error/cancel exits the serial pipeline
            # covers with its own finally (pipeline.py run)
            tracker.close()

    def _plan_or_none(self, config: ProcessingConfig) -> HeteroPlan | None:
        try:
            stat = os.stat(config.in_path)
            key = (
                str(config.in_path), stat.st_mtime_ns, stat.st_size,
                config.target_freq, config.bandwidth, config.demod_mode,
                config.fs_ch_target, config.iq_order, config.input_format,
                config.input_container, config.input_sample_rate,
                config.center_freq, config.mix_sign_override,
                config.max_input_seconds, self.n_segments, self.warm_seconds,
                self.front_split,
            )
            plan = self._plan_cache.get(key)
            if plan is None:
                plan = _plan(config, self.n_segments, self.warm_seconds,
                             front_split=self.front_split)
                self._plan_cache[key] = plan
            return plan
        except ValueError:
            raise
        except Exception as exc:  # malformed/missing input surfaces serially
            LOG.debug("hetero planning failed (%s); falling back", exc)
            return None


def run_hetero(
    config: ProcessingConfig,
    progress_sink: ProgressSink | None = None,
    *,
    cpu_workers: int = 1,
    n_segments: int = 8,
) -> ProcessingResult:
    """One-shot convenience wrapper around :class:`HeteroExecutor`."""
    with HeteroExecutor(cpu_workers=cpu_workers, n_segments=n_segments) as ex:
        result = ex.run(config, progress_sink)
    if result is None:
        raise RuntimeError("run_hetero: the executor returned no result")
    return result
