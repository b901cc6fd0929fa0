"""Tracing and profiling (port of ocr_system_tpu/utils/profiler.py).

Stage wall clocks (``StageTimer``) and device memory for the stats API, as
in the JAX package, and the device side: a ``torch.profiler`` trace around
any stage (``device_trace``, the counterpart of the JAX package's
``jax.profiler`` trace), and one wave's det and rec device time with its
FLOP count and MFU (``det_rec_breakdown``).

The program's own spans and counters (``SPANS``): ``span(name)`` around a
layer's work, ``count(name, n)`` onto the innermost span its thread has
open, ``timed(name)`` for a span whose clock the caller also reads (the
engine's ``stage_ms``, ``StageTimer``). Spans are recorded only while a
``torch.profiler`` records in the process (its module flag, which every
thread sees; ``torch.autograd._profiler_enabled()`` is per thread and
reads False in the scheduler's det worker); otherwise a span site reads
that flag and records nothing. They never go through ``record_function``
or NVTX, whose ranges the profiler would mirror onto the device timeline
as if they were device work. Each span carries the ``PageScheduler.process``
call and wave its thread serves (``span_ids``), so the spans of one wave
share them across the main thread and the det worker; times are
``time.perf_counter_ns``, and ``SpanLog.on_unix_clock`` moves them onto
``torch.profiler``'s clock (Unix-epoch ns) by one anchor taken when
recording starts.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterator

import torch
import torch.autograd.profiler as _torch_profiler

# repeats of each timed device pass: R back-to-back launches, one final
# synchronise (the JAX package's _REPS)
_REPS = 6

# dense peak FLOP/s by card (torch.cuda.get_device_name) and compute dtype,
# from NVIDIA's data sheets without sparsity; "tf32" is float32 with TF32 on.
# "NVIDIA H100 80GB HBM3" is the SXM part.
_PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {
        torch.bfloat16: 989e12, torch.float16: 989e12, "tf32": 495e12, torch.float32: 67e12,
    },
}


@contextlib.contextmanager
def device_trace(log_dir: str | Path, device: str | torch.device | None = None
                 ) -> Iterator[torch.profiler.profile]:
    """Trace the body with ``torch.profiler`` (CPU and CUDA activity) and
    write it as a Chrome trace (viewable in Perfetto or chrome://tracing)
    into ``log_dir``. Yields the profiler, whose ``events()`` and
    ``key_averages()`` the caller may read after the block.

    The device is the card: without one it raises, unless the caller passes
    ``device="cpu"``, which records CPU activity only. A CUDA trace that holds
    no kernel event raises instead of writing an empty device trace.
    Usage: ``with device_trace("traces/run1"): engine.process_pages(pages)``.
    """
    from ocr_system_tpu_torch.core.dtypes import resolve_device

    dev = resolve_device(device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    since = time.perf_counter_ns()
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    if dev.type == "cuda" and not any(
            e.device_type == torch.autograd.DeviceType.CUDA for e in prof.events()):
        raise RuntimeError("device_trace: torch.profiler recorded no CUDA kernel; "
                           "no trace written")
    path = Path(log_dir) / f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    _merge_spans(path, [s for s in SPANS.spans if s.start_ns >= since])


def _merge_spans(path: Path, spans: list[Span]) -> None:
    """Write the program's ``spans`` into the Chrome trace at ``path`` as
    complete events of this process, one row per thread, on the file's own
    time base (``baseTimeNanoseconds`` plus ``ts`` in microseconds)."""
    if not spans:
        return
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    events = trace.setdefault("traceEvents", [])
    pid = os.getpid()
    named = {e.get("tid") for e in events if e.get("ph") == "M" and e.get("name") == "thread_name"}
    for s, start, end in SPANS.on_unix_clock(spans):
        if s.thread not in named:
            named.add(s.thread)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": s.thread,
                           "args": {"name": f"thread {s.thread}"}})
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": s.thread, "ts": (start - base) / 1e3, "dur": (end - start) / 1e3,
                       "args": {"call": s.call, "wave": s.wave, "id": s.id, "parent": s.parent,
                                **s.counts}})
    path.write_text(json.dumps(trace))


# spans a log keeps; those closed past it are counted in ``dropped``
SPAN_CAP = 1 << 17


class Span:
    """One timed region: its name, the ``PageScheduler.process`` call and
    wave its thread served, its id and its parent's (the innermost span its
    thread had open; -1 for none), the thread's native id, start and end on
    ``time.perf_counter_ns``, and its counts. Only a recorded span carries
    the ids and counts; every span carries its clock."""

    __slots__ = ("name", "call", "wave", "id", "parent", "thread", "start_ns", "end_ns",
                 "counts", "_log")

    def __init__(self, name: str, log: SpanLog | None):
        self.name = name
        self._log = log

    def __enter__(self) -> Span:
        if self._log is not None:
            self._log._open(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._log is not None:
            self._log._close(self)

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _Off:
    """The span of a site while nothing records: enters and exits only."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, a, b, c) -> None:
        return None


_OFF = _Off()


class _ThreadState(threading.local):
    """Per thread: the recorded spans it has open, innermost last, its
    native id, and the call and wave its spans carry."""

    call = -1
    wave = -1

    def __init__(self):
        self.stack: list[Span] = []
        self.thread = threading.get_native_id()


class SpanLog:
    """The spans recorded in this process, at most ``cap`` of them, in the
    order they closed."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self.spans: list[Span] = []
        self.dropped = 0
        # (perf_counter_ns, time_ns) read together at the first recorded span
        self.anchor: tuple[int, int] | None = None
        self._ids = itertools.count()
        self._calls = itertools.count()
        self._local = _ThreadState()
        self._lock = threading.Lock()

    def span(self, name: str):
        """A span of ``name`` around the ``with`` body while recording; a
        shared no-op context otherwise."""
        if not _torch_profiler._is_profiler_enabled:
            return _OFF
        return Span(name, self)

    def timed(self, name: str) -> Span:
        """A span whose clock runs whether or not it is recorded: its ``ms``
        is the caller's stage time."""
        return Span(name, self if _torch_profiler._is_profiler_enabled else None)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to ``name`` on the innermost recorded span this thread
        has open (nothing where none is)."""
        if not _torch_profiler._is_profiler_enabled:
            return
        stack = self._local.stack
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n

    def new_call(self) -> int:
        return next(self._calls)

    @contextlib.contextmanager
    def ids(self, call: int, wave: int) -> Iterator[None]:
        """The call and wave that this thread's spans carry in the body."""
        local = self._local
        old = local.call, local.wave
        local.call, local.wave = call, wave
        try:
            yield
        finally:
            local.call, local.wave = old

    def _open(self, s: Span) -> None:
        local = self._local
        stack = local.stack
        if self.anchor is None:
            self.anchor = (time.perf_counter_ns(), time.time_ns())
        s.id = next(self._ids)
        s.parent = stack[-1].id if stack else -1
        s.call, s.wave, s.thread = local.call, local.wave, local.thread
        s.counts = {}
        stack.append(s)

    def _close(self, s: Span) -> None:
        self._local.stack.pop()
        # list.append is atomic; a race past the cap keeps a span or two more
        if len(self.spans) < self.cap:
            self.spans.append(s)
        else:
            with self._lock:
                self.dropped += 1

    def clear(self) -> None:
        """Forget every recorded span; the next one takes a new anchor."""
        with self._lock:
            self.spans, self.dropped, self.anchor = [], 0, None

    def on_unix_clock(self, spans: list[Span] | None = None) -> list[tuple[Span, int, int]]:
        """``spans`` (default: all) with their start and end in Unix-epoch ns,
        the clock of ``torch.profiler``'s events."""
        spans = self.spans if spans is None else spans
        if not spans:
            return []
        perf, unix = self.anchor
        return [(s, s.start_ns - perf + unix, s.end_ns - perf + unix) for s in spans]


def self_ns(spans: list[Span]) -> dict[int, int]:
    """Each span's self time by id: its duration less its children's (a
    child runs inside its parent, in the parent's thread)."""
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


SPANS = SpanLog()
span, timed, count, span_ids = SPANS.span, SPANS.timed, SPANS.count, SPANS.ids


@dataclass
class StageTimer:
    """Accumulates named stage durations in milliseconds."""

    stages: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Times the body into ``stages[name]``, and logs it as a span."""
        s = timed(name)
        try:
            with s:
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + s.ms

    def as_ms(self) -> dict[str, int]:
        return {k: int(v) for k, v in self.stages.items()}


def peak_flops(device: str | torch.device, dtype: torch.dtype) -> float:
    """The published dense peak FLOP/s of the card ``device`` for work in
    ``dtype``: float32 counts at the TF32 rate where cuDNN or cuBLAS may use
    TF32 (``core/dtypes.py`` turns it off for a float32 policy). An unknown
    card, or a device that is no card, raises: no figure is guessed."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"peak_flops: {dev} is not a CUDA device")
    name = torch.cuda.get_device_name(dev)
    peaks = _PEAK_FLOPS.get(name)
    if peaks is None:
        raise ValueError(f"peak_flops: no published peak for the card {name!r}")
    tf32 = torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32
    key = "tf32" if dtype == torch.float32 and tf32 else dtype
    if key not in peaks:
        raise ValueError(f"peak_flops: no published {key} peak for {name!r}")
    return peaks[key]


def power_limit_w(device: str | torch.device) -> float | None:
    """The card's power limit in watts (``nvidia-smi``); None where
    nvidia-smi is not installed."""
    uuid = torch.cuda.get_device_properties(torch.device(device)).uuid
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id=GPU-{uuid}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True,
        ).stdout
    except FileNotFoundError:
        return None
    return float(out.strip().splitlines()[0])


def _device_ms(run: Callable[[], object], dev: torch.device) -> float:
    """CUDA-event ms of _REPS back-to-back calls of ``run`` after one warm
    call, with one synchronise at the end."""
    run()
    torch.cuda.synchronize(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.cuda.device(dev):
        start.record()
        for _ in range(_REPS):
            run()
        end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _flops(runs: list[Callable[[], object]]) -> float:
    """FLOPs of one untimed pass of ``runs`` as ``FlopCounterMode`` counts
    them: convolutions, matmuls and attention; the hand-written kernels
    (and their plain versions) count 0."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        for run in runs:
            run()
    return float(counter.get_total_flops())


def det_rec_breakdown(engine, pages) -> dict:
    """Per-stage wall and device time, FLOPs and MFU of one wave of
    ``PageImage``s through ``engine`` (a ``TorchOCREngine``).

    The wave runs once through ``det_stage`` and ``rec_stage`` (wall times).
    Then the det forward is re-run on the wave's canvases, re-packed to the
    wire and already on the device, and the wave's rec dispatches (stashed by
    the recognizers while the wave ran: closures over device tensors only)
    are re-run: one warm pass, then _REPS timed by CUDA events. FLOPs come
    from ``FlopCounterMode`` over one untimed pass of each; MFU is FLOPs over
    device seconds over ``peak_flops`` for the model's compute dtype.

    On an engine on the CPU it returns the wall times and the FLOP counts
    only: a CPU time is never reported under a device metric's name. A wave
    split over dp (a mesh of more than one device) raises: its shards' device
    times are not one device's. ``mfu_error`` says why the device figures are
    missing where the detector keeps no canvas stack (the classical one).
    """
    from ocr_system_tpu_torch.core.dtypes import resolve_device
    from ocr_system_tpu_torch.core.mesh import ShardedBatch

    dev = resolve_device(engine.recognizer.device)  # a "cuda" engine without a card raises
    timer = StageTimer()
    with timer.stage("det_wall"):
        dets = engine.det_stage(pages)
    if dets and isinstance(dets[0].canvas_stack, ShardedBatch):
        raise ValueError("det_rec_breakdown: the wave is split over dp; time it on one device")

    recs = {id(r): r for r in (engine.recognizer, getattr(engine, "devanagari", None))
            if r is not None}
    stash: list[Callable[[], object]] = []
    for r in recs.values():
        r._profile_stash = stash
    try:
        with timer.stage("rec_wall"):
            engine.rec_stage(pages, dets)
    finally:
        for r in recs.values():
            r._profile_stash = None

    out: dict = {"wave_pages": len(pages)}
    det = getattr(engine.detector, "neural", engine.detector)
    on_card = dev.type == "cuda"
    out["device"] = torch.cuda.get_device_name(dev) if on_card else str(dev)
    out["power_limit_w"] = power_limit_w(dev) if on_card else None
    canvas = dets[0].canvas_stack if dets else None
    if canvas is None or not hasattr(det, "_forward_device"):
        out["mfu_error"] = f"{type(det).__name__} keeps no device canvas stack"
    else:
        batch = canvas.shape[0]
        wire = det._pack_wire(canvas.cpu().numpy())
        x = torch.from_numpy(wire).to(det.device)

        def det_run():
            return det._forward_device(x, det.model)

        det_flops = _flops([det_run])
        out["det_flops"] = det_flops
        out["det_wave_tflops"] = round(det_flops / 1e12, 3)
        if on_card:
            timer.stages["det_device_total"] = _device_ms(det_run, dev)
            timer.stages["det_device"] = timer.stages["det_device_total"] / _REPS
            det_dev_s = timer.stages["det_device"] / 1000.0
            out["det_mfu"] = round(
                det_flops / det_dev_s / peak_flops(dev, det.model.policy.compute_dtype), 4)
            out["det_compute_pages_per_s"] = round(batch / det_dev_s, 2)
        if stash:
            rec_flops = _flops(stash)
            out["rec_flops"] = rec_flops
            out["rec_wave_tflops"] = round(rec_flops / 1e12, 3)
            if on_card:
                def rec_run():
                    for run in stash:
                        run()

                timer.stages["rec_device_total"] = _device_ms(rec_run, dev)
                timer.stages["rec_device"] = timer.stages["rec_device_total"] / _REPS
                out["rec_mfu"] = round(
                    rec_flops / (timer.stages["rec_device"] / 1000.0)
                    / peak_flops(dev, engine.recognizer.model.policy.compute_dtype), 4)
        if on_card:
            # compute-only throughput: device det forward + device rec
            # dispatches (rec wall, an upper bound, where none was stashed)
            rec_s = (timer.stages.get("rec_device", 0.0)
                     or timer.stages.get("rec_wall", 0.0)) / 1000.0
            out["compute_pages_per_s"] = round(len(pages) / (det_dev_s + rec_s), 2)
    stash.clear()  # the closures hold the wave's stacks on the device
    out.update({k: round(v / 1000.0, 6) for k, v in timer.stages.items()})
    return out


def device_memory_stats() -> list[dict]:
    """Per CUDA device: its name and memory (``torch.cuda``: bytes
    allocated by tensors, their peak, the device's free and total bytes);
    an empty list without a card."""
    out = []
    for i in range(torch.cuda.device_count()):
        entry = {"device": f"cuda:{i}", "name": torch.cuda.get_device_name(i),
                 "platform": "gpu"}
        try:
            free, total = torch.cuda.mem_get_info(i)
            entry.update({
                "bytes_in_use": torch.cuda.memory_allocated(i),
                "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                "bytes_free": free,
                "bytes_limit": total,
            })
        except Exception:
            entry["memory_stats"] = "unavailable"
        out.append(entry)
    return out
