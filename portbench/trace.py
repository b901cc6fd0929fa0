"""The device trace of a traced run (``--trace 1``): ``torch.profiler``
(CUPTI) over the whole window, read into device intervals by name, and the
benchmark's own host spans, which name what the host was doing while the
device sat idle. The trace's clock is the wall clock (``time.time``).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import torch

from portbench import yardstick as Y

WINDOW = "portbench.window"
TOP = 10


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernels: list  # (name, start_s, end_s) of every device operation
    spans: list  # (name, start_s, end_s) of the benchmark's host spans
    device_ops: list  # [[name, seconds]], the largest sums by name
    idle_gaps: list  # [[host spans, seconds]], idle time by what the host did


def profiler() -> torch.profiler.profile:
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


def read(prof: torch.profiler.profile, spans: list, clock_offset_s: float) -> DeviceTrace | None:
    """Device operations inside the window annotation, and the host
    ``spans`` (name, start, end on ``time.perf_counter``, from every
    thread) moved onto the trace's clock by ``clock_offset_s``; None when
    the trace holds no window or no device operation."""
    kernels, window = [], None
    spans = [(n, s + clock_offset_s, t + clock_offset_s) for n, s, t in spans]
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if name == WINDOW:
            # the profiler also mirrors the annotation onto the device's
            # timeline: that copy is a span, not a device operation
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                window = (s, t)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append((name, s, t))
    if window is None or not kernels:
        return None
    lo, hi = window
    kernels = [k for k in kernels if k[2] > lo and k[1] < hi]
    busy = Y.union_seconds([(s, t) for _, s, t in kernels], lo, hi)
    by_name: dict[str, float] = defaultdict(float)
    for name, s, t in kernels:
        by_name[name] += min(t, hi) - max(s, lo)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle: dict[str, float] = defaultdict(float)
    gaps = Y.idle_gaps([(s, t) for _, s, t in kernels], lo, hi)
    # sweep the gaps' midpoints in order past the spans' starts and ends
    marks = sorted([(s, 1, n) for n, s, _ in spans] + [(t, -1, n) for n, _, t in spans])
    active: dict[str, int] = defaultdict(int)
    j = 0
    for gs, ge in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (gs + ge) / 2
        while j < len(marks) and marks[j][0] <= mid:
            active[marks[j][2]] += marks[j][1]
            j += 1
        host = sorted(n for n, c in active.items() if c > 0) or ["none"]
        idle["+".join(host)] += ge - gs
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return DeviceTrace(hi - lo, busy, kernels, spans,
                       [[n[:200], v] for n, v in ops], [[n, v] for n, v in gaps])
