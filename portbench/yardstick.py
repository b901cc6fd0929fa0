"""The benchmark's own arithmetic: the card's published peaks, rates over
a window, percentiles, busy time from device intervals, the bytes a kernel
launch needs (worked out from its shapes and boxes), and the useful model FLOPs of served work, counted on the
reference models in ``reference/``.

Nothing here reads the program: a later change to a kernel or a model
cannot move the yardstick.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.reference import models as M

# Published dense peaks (NVIDIA's data sheets, no sparsity) by the name
# torch.cuda.get_device_name gives; "NVIDIA H100 80GB HBM3" is the SXM part.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default)."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def closed_loop_rate(calls: list[tuple[float, float, int]], deadline: float) -> tuple[float, int, float]:
    """Back-to-back calls (start, end, items): the items of every call that
    began before ``deadline`` over the time from the first start to the
    last such call's end. Returns (rate, items, seconds)."""
    kept = [c for c in calls if c[0] < deadline]
    if not kept:
        return math.nan, 0, 0.0
    seconds = max(c[1] for c in kept) - min(c[0] for c in kept)
    items = sum(c[2] for c in kept)
    return items / seconds, items, seconds


def union_seconds(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The gaps in [lo, hi] where no interval runs."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def launch_bytes(launch: dict) -> int:
    """What a launch has to move at least: each byte of its tensor inputs
    read once and each byte of its output written once."""
    return int(sum(launch["in_bytes"]) + launch["out_bytes"])


def crop_launch_bytes(launch: dict) -> int:
    """What a crop launch has to move at least, from the shapes and boxes
    it was given: every crop written once at its output type; of each
    crop with columns to fill (``w_valid`` > 0), the page pixels its
    bilinear taps can reach read once: per axis the fewer of the box's
    pixel span (its extent and the next pixel, clipped to the page) and
    two taps per output sample; the boxes and widths read once."""
    (_, rows, cols), page_b = launch["pages"]
    (n_out, out_h, out_w), out_b = launch["out"]
    boxes = np.asarray(launch["aabbs"], np.float64).reshape(-1, 4)
    w_valid = np.asarray(launch["w_valid"], np.int64).reshape(-1)
    x0 = np.clip(np.floor(boxes[:, 0]), 0, cols - 1)
    x1 = np.clip(np.floor(boxes[:, 2]) + 1, 0, cols - 1)
    y0 = np.clip(np.floor(boxes[:, 1]), 0, rows - 1)
    y1 = np.clip(np.floor(boxes[:, 3]) + 1, 0, rows - 1)
    taps_x = np.minimum(np.maximum(x1 - x0 + 1, 1), 2 * w_valid)
    taps_y = np.minimum(np.maximum(y1 - y0 + 1, 1), 2 * out_h)
    read = float(np.where(w_valid > 0, taps_x * taps_y, 0).sum()) * page_b
    written = n_out * out_h * out_w * out_b
    return int(read + written + boxes.size * 4 + w_valid.size * 4)


# ---- useful model FLOPs, counted on the reference models by shape ----

def _meta_state(path: str) -> dict[str, torch.Tensor]:
    with np.load(path) as z:
        return {k.removesuffix(":bf16"): torch.empty(z[k].shape, device="meta")
                for k in z.files}


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


@functools.lru_cache(maxsize=None)
def dbnet_flops(weights: str, side: int) -> int:
    """One page's DBNet forward at a (side, side) canvas."""
    sd = _meta_state(weights)
    return _count(lambda: M.dbnet_prob(sd, torch.empty(1, 3, side, side, device="meta")))


@functools.lru_cache(maxsize=None)
def svtr_flops(weights: str, width: int) -> int:
    """One crop's recognizer forward at its width bucket."""
    sd = _meta_state(weights)
    x = torch.empty(1, 3, 48, width, device="meta")
    return _count(lambda: M.svtr_logits(sd, x, torch.full((1,), width, device="meta")))

