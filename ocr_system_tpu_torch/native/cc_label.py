"""Connected components with 8-connectivity: the ctypes binding of
``cc_label.cpp`` (the port's copy of the JAX package's native op; the same
functions, signatures and results). ctypes releases the GIL for each
call, so the scheduler's det and rec threads overlap it.

Two label orders, because the two kinds of caller see different ones:

- ``label``: raster order of each component's first pixel
  (``ops/boxes.py``, ``engine/classical_detector.py``, ``engine/script.py``).
- ``label_cv2``: OpenCV's order, which the JAX package's serving branch
  gets from ``cv2.connectedComponentsWithStats`` (``engine/selection_marks.py``):
  ``label``, then ``cc_block_order`` renumbers in place.

``stats`` gives per-label pixel counts, probability sums and inclusive
bounding boxes in one pass; ``analyze`` labels and gathers every statistic
the probability-map box path needs in one call. The numpy/scipy versions of
all four are ``native/plain.py``. ``CALLS`` counts the calls of each native
function.
"""

from __future__ import annotations

import numpy as np

from ocr_system_tpu_torch.kernels._build import LaunchCounter
from ocr_system_tpu_torch.native.build import library

CALLS = {name: LaunchCounter() for name in
         ("cc_label_u8", "cc_block_order", "cc_stats", "cc_analyze_u8")}


def label(binary: np.ndarray) -> tuple[np.ndarray, int]:
    """8-connectivity labeling. binary: (H, W) any int/bool. Returns
    (labels int32 (H, W), n_components), raster order."""
    img = np.ascontiguousarray(binary != 0, dtype=np.uint8)
    h, w = img.shape
    out = np.empty((h, w), dtype=np.int32)
    lib = library()
    CALLS["cc_label_u8"].add()
    n = lib.cc_label_u8(img.ctypes.data, h, w, out.ctypes.data)
    if n < 0:
        raise ValueError("cc_label_u8 failed")
    return out, int(n)


def label_cv2(binary: np.ndarray) -> tuple[np.ndarray, int]:
    """``label`` renumbered in OpenCV's 2 x 2 block order."""
    labels, n = label(binary)
    if n >= 2:
        h, w = labels.shape
        CALLS["cc_block_order"].add()
        if library().cc_block_order(labels.ctypes.data, h, w, n) < 0:
            raise ValueError("cc_block_order failed")
    return labels, n


def stats(labels: np.ndarray, prob: np.ndarray, n: int
          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-component (count, prob_sum, bbox) in one native pass.
    Returns (counts (n+1,), sums (n+1,), bboxes (n+1, 4) x0,y0,x1,y1)."""
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    prob = np.ascontiguousarray(prob, dtype=np.float32)
    if prob.shape != labels.shape:
        raise ValueError(f"stats: prob {prob.shape} is not the labels' {labels.shape}")
    h, w = labels.shape
    counts = np.empty(n + 1, dtype=np.int64)
    sums = np.empty(n + 1, dtype=np.float64)
    bboxes = np.empty((n + 1, 4), dtype=np.int32)
    lib = library()
    CALLS["cc_stats"].add()
    lib.cc_stats(labels.ctypes.data, prob.ctypes.data, h, w, n,
                 counts.ctypes.data, sums.ctypes.data, bboxes.ctypes.data)
    return counts, sums, bboxes


def analyze(binary: np.ndarray, prob: np.ndarray, stride: int = 1, cap: int = 4096
            ) -> tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fused 8-connectivity labeling + per-component statistics in one
    native call (cc_analyze_u8).

    binary: (H, W) 0/1. prob: (ph, pw) float32 sampled at
    (y // stride, x // stride) — pass the full-res probability map with
    stride=1, or the pooled score map with its stride.

    Returns (labels int32 (H, W), n, counts (n+1,) int64,
    score_sums (n+1,) float64, bboxes (n+1, 4) int32 x0,y0,x1,y1,
    moments (n+1, 5) float64 sum_x,sum_y,sum_xx,sum_yy,sum_xy).
    """
    img = np.ascontiguousarray(binary != 0, dtype=np.uint8)
    probf = np.ascontiguousarray(prob, dtype=np.float32)
    h, w = img.shape
    ph, pw = probf.shape
    lib = library()
    labels = np.empty((h, w), dtype=np.int32)
    while True:
        counts = np.empty(cap + 1, dtype=np.int64)
        sums = np.empty(cap + 1, dtype=np.float64)
        bboxes = np.empty((cap + 1, 4), dtype=np.int32)
        moments = np.empty((cap + 1, 5), dtype=np.float64)
        CALLS["cc_analyze_u8"].add()
        n = lib.cc_analyze_u8(img.ctypes.data, h, w, probf.ctypes.data, ph, pw, stride, cap,
                              labels.ctypes.data, counts.ctypes.data, sums.ctypes.data,
                              bboxes.ctypes.data, moments.ctypes.data)
        if n == -2:  # more components than cap — grow and retry
            cap *= 4
            continue
        if n < 0:
            raise ValueError("cc_analyze_u8 failed")
        return labels, n, counts[: n + 1], sums[: n + 1], bboxes[: n + 1], moments[: n + 1]
