"""The plain versions of the native host ops, in numpy and scipy: the same
signatures and results as ``native/cc_label.py`` and ``native/ink_walk.py``.
Tests and chip_smoke.py hold the native ops against these; nothing on the
served path calls them.

- ``label``: raster order of each component's first pixel, the native
  op's order. ``scipy.ndimage.label`` with a 3 x 3 structure numbers
  components the same way.
- ``label_cv2``: OpenCV's order. Its 8-connected labeling scans 2 x 2
  blocks, row pairs top to bottom, blocks left to right, and numbers a
  component at the first block that holds one of its pixels. The foreground
  pixels of one block are all 8-adjacent, so no two components share a
  block and that order is total.
- ``stats`` and ``analyze``: per-component counts, sums and inclusive
  bounding boxes (and ``analyze``'s moments) from ``np.bincount`` and
  ``ndimage.find_objects``. Row 0 is the background's, as the native op
  leaves it: count 0, sum 0, bbox (W, H, -1, -1). The sums accumulate in
  float64 in another order than the native op's raster order, so they
  agree to rounding, not bit for bit.
- ``ink_expand_batch``: ``engine/detector._ink_snap(expand_only=True)`` on
  each quad.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

_EIGHT = np.ones((3, 3), np.int32)


def label(binary: np.ndarray) -> tuple[np.ndarray, int]:
    """(H, W) mask (nonzero = foreground) -> (int32 labels, n), raster
    order."""
    labels, n = ndimage.label(np.asarray(binary) != 0, structure=_EIGHT,
                              output=np.int32)
    return labels, int(n)


def label_cv2(binary: np.ndarray) -> tuple[np.ndarray, int]:
    """``label`` renumbered in OpenCV's 2 x 2 block order."""
    labels, n = label(binary)
    if n < 2:
        return labels, n
    h, w = labels.shape
    blocks = np.zeros((h + h % 2, w + w % 2), np.int32)
    blocks[:h, :w] = labels
    # block-major order: (y // 2, x // 2), then the pixels of the block
    flat = blocks.reshape(blocks.shape[0] // 2, 2, blocks.shape[1] // 2, 2)
    flat = flat.transpose(0, 2, 1, 3).reshape(-1)
    pos = np.flatnonzero(flat)
    _, first = np.unique(flat[pos], return_index=True)  # labels 1..n, in turn
    remap = np.zeros(n + 1, np.int32)
    remap[1 + np.argsort(pos[first], kind="stable")] = np.arange(1, n + 1, dtype=np.int32)
    return remap[labels], n


def _bboxes(labels: np.ndarray, n: int) -> np.ndarray:
    h, w = labels.shape
    bboxes = np.tile(np.array([w, h, -1, -1], np.int32), (n + 1, 1))
    for i, sl in enumerate(ndimage.find_objects(labels, max_label=n), start=1):
        if sl is not None:
            bboxes[i] = (sl[1].start, sl[0].start, sl[1].stop - 1, sl[0].stop - 1)
    return bboxes


def stats(labels: np.ndarray, prob: np.ndarray, n: int
          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> (counts (n + 1,) int64, sums of ``prob`` (n + 1,) float64, bboxes
    (n + 1, 4) int32 as x0, y0, x1, y1 inclusive)."""
    labels = np.asarray(labels, np.int32)
    flat = labels.reshape(-1)
    keep = (flat > 0) & (flat <= n)
    ids = flat[keep]
    probs = np.asarray(prob, np.float32).reshape(-1)[keep].astype(np.float64)
    counts = np.bincount(ids, minlength=n + 1).astype(np.int64)
    sums = np.bincount(ids, weights=probs, minlength=n + 1)
    return counts, sums, _bboxes(np.where(labels <= n, labels, 0), n)


def analyze(binary: np.ndarray, prob: np.ndarray, stride: int = 1, cap: int = 4096
            ) -> tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``label`` and per-component statistics, with ``prob`` sampled at
    (y // stride, x // stride) (edge-clamped) -> (labels, n, counts,
    score_sums, bboxes, moments (n + 1, 5) float64 sum_x, sum_y, sum_xx,
    sum_yy, sum_xy). ``cap`` is the native op's first buffer size; the
    result does not depend on it."""
    del cap
    labels, n = label(binary)
    h, w = labels.shape
    prob = np.asarray(prob, np.float32)
    yy = (np.arange(h) // stride).clip(0, prob.shape[0] - 1)
    xx = (np.arange(w) // stride).clip(0, prob.shape[1] - 1)
    counts, sums, bboxes = stats(labels, prob[np.ix_(yy, xx)], n)
    ys, xs = np.nonzero(labels)
    ids = labels[ys, xs]
    xf, yf = xs.astype(np.float64), ys.astype(np.float64)
    moments = np.stack([np.bincount(ids, weights=v, minlength=n + 1)
                        for v in (xf, yf, xf * xf, yf * yf, xf * yf)], axis=1)
    return labels, n, counts, sums, bboxes, moments


def ink_expand_batch(gray: np.ndarray, quads: np.ndarray, max_walk_ratio: float = 1.2
                     ) -> np.ndarray:
    """The expand-only ink walk on each of a page's axis-aligned quads, in
    place (also returned)."""
    from ocr_system_tpu_torch.engine.detector import _ink_snap

    for quad in quads:
        _ink_snap(gray, quad, max_walk_ratio, expand_only=True)
    return quads
