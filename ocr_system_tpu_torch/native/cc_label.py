"""Connected components with 8-connectivity, in numpy and scipy (the JAX
package's native/cc_label.py binds a C++ op; its cv2 callers use
``cv2.connectedComponentsWithStats``).

Two label orders, because the two callers see different ones:

- ``label``: raster order of each component's first pixel, the native
  op's order (``engine/classical_detector.py``). ``scipy.ndimage.label``
  with a 3 x 3 structure numbers components the same way.
- ``label_cv2``: OpenCV's order (``engine/selection_marks.py``). Its
  8-connected labeling scans 2 x 2 blocks, row pairs top to bottom, blocks
  left to right, and numbers a component at the first block that holds one
  of its pixels. The foreground pixels of one block are all 8-adjacent, so
  no two components share a block and that order is total.

``stats`` gives per-label pixel counts and inclusive bounding boxes from
``np.bincount`` and ``ndimage.find_objects``.
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


def stats(labels: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (counts (n + 1,) int64, bboxes (n + 1, 4) int32 as x0, y0, x1, y1
    inclusive); row 0 is the background (its bbox stays zero)."""
    counts = np.bincount(labels.reshape(-1), minlength=n + 1).astype(np.int64)
    bboxes = np.zeros((n + 1, 4), np.int32)
    for i, sl in enumerate(ndimage.find_objects(labels, max_label=n), start=1):
        if sl is not None:
            bboxes[i] = (sl[1].start, sl[0].start, sl[1].stop - 1, sl[0].stop - 1)
    return counts, bboxes
