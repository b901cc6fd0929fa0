"""The batch ink expansion: the ctypes binding of ``ink_walk.cpp`` (the
port's copy of the JAX package's native op). Its plain version is
``native/plain.ink_expand_batch``, the Python walk on each quad."""

from __future__ import annotations

import numpy as np

from ocr_system_tpu_torch.kernels._build import LaunchCounter
from ocr_system_tpu_torch.native.build import library

CALLS = {"ink_expand_batch": LaunchCounter()}


def ink_expand_batch(gray: np.ndarray, quads: np.ndarray, max_walk_ratio: float = 1.2
                     ) -> np.ndarray:
    """Expand-only ink walk for a page's axis-aligned quads in one native
    call, without the GIL (the semantics of
    ``detector._ink_snap(expand_only=True)``).

    gray: (H, W) uint8. quads: (N, 4, 2) float32, modified IN PLACE
    (also returned). Quads must be axis-aligned; the caller filters."""
    if quads.size == 0:
        return quads
    g = np.ascontiguousarray(gray, dtype=np.uint8)
    q = np.ascontiguousarray(quads, dtype=np.float32)
    lib = library()
    CALLS["ink_expand_batch"].add()
    lib.ink_expand_batch(g.ctypes.data, g.shape[0], g.shape[1], q.ctypes.data, q.shape[0],
                         max_walk_ratio)
    if q is not quads:
        quads[...] = q
    return quads
