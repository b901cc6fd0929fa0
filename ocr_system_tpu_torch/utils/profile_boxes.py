"""Host time of the detector's component-overflow fallback,
``ops.boxes.boxes_from_prob_map``, on a page whose words are tilted, so
that most components take the slow path (hull and rotating calipers).

    PYTHONPATH=. python3 ocr_system_tpu_torch/utils/profile_boxes.py

Times the ``ocr_system_tpu_torch`` package found first on the path; point
``PYTHONPATH`` at another checkout to time its copy on the same page. The
page is the 16-level probability map the fallback reads (240 x 240, the
960 bucket at stride 4), seeded: ``--words`` tilted bars of word size.
Prints one JSON line: the package's path, the fast/slow component split,
the box count and the wall times of ``--reps`` calls (the first warms
imports and caches). Runs on the CPU only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def tilted_page(words: int, seed: int, size: int = 240) -> np.ndarray:
    """A (size, size) float32 map in 16 levels with ``words`` bars tilted
    by up to ±35 degrees, 8-30 px long and 2-4 px thick."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    prob = np.zeros((size, size), np.float32)
    for _ in range(words):
        cx, cy = rng.uniform(12, size - 12, 2)
        ang = rng.uniform(-0.6, 0.6)
        half_len, half_thick = rng.uniform(4, 15), rng.uniform(1, 2)
        u = (xx - cx) * np.cos(ang) + (yy - cy) * np.sin(ang)
        v = (yy - cy) * np.cos(ang) - (xx - cx) * np.sin(ang)
        prob[(np.abs(u) < half_len) & (np.abs(v) < half_thick)] = rng.integers(11, 16) / 15.0
    return prob


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--words", type=int, default=150)
    ap.add_argument("--reps", type=int, default=11)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    from ocr_system_tpu_torch.ops import boxes

    prob = tilted_page(args.words, args.seed)
    times = []
    for _ in range(args.reps):
        t = time.perf_counter()
        found = boxes.boxes_from_prob_map(prob, bin_thresh=0.3, scale_xy=(4.0, 4.0))
        times.append((time.perf_counter() - t) * 1e3)
    fast, slow, _ = boxes.boxes_from_prob_map.last_split
    warm = sorted(times[1:])
    print(json.dumps({
        "package": boxes.__file__, "fast": fast, "slow": slow, "boxes": len(found),
        "median_ms": warm[len(warm) // 2], "min_ms": warm[0], "first_ms": times[0],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
