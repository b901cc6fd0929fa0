"""Hybrid detection: neural DBNet ∪ classical CV, deduplicated by
containment (port of ocr_system_tpu/engine/hybrid_detector.py; the
serving default, ``ocr_engine="hybrid"``).

DBNet proposes boxes, the classical detector proposes boxes, and the
union goes to the recognizer: a classical box survives only where no
neural box contains it (containment >= IOU_DEDUP), with its score capped
below confident neural boxes. The two detectors fail differently (DBNet
misses styles outside its training data, classical merging misses
low-contrast ink), so the union trades a little precision for recall.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.engine.classical_detector import ClassicalDetector
from ocr_system_tpu_torch.engine.detector import Detector, DetResult
from ocr_system_tpu_torch.ops.boxes import DetectedBox

IOU_DEDUP = 0.5  # containment above this: keep the neural box only
# (same-word containment measures 0.8-1.0; different-word neighbors <0.3)
CLASSICAL_SCORE_CAP = 0.6


def _aabb(quad: np.ndarray) -> tuple[float, float, float, float]:
    return (
        float(quad[:, 0].min()), float(quad[:, 1].min()),
        float(quad[:, 0].max()), float(quad[:, 1].max()),
    )


def _iou(a, b) -> float:
    """Intersection over the SMALLER area (containment), not classic IoU:
    the two detectors pad asymmetrically, so one word's classical box can
    sit almost wholly inside its neural box at a classic IoU under 0.4."""
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix = max(min(ax1, bx1) - max(ax0, bx0), 0.0)
    iy = max(min(ay1, by1) - max(ay0, by0), 0.0)
    inter = ix * iy
    if inter <= 0:
        return 0.0
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_b = (bx1 - bx0) * (by1 - by0)
    return inter / max(min(area_a, area_b), 1e-6)


def merge_boxes(
    neural: list[DetectedBox], classical: list[DetectedBox],
    iou_thresh: float = IOU_DEDUP, max_boxes: int = 512,
) -> list[DetectedBox]:
    """Union with neural-wins dedup, sorted by score (stable: ties keep
    neural order, then classical order)."""
    out = list(neural)
    n_aabbs = [_aabb(b.quad) for b in neural]
    for cb in classical:
        ca = _aabb(cb.quad)
        if all(_iou(ca, na) < iou_thresh for na in n_aabbs):
            # classical scores are heuristic fill-ins: never above a
            # confident neural box
            out.append(DetectedBox(quad=cb.quad, score=min(cb.score, CLASSICAL_SCORE_CAP)))
    out.sort(key=lambda b: -b.score)
    return out[:max_boxes]


class HybridDetector:
    """Same detect_batch contract as engine.detector.Detector."""

    def __init__(self, settings: Settings | None = None,
                 neural: Detector | None = None,
                 device: str | torch.device | None = None):
        self.settings = settings or get_settings()
        self.neural = neural or Detector(self.settings, device=device)
        self.classical = ClassicalDetector(self.settings)
        # wall ms of the last detect_batch's two passes
        self.stage_ms: dict[str, float] = {}

    def detect_batch(self, pages: list[np.ndarray]) -> list[DetResult]:
        t = time.perf_counter()
        neural = self.neural.detect_batch(pages)
        t_classical = time.perf_counter()
        # classical runs on the DESKEWED page the neural pass produced, so
        # both box sets live in one frame (unless the classical pass finds
        # a skew there too and rotates again, as the reference does)
        classical = self.classical.detect_batch([d.page for d in neural])
        self.stage_ms = {
            "det_neural": (t_classical - t) * 1000.0,
            "det_classical": (time.perf_counter() - t_classical) * 1000.0,
        }
        out: list[DetResult] = []
        for nd, cd in zip(neural, classical):
            boxes = merge_boxes(
                nd.boxes, cd.boxes, max_boxes=self.settings.max_boxes_per_page
            )
            out.append(DetResult(
                boxes=boxes,
                skew_angle=nd.skew_angle,
                page=nd.page,
                canvas_stack=nd.canvas_stack,
                canvas_row=nd.canvas_row,
                canvas_scale=nd.canvas_scale,
                gray=nd.gray,
                cc=nd.cc,
            ))
        return out
