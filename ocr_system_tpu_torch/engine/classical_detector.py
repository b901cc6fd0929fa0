"""Classical (non-neural) text detection: threshold + morphology + CC (port
of ocr_system_tpu/engine/classical_detector.py, its cv2 branch).

  grayscale -> adaptive Gaussian threshold (ink mask) -> horizontal
  dilation merges characters into word blobs -> connected components ->
  padded boxes -> size/density filtering

All host work on the CPU: ``engine/host_image`` carries OpenCV's
threshold, dilation and float resize bit for bit in numpy and scipy; the
components come from the native op (``native/cc_label``), as in the JAX
package. No trained weights: the deployment fallback when
no DBNet checkpoint is available, and the classical half of the hybrid
detector.
"""

from __future__ import annotations

import numpy as np

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.engine.detector import (
    MAX_DESKEW_DEG,
    MIN_DESKEW_DEG,
    DetResult,
    _rotate_host,
)
from ocr_system_tpu_torch.engine.host_image import (
    adaptive_threshold,
    dilate,
    resize_linear,
)
from ocr_system_tpu_torch.native import cc_label
from ocr_system_tpu_torch.ops.boxes import DetectedBox


class ClassicalDetector:
    """Same detect_batch contract as engine.detector.Detector."""

    def __init__(self, settings: Settings | None = None):
        self.settings = settings or get_settings()

    def detect_batch(self, pages: list[np.ndarray]) -> list[DetResult]:
        return [self._detect_one(p) for p in pages]

    def _detect_one(self, page: np.ndarray) -> DetResult:
        angle = 0.0
        if self.settings.enable_deskew:
            est = _estimate_skew_host(page)
            if MIN_DESKEW_DEG <= abs(est) <= MAX_DESKEW_DEG:
                page = _rotate_host(page, est)
                angle = est
        mask = _ink_mask(page)
        # the glyph-merging kernel follows the page's char height:
        # inter-letter gaps scale with font size, not page width
        char_h = _estimate_char_height(mask)
        mask = _dilate_horizontal(mask, k=max(int(char_h * 0.6), 3))
        boxes = _components_to_boxes(
            mask,
            min_h=6,
            max_h=page.shape[0] // 3,
            max_boxes=self.settings.max_boxes_per_page,
        )
        return DetResult(boxes=boxes, skew_angle=angle, page=page)


def _luma_f64(page: np.ndarray) -> np.ndarray:
    return 0.299 * page[..., 0] + 0.587 * page[..., 1] + 0.114 * page[..., 2]


def _ink_mask(page: np.ndarray) -> np.ndarray:
    """float64 luma truncated to u8, then the adaptive Gaussian threshold
    (block 31, C 15): 1 = ink."""
    return adaptive_threshold(_luma_f64(page).astype(np.uint8), "gaussian", 31, 15)


def _estimate_char_height(mask: np.ndarray) -> float:
    """Median connected-component height of glyph-sized blobs."""
    labels, n = cc_label.label(mask)
    if n == 0:
        return 12.0
    _, _, bboxes = cc_label.stats(labels, mask.astype(np.float32), n)
    heights = (bboxes[1:, 3] - bboxes[1:, 1] + 1).astype(np.float32)
    # glyphs: taller than speckle, shorter than rules/images
    glyph = heights[(heights >= 5) & (heights <= mask.shape[0] / 4)]
    return float(np.median(glyph)) if len(glyph) else 12.0


def _dilate_horizontal(mask: np.ndarray, k: int) -> np.ndarray:
    """Merge adjacent glyphs into word blobs with a (1, k) dilation."""
    return dilate(mask, (1, k))


def _components_to_boxes(
    mask: np.ndarray, min_h: int, max_h: int, max_boxes: int
) -> list[DetectedBox]:
    labels, n = cc_label.label(mask)
    counts, _, bboxes = cc_label.stats(labels, mask.astype(np.float32), n)
    boxes: list[DetectedBox] = []
    for comp in range(1, n + 1):
        x0, y0, x1, y1 = bboxes[comp]
        w, h = x1 - x0 + 1, y1 - y0 + 1
        if h < min_h or h > max_h or w < 3:
            continue
        if counts[comp] < 0.15 * w * h:  # too sparse: ruling lines/noise
            continue
        pad = max(h // 6, 1)
        quad = np.array(
            [
                [x0 - pad, y0 - pad], [x1 + pad, y0 - pad],
                [x1 + pad, y1 + pad], [x0 - pad, y1 + pad],
            ],
            np.float32,
        )
        quad[:, 0] = np.clip(quad[:, 0], 0, mask.shape[1] - 1)
        quad[:, 1] = np.clip(quad[:, 1], 0, mask.shape[0] - 1)
        score = min(counts[comp] / (w * h) + 0.4, 0.95)
        boxes.append(DetectedBox(quad=quad, score=float(score)))
    boxes.sort(key=lambda b: -b.score)
    return boxes[:max_boxes]


def _estimate_skew_host(page: np.ndarray) -> float:
    """Host skew estimate by the FFT shear projection of the device path
    (ops/image_ops.estimate_skew_angle), in numpy on a 256 x 256 copy."""
    n = 256
    small = resize_linear(_luma_f64(page), (n, n))
    ink = (small < small.mean()).astype(np.float32)
    f = np.fft.fft(ink, axis=0)
    angles = np.linspace(-15, 15, 31)
    k = np.fft.fftfreq(n) * n
    x = np.arange(n) - (n - 1) / 2.0
    best, best_score = 0.0, -1.0
    for a in angles:
        phi = (-2.0 * np.pi / n) * np.tan(np.deg2rad(a)) * np.outer(k, x)
        g = (f * np.exp(1j * phi)).sum(axis=1)
        power = np.abs(g) ** 2
        score = power[1:].sum()
        if score > best_score:
            best, best_score = a, score
    return -best
