"""The smoke workload of chip_smoke.py and utils/profile_wave.py: the
slice's engine with seeded random weights, and synthetic letter pages
(rows of dark word-like bars on white) drawn with numpy from a seed."""

from __future__ import annotations

import numpy as np
import torch

from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.host_image import rotate_cubic
from ocr_system_tpu_torch.engine.pipeline import SLICE_SETTINGS, TorchOCREngine
from ocr_system_tpu_torch.engine.preprocess import PageImage

# Random weights leave DBNet's probability map flat at ~sigmoid(0) = 0.5,
# on det_box_thresh, so whether a page yields its (page-sized) component
# as a box would be a coin flip between runs. Offsetting the head's output
# logit by this much makes the map clear the threshold on every run, so
# every page sends its box through the recognizer.
PROB_LOGIT_OFFSET = 1.0


def build_engine(device, seed: int = 0, **overrides) -> TorchOCREngine:
    """The slice's engine (serving defaults + SLICE_SETTINGS + overrides)
    with seeded random DBNet and SVTR weights at full width."""
    settings = Settings(**{**SLICE_SETTINGS, **overrides})
    engine = TorchOCREngine(settings, device=device)
    with torch.no_grad():
        engine.detector.model.prob_head.up2.bias += PROB_LOGIT_OFFSET
    return engine


def draw_page(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A white page with rows of dark word-like bars, (h, w, 3) uint8."""
    img = np.full((h, w, 3), 248, np.uint8)
    row_h = max(h // 40, 6)
    for y in range(row_h * 2, h - row_h * 2, row_h * 2):
        x = w // 20
        while x < w - w // 10:
            bw = int(rng.integers(w // 40, w // 8))
            img[y:y + row_h, x:min(x + bw, w - w // 20)] = int(rng.integers(10, 60))
            x += bw + int(rng.integers(w // 60, w // 25))
    return img


def letter_pages(n: int, h: int, rotated: int | None, seed: int):
    """n letter-aspect (8.5 x 11) pages of height h; page ``rotated`` is
    turned by 3 degrees so the deskew re-pass runs."""
    rng = np.random.default_rng(seed)
    w = int(round(h * 8.5 / 11.0))
    pages = [draw_page(rng, h, w) for _ in range(n)]
    if rotated is not None:
        pages[rotated] = rotate_cubic(pages[rotated], 3.0)
    return [PageImage(p, i + 1) for i, p in enumerate(pages)]
