"""The smoke workload of chip_smoke.py and utils/profile_wave.py: the
slice's engine with seeded random weights, and synthetic letter pages
(rows of dark word-like bars on white) drawn with numpy from a seed; and
the bf16 agreement rule that chip_smoke.py and the kernel tests share."""

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

# A bf16 kernel output equals its plain version's float32 result rounded to
# bf16, except by at most one bf16 ulp on at most this share of elements:
# float32 results that differ within 1e-5 may straddle a rounding boundary.
BF16_MAX_ULPS = 1.0
BF16_MAX_SHARE = 1e-3


def bf16_disagreement(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """got (bf16) against ref (float32) rounded to bf16: the largest
    distance in bf16 ulps (of the larger magnitude) and the share of
    elements that differ at all."""
    want = ref.float().to(torch.bfloat16).float()
    have = got.float()
    mag = torch.maximum(want.abs(), have.abs()).clamp_min(2.0 ** -126)
    ulps = (have - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(ulps.max()), float((ulps > 0).float().mean())


def bf16_agrees(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """The rule above, for tests and chip_smoke.py."""
    worst, share = bf16_disagreement(got, ref)
    return worst <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE


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
