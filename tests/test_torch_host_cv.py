"""The port's host image operations against OpenCV and the JAX package's
native op: the adaptive thresholds, the dilation, the float64 resize and
connected components in both label orders, bit for bit on seeded
inputs."""

import cv2
import numpy as np
import pytest
import torch

from ocr_system_tpu.native import cc_label as jax_cc
from ocr_system_tpu_torch.engine import host_image
from ocr_system_tpu_torch.native import cc_label

torch.set_num_threads(1)


def _page(h: int, w: int, seed: int) -> np.ndarray:
    """A light page with dark word-like bars and noise, (h, w) uint8."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 230, np.int32)
    for _ in range(h * w // 150):
        y, x = rng.integers(0, max(h - 10, 1)), rng.integers(0, max(w - 20, 1))
        img[y:y + rng.integers(2, 10), x:x + rng.integers(2, 20)] = rng.integers(0, 120)
    return np.clip(img + rng.integers(-20, 20, img.shape), 0, 255).astype(np.uint8)


def _noise(h: int, w: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)


# widths cover OpenCV's vector tails: multiples of 8, + 4, and odd remainders
SHAPES = [(240, 200), (301, 401), (97, 742), (960, 742), (45, 7), (33, 13), (64, 37)]
METHODS = {"gaussian": cv2.ADAPTIVE_THRESH_GAUSSIAN_C, "mean": cv2.ADAPTIVE_THRESH_MEAN_C}


@pytest.mark.parametrize("n", [11, 31, 51])
def test_gaussian_kernel_matches_cv2(n):
    want = cv2.getGaussianKernel(n, 0, ktype=cv2.CV_32F).ravel()
    assert np.array_equal(host_image.gaussian_kernel_f32(n), want)


@pytest.mark.parametrize("kind", ["page", "noise"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("method", sorted(METHODS))
def test_adaptive_threshold_matches_cv2(method, shape, kind):
    seed = shape[0] * 7 + shape[1]
    gray = _page(*shape, seed) if kind == "page" else _noise(*shape, seed)
    want = cv2.adaptiveThreshold(gray, 255, METHODS[method], cv2.THRESH_BINARY_INV, 31, 15) > 0
    got = host_image.adaptive_threshold(gray, method, 31, 15)
    assert got.dtype == np.uint8
    assert np.array_equal(got.astype(bool), want)


@pytest.mark.parametrize("shape", [(60, 37), (40, 200), (50, 742)], ids=str)
def test_gaussian_blur_exact_at_every_pixel(shape):
    """The float32 recomputation that settles near-tie pixels equals
    OpenCV's float32 blur everywhere, vector body and tails alike."""
    gray = _noise(*shape, 3)
    want = cv2.GaussianBlur(gray.astype(np.float32), (31, 31), 0,
                            borderType=cv2.BORDER_REPLICATE)
    ys, xs = np.nonzero(np.ones(shape, bool))
    got = host_image._gaussian_exact(gray, host_image.gaussian_kernel_f32(31), ys, xs)
    assert np.array_equal(got.reshape(shape), want)


@pytest.mark.parametrize("density", [0.01, 0.1, 0.4])
@pytest.mark.parametrize("size", [(1, 2), (1, 3), (1, 4), (1, 7), (1, 8), (3, 3), (4, 4), (5, 5)],
                         ids=str)
def test_dilate_matches_cv2(size, density):
    mask = (np.random.default_rng(int(density * 100)).random((123, 157)) < density).astype(np.uint8)
    want = cv2.dilate(mask, np.ones(size, np.uint8), iterations=1)
    assert np.array_equal(host_image.dilate(mask, size), want)


@pytest.mark.parametrize("shape", [(960, 742), (512, 512), (300, 200), (1000, 1300), (97, 313),
                                   (1100, 850)], ids=str)
def test_resize_linear_f64_matches_cv2(shape):
    """The classical skew estimate's float64 luma to 256 x 256 (down, up,
    and an exact 2x)."""
    rgb = np.random.default_rng(shape[0]).integers(0, 256, (*shape, 3)).astype(np.uint8)
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    got = host_image.resize_linear(luma, (256, 256))
    assert np.array_equal(got, cv2.resize(luma, (256, 256)))


CC_CASES = [((301, 401), 0.3), ((301, 401), 0.5), ((301, 401), 0.6), ((960, 742), 0.45),
            ((1000, 1300), 0.55), ((7, 5), 0.5), ((1, 9), 0.5)]


@pytest.mark.parametrize("shape,density", CC_CASES, ids=str)
def test_cc_raster_order_matches_native(shape, density):
    mask = (np.random.default_rng(shape[0] + int(density * 10)).random(shape) < density).astype(np.uint8)
    labels, n = cc_label.label(mask)
    want, want_n = jax_cc.label(mask)
    assert n == want_n and np.array_equal(labels, want)
    counts, bboxes = cc_label.stats(labels, n)
    want_counts, _, want_boxes = jax_cc.stats(want, mask.astype(np.float32), want_n)
    assert np.array_equal(counts[1:], want_counts[1:])
    assert np.array_equal(bboxes[1:], want_boxes[1:])


@pytest.mark.parametrize("shape,density", CC_CASES, ids=str)
def test_cc_cv2_order_matches_cv2(shape, density):
    mask = (np.random.default_rng(shape[1] + int(density * 10)).random(shape) < density).astype(np.uint8)
    labels, n = cc_label.label_cv2(mask)
    n_all, want, st, _ = cv2.connectedComponentsWithStats(mask, connectivity=8)
    assert n == n_all - 1 and np.array_equal(labels, want)
    counts, bboxes = cc_label.stats(labels, n)
    assert np.array_equal(counts[1:], st[1:, cv2.CC_STAT_AREA])
    x, y = st[1:, cv2.CC_STAT_LEFT], st[1:, cv2.CC_STAT_TOP]
    x1, y1 = x + st[1:, cv2.CC_STAT_WIDTH] - 1, y + st[1:, cv2.CC_STAT_HEIGHT] - 1
    assert np.array_equal(bboxes[1:], np.stack([x, y, x1, y1], 1))


def test_cc_orders_differ_on_a_page_mask():
    """The two orders are different functions on a real ink mask (so each
    caller needs its own): the adaptive mask of a seeded page."""
    mask = host_image.adaptive_threshold(_page(301, 401, 5), "mean")
    a, n = cc_label.label(mask)
    b, m = cc_label.label_cv2(mask)
    assert n == m > 100 and not np.array_equal(a, b)
    assert np.array_equal(a > 0, b > 0)
