"""The classical detector's ink mask on the CPU: the ink-mask kernel's plain
version (``kernels/ink_mask.ink_mask_pages_plain``: OpenCV's float32
Gaussian at every pixel, no tie repair) equals the host mask
``classical_detector._ink_mask`` (a float64 blur whose near-tie pixels are
recomputed in float32) bit for bit, on committed forms upright and turned,
on a page of rounding ties, at every width class of OpenCV's vector loops
and below the block's size; the wrapper runs the plain version on CPU
tensors and refuses what the kernel does not take; the classical detector
masks on the host without a device and through the wrapper on a CUDA
device. The kernel itself is held against both on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch
from scipy import ndimage

from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine import classical_detector
from ocr_system_tpu_torch.engine.classical_detector import ClassicalDetector
from ocr_system_tpu_torch.engine import host_image
from ocr_system_tpu_torch.engine.host_image import rotate_cubic
from ocr_system_tpu_torch.kernels import ink_mask
from ocr_system_tpu_torch.utils import smoke
from ocr_system_tpu_torch.utils.profiler import SPANS

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def forms():
    return smoke.smoke_forms()[0]


def _luma(page: np.ndarray) -> np.ndarray:
    return classical_detector._luma_f64(page).astype(np.uint8)


def _rgb_of_luma() -> np.ndarray:
    """For each luma L, an RGB triple (L, L, L + d) whose float64 luma
    truncates to L (a gray triple gives L - 1 for 65 of the 256 levels)."""
    table = np.zeros((256, 3), np.uint8)
    for lum in range(256):
        for d in range(12):
            t = np.array([[[lum, lum, min(lum + d, 255)]]], np.uint8)
            if _luma(t)[0, 0] == lum:
                table[lum] = t[0, 0]
                break
        else:
            raise AssertionError(f"no triple of luma {lum}")
    return table


RGB_OF_LUMA = _rgb_of_luma()


def tie_page(h: int, w: int, seed: int) -> np.ndarray:
    """An (H, W, 3) page on which the rounding of the Gaussian mean decides
    the mask almost everywhere: a checkerboard of two lumas 29 apart, whose
    31-tap mean lies a hair from their midpoint, so a dark pixel sits 14.5
    below it, between ink (-15) and paper (-14) as the mean rounds. Seeded
    levels in 80-pixel blocks and seeded strokes vary the sums."""
    rng = np.random.default_rng(seed)
    levels = rng.integers(20, 200, (h // 80 + 1, w // 80 + 1))
    y, x = np.mgrid[:h, :w]
    luma = levels[y // 80, x // 80] + 29 * ((y + x) % 2)
    for _ in range(max(h * w // 4000, 1)):
        r, c = rng.integers(0, h), rng.integers(0, w)
        luma[r:r + 3, c:c + rng.integers(4, 20)] = rng.integers(0, 40)
    page = RGB_OF_LUMA[luma]
    assert np.array_equal(_luma(page), luma)
    return page


def near_ties(page: np.ndarray) -> int:
    """Pixels whose float64 Gaussian mean lies within the host mask's tie
    margin of a half: the ones it recomputes in float32."""
    k = ink_mask.TAPS.astype(np.float64)
    blur = ndimage.correlate1d(_luma(page).astype(np.float64), k, axis=1, mode="nearest")
    blur = ndimage.correlate1d(blur, k, axis=0, mode="nearest")
    return int((np.abs(blur - np.floor(blur) - 0.5) < host_image._TIE_MARGIN).sum())


def assert_plain_is_the_host_mask(page: np.ndarray) -> None:
    got = ink_mask.ink_mask_pages(torch.from_numpy(page))
    want = classical_detector._ink_mask(page)
    assert got.dtype == torch.uint8 and tuple(got.shape) == page.shape[:2]
    assert np.array_equal(got.numpy(), want), int((got.numpy() != want).sum())


@pytest.mark.parametrize("turn", [0.0, 3.0, -3.0])
@pytest.mark.parametrize("form", [0, 3, 6])
def test_plain_is_the_host_mask_on_forms(forms, form, turn):
    page = forms[form] if turn == 0.0 else rotate_cubic(forms[form], turn, fill=255)
    assert_plain_is_the_host_mask(page)


def test_plain_is_the_host_mask_on_a_page_of_ties():
    page = tie_page(240, 328, seed=11)
    assert near_ties(page) > 10_000
    mask = classical_detector._ink_mask(page)
    assert 0 < mask.sum() < mask.size // 2
    assert_plain_is_the_host_mask(page)


@pytest.mark.parametrize("width", [64, 67, 68, 69, 71])  # 0, 3, 4, 5, 7 mod 8
def test_plain_is_the_host_mask_at_every_tail(width):
    """Widths that end OpenCV's row pass in its 4-wide step or its scalar
    tail, and its column pass in the scalar tail, on a page of ties."""
    page = tie_page(45, width, seed=width)
    assert near_ties(page) > 300
    assert_plain_is_the_host_mask(page)


@pytest.mark.parametrize("width", [64, 67, 68, 69, 71])  # 0, 3, 4, 5, 7 mod 8
def test_plain_gaussian_is_opencvs_at_every_pixel(width):
    """The plain version's float32 mean, before rounding, is bit for bit
    the rule that settles the host mask's ties (``_gaussian_exact``,
    held against ``cv2.GaussianBlur`` in tests/test_torch_host_cv.py) at
    every pixel, vector body and both tails."""
    gray = np.random.default_rng(width).integers(0, 256, (40, width)).astype(np.uint8)
    ys, xs = np.nonzero(np.ones(gray.shape, bool))
    want = host_image._gaussian_exact(gray, ink_mask.TAPS, ys, xs).reshape(gray.shape)
    assert np.array_equal(ink_mask._gaussian_f32(gray), want)


@pytest.mark.parametrize("shape", [(20, 27), (5, 3), (1, 1)])
def test_plain_is_the_host_mask_below_the_block(shape):
    """Pages smaller than the 31-pixel block in each axis: every tap past
    the border reads the edge pixel."""
    page = tie_page(*shape, seed=sum(shape))
    assert_plain_is_the_host_mask(page)


def test_wrapper_runs_the_plain_version_on_cpu_and_refuses_bad_pages():
    page = tie_page(40, 52, seed=3)
    before = ink_mask.LAUNCHES.value
    SPANS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with SPANS.span("classical.mask"):
            got = ink_mask.ink_mask_pages(torch.from_numpy(page))
    assert torch.equal(got, ink_mask.ink_mask_pages_plain(torch.from_numpy(page)))
    assert ink_mask.LAUNCHES.value == before
    assert [s.counts for s in SPANS.spans] == [{}]  # no card pages counted
    t = torch.from_numpy(page)
    for bad in (t.float(), t[..., 0], t[..., :2], t[..., :1].expand(40, 52, 4), t[None]):
        with pytest.raises(ValueError):
            ink_mask.ink_mask_pages(bad)


@pytest.fixture
def unskewed(monkeypatch):
    """The classical pass with no skew found, so no turn."""
    monkeypatch.setattr(classical_detector, "_estimate_skew_host", lambda page: 0.0)


def _boxes(res):
    return [(b.quad.tolist(), b.score) for b in res.boxes]


def test_detector_without_a_card_masks_on_the_host(forms, unskewed, monkeypatch):
    """A bare ClassicalDetector (the classical engine's) and one on the CPU
    call the host ``_ink_mask`` and never the kernel's path."""
    host = []

    def refuse(*a, **k):
        raise AssertionError("a host detector reached the ink-mask kernel's path")

    monkeypatch.setattr(classical_detector, "_ink_mask_on_card", refuse)
    monkeypatch.setattr(classical_detector, "ink_mask_pages", refuse)
    real = classical_detector._ink_mask
    monkeypatch.setattr(classical_detector, "_ink_mask",
                        lambda page: host.append(page.shape) or real(page))
    for device in (None, "cpu", torch.device("cpu")):
        (res,) = ClassicalDetector(Settings(), device=device).detect_batch([forms[1]])
        assert res.boxes
    assert host == [forms[1].shape] * 3


def test_detector_on_a_cuda_device_masks_through_the_kernel(forms, unskewed, monkeypatch):
    """On a CUDA device the mask comes from ``_ink_mask_on_card`` on that
    device (faked here: no card), never from the host ``_ink_mask``, and the
    boxes are the host detector's."""
    want = ClassicalDetector(Settings()).detect_batch([forms[2]])
    seen = []
    real = classical_detector._ink_mask

    def card(page, device):
        seen.append(torch.device(device))
        return real(page)

    def refuse(page):
        raise AssertionError("a card detector masked on the host")

    monkeypatch.setattr(classical_detector, "_ink_mask_on_card", card)
    monkeypatch.setattr(classical_detector, "_ink_mask", refuse)
    for device in ("cuda", torch.device("cuda", 0)):
        (res,) = ClassicalDetector(Settings(), device=device).detect_batch([forms[2]])
        assert _boxes(res) == _boxes(want[0])
    assert seen == [torch.device("cuda"), torch.device("cuda", 0)]


def test_the_card_path_hands_the_wrapper_a_contiguous_page(monkeypatch):
    """``_ink_mask_on_card`` gives ``ink_mask_pages`` the page as one
    contiguous (H, W, 3) u8 tensor on the device, whatever the page's
    strides (a channel-last view of planar storage, as the benchmark's
    pages are), and returns its mask as a host (H, W) u8 array."""
    page = tie_page(37, 53, seed=5)
    planar = np.ascontiguousarray(page.transpose(2, 0, 1)).transpose(1, 2, 0)
    assert not planar.flags["C_CONTIGUOUS"]
    got = []
    real = ink_mask.ink_mask_pages

    def wrapper(t):
        got.append((t.device, t.dtype, tuple(t.shape), t.is_contiguous()))
        return real(t)

    monkeypatch.setattr(classical_detector, "ink_mask_pages", wrapper)
    for p in (page, planar):
        mask = classical_detector._ink_mask_on_card(p, "cpu")
        assert isinstance(mask, np.ndarray) and mask.dtype == np.uint8
        assert np.array_equal(mask, classical_detector._ink_mask(page))
    assert got == [(torch.device("cpu"), torch.uint8, (37, 53, 3), True)] * 2
