"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc; elsewhere they skip. On the card
(whose Python has no jax, which tests/conftest.py imports):
    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ocr_system_tpu_torch.kernels import crop, enhance

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU runs the plain versions only")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 480, 100), (3, 37, 45)])
def test_enhance_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(0)
    gray = torch.from_numpy(rng.random(shape, np.float32)).to(cuda)
    rgb = torch.from_numpy(rng.random((*shape, 3), np.float32)).to(cuda)
    before = enhance.LAUNCHES.value
    assert (enhance.enhance_gray(gray) - enhance.enhance_gray_plain(gray)).abs().max() < 1e-5
    assert (enhance.fused_enhance(rgb) - enhance.fused_enhance_plain(rgb)).abs().max() < 1e-5
    torch.cuda.synchronize()
    assert enhance.LAUNCHES.value == before + 2


@pytest.mark.parametrize(
    "rows,cols,n,width",
    [(256, 256, 7, 320), (48, 320, 3, 160), (960, 960, 40, 640), (960, 960, 40, 1280)],
)
def test_crop_kernel_matches_plain(cuda, rows, cols, n, width):
    rng = np.random.default_rng(1)
    pages = torch.from_numpy(rng.integers(0, 256, (2, rows, cols), np.uint8)).to(cuda)
    x0 = rng.uniform(-20, cols, (2, n))
    y0 = rng.uniform(-10, rows, (2, n))
    h = rng.uniform(8, 300, (2, n))
    aabbs = np.stack([x0, y0, x0 + h * width / 48, y0 + h], -1).astype(np.float32)
    wv = rng.integers(16, width + 1, (2, n)).astype(np.int32)
    args = (pages, torch.from_numpy(aabbs).to(cuda), torch.from_numpy(wv).to(cuda), (48, width))
    before = crop.LAUNCHES.value
    assert (crop.crop_boxes(*args) - crop.crop_boxes_plain(*args)).abs().max() < 1e-5
    torch.cuda.synchronize()
    assert crop.LAUNCHES.value == before + 1


def test_wrappers_reject_bad_inputs(cuda):
    with pytest.raises(ValueError):
        enhance.enhance_gray(torch.zeros((1, 8, 8), dtype=torch.float64, device=cuda))
    pages = torch.zeros((1, 8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        crop.crop_boxes(pages, torch.zeros((1, 2, 4), device=cuda),
                        torch.ones((1, 2), dtype=torch.int64, device=cuda), (48, 80))
