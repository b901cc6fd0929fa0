"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc; elsewhere they skip. On the card
(whose Python has no jax, which tests/conftest.py imports):
    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ocr_system_tpu_torch.kernels import crop, enhance
from ocr_system_tpu_torch.utils.smoke import bf16_agrees, bf16_disagreement

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the CPU runs the plain versions only")
    return torch.device("cuda")


def _assert_close(got, ref):
    """float32 within 1e-5; bf16 under the shared bf16 rule."""
    if got.dtype == torch.bfloat16:
        assert bf16_agrees(got, ref), bf16_disagreement(got, ref)
    else:
        assert (got - ref).abs().max() < 1e-5


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 480, 100), (3, 37, 45)])
def test_enhance_kernel_matches_plain(cuda, shape, out_dtype):
    rng = np.random.default_rng(0)
    gray = torch.from_numpy(rng.integers(0, 256, shape, np.uint8)).to(cuda)
    means = enhance.gray_means(gray)
    rgb = torch.from_numpy(rng.random((*shape, 3), np.float32)).to(cuda)
    before = enhance.LAUNCHES.value
    got = enhance.enhance_gray(gray, means, out_dtype)
    assert got.dtype == out_dtype and got.shape == (shape[0], 3, *shape[1:])
    _assert_close(got, enhance.enhance_gray_plain(gray, means))
    got = enhance.fused_enhance(rgb, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == rgb.shape
    _assert_close(got, enhance.fused_enhance_plain(rgb))
    torch.cuda.synchronize()
    assert enhance.LAUNCHES.value == before + 2


@pytest.mark.parametrize("out_dtype", DTYPES, ids=str)
@pytest.mark.parametrize(
    "rows,cols,n,width",
    [(256, 256, 7, 320), (48, 320, 3, 160), (960, 960, 40, 640), (960, 960, 40, 1280),
     (256, 256, 7, 100), (37, 45, 5, 45)],
)
def test_crop_kernel_matches_plain(cuda, rows, cols, n, width, out_dtype):
    rng = np.random.default_rng(1)
    pages = torch.from_numpy(rng.integers(0, 256, (2, rows, cols), np.uint8)).to(cuda)
    x0 = rng.uniform(-20, cols, (2, n))
    y0 = rng.uniform(-10, rows, (2, n))
    h = rng.uniform(8, 300, (2, n))
    aabbs = np.stack([x0, y0, x0 + h * width / 48, y0 + h], -1).astype(np.float32)
    wv = rng.integers(16, width + 1, (2, n)).astype(np.int32)
    args = (pages, torch.from_numpy(aabbs).to(cuda), torch.from_numpy(wv).to(cuda), (48, width))
    before = crop.LAUNCHES.value
    got = crop.crop_boxes(*args, out_dtype)
    assert got.dtype == out_dtype
    _assert_close(got, crop.crop_boxes_plain(*args))
    torch.cuda.synchronize()
    assert crop.LAUNCHES.value == before + 1


def test_wrappers_reject_bad_inputs(cuda):
    means = torch.zeros(1, device=cuda)
    with pytest.raises(ValueError):
        enhance.enhance_gray(torch.zeros((1, 8, 8), dtype=torch.float64, device=cuda), means)
    with pytest.raises(ValueError):  # the detector's entry takes the u8 canvas
        enhance.enhance_gray(torch.zeros((1, 8, 8), device=cuda), means)
    gray = torch.zeros((1, 8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        enhance.enhance_gray(gray, means, torch.float16)
    with pytest.raises(ValueError):
        enhance.fused_enhance(torch.zeros((1, 8, 8, 3), device=cuda), out_dtype=torch.float16)
    pages = torch.zeros((1, 8, 8), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        crop.crop_boxes(pages, torch.zeros((1, 2, 4), device=cuda),
                        torch.ones((1, 2), dtype=torch.int64, device=cuda), (48, 80))
    with pytest.raises(ValueError):
        crop.crop_boxes(pages, torch.zeros((1, 2, 4), device=cuda),
                        torch.ones((1, 2), dtype=torch.int32, device=cuda), (48, 80),
                        torch.float16)
