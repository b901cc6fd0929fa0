"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
side runs the Pallas kernels in interpret mode, as tests/test_kernels.py
does. The CUDA kernels themselves are held against the plain versions on
the card (``cuda``-marked tests here, and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_system_tpu.engine.recognizer import _mask_pad
from ocr_system_tpu.kernels.crop_pallas import crop_boxes_matmul
from ocr_system_tpu.kernels.preprocess_pallas import fused_enhance as jax_enhance
from ocr_system_tpu.ops.sampling import crop_boxes_separable
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine import detector as detector_mod
from ocr_system_tpu_torch.engine import recognizer as recognizer_mod
from ocr_system_tpu_torch.kernels import crop, enhance
from ocr_system_tpu_torch.utils.smoke import bf16_agrees, bf16_disagreement

torch.set_num_threads(1)

ATOL = 1e-5
# the Pallas crop in interpret mode on the CPU is itself off the exact
# bilinear value by up to ~1.4e-5 (measured on the first case below, where
# the port equals a float64 evaluation of the same coordinates); against it
# the crop is held at the JAX package's own kernel-test tolerance, and
# against the float64 evaluation at ATOL
CROP_VS_PALLAS_ATOL = 1e-4


# the JAX detector's u8 -> [0, 1] step as XLA compiles it
_jax_unit = jax.jit(lambda g: g.astype(jnp.float32) / 255.0)


def test_to_unit_equals_jitted_jax_division():
    """to_unit is the jitted JAX ``/ 255.0`` bit for bit on every u8 value
    (a true division differs on 126 of them, among them the 4-bit wire
    levels 51, 102, 119, 204, 221 and 238)."""
    g = np.arange(256, dtype=np.uint8)
    ref = np.asarray(_jax_unit(jnp.asarray(g)))
    got = enhance.to_unit(torch.from_numpy(g)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    true_div = (g.astype(np.float32) / np.float32(255.0)).view(np.uint32)
    differs = np.flatnonzero(true_div != ref.view(np.uint32))
    assert len(differs) == 126 and {51, 102, 119, 204, 221, 238} <= set(differs)


def _crop_exact(pages, aabbs, wv, H, W):
    """float64 bilinear evaluation at the kernel's float32 coordinates."""
    P, rows, cols = pages.shape
    boxes = aabbs.reshape(-1, 4)
    out = np.zeros((len(boxes), H, W))

    def axis(lo, hi, n, size):
        s = lo + ((hi - lo) * np.arange(n, dtype=np.float32)) / np.float32(n - 1)
        s = np.clip(s.astype(np.float32), 0, size - 1)
        a = np.floor(s).astype(int)
        return a, np.minimum(a + 1, size - 1), s.astype(np.float64) - a

    for k, (x0, y0, x1, y1) in enumerate(boxes):
        pg = pages[k // aabbs.shape[1]].astype(np.float64) / 255.0
        ya, yb, dy = axis(y0, y1, H, rows)
        xa, xb, dx = axis(x0, x1, W, cols)
        left = (1 - dy)[:, None] * pg[ya][:, xa] + dy[:, None] * pg[yb][:, xa]
        right = (1 - dy)[:, None] * pg[ya][:, xb] + dy[:, None] * pg[yb][:, xb]
        out[k] = (1 - dx) * left + dx * right
        out[k][:, wv.reshape(-1)[k]:] = 0.0
    return out


@pytest.mark.parametrize(
    "shape",
    [
        (2, 64, 96, 3),  # tile == h path of the TPU kernel
        (1, 480, 128, 3),  # tiled path (3 tiles), aligned width
        (1, 480, 100, 3),  # unaligned width -> the TPU kernel's pad path
    ],
)
def test_fused_enhance_matches_pallas(shape):
    imgs = np.random.default_rng(0).random(shape).astype(np.float32)
    ref = np.asarray(jax_enhance(jnp.asarray(imgs), interpret=True))
    got = enhance.fused_enhance(torch.from_numpy(imgs)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < ATOL


def test_enhance_gray_matches_repeated_rgb():
    """The detector's gray entry, on the u8 canvas, equals fused_enhance of
    the canvas / 255 (as the JAX detector computes it under jit) repeated
    three times, written channels-first."""
    gray = np.random.default_rng(3).integers(0, 256, (2, 64, 96), np.uint8)
    ref = np.asarray(jax_enhance(
        jnp.repeat(_jax_unit(jnp.asarray(gray))[..., None], 3, -1),
        interpret=True))
    t = torch.from_numpy(gray)
    got = enhance.enhance_gray(t, enhance.gray_means(t)).numpy()
    assert got.shape == (2, 3, 64, 96)
    assert np.abs(got.transpose(0, 2, 3, 1) - ref).max() < ATOL


def _assert_matches(got: torch.Tensor, ref: np.ndarray, atol: float) -> None:
    """float32 within atol; bf16 under the shared bf16 rule against the
    reference rounded to bf16."""
    if got.dtype == torch.bfloat16:
        ref_t = torch.tensor(ref)
        assert bf16_agrees(got, ref_t), bf16_disagreement(got, ref_t)
    else:
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - ref).max() < atol


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 37, 45)])
def test_enhance_gray_forms_match_pallas(shape, out_dtype):
    """Both output dtypes of the u8 entry's plain version against the Pallas
    kernel on the canvas / 255 repeated three times, given the mean the
    Pallas kernel computes (the luma of the repeated channels): bf16 near
    zero magnifies any float32 difference in the inputs."""
    gray = np.random.default_rng(4).integers(0, 256, shape, np.uint8)
    rgb = jnp.repeat(_jax_unit(jnp.asarray(gray))[..., None], 3, -1)
    ref = np.asarray(jax_enhance(rgb, interpret=True)).transpose(0, 3, 1, 2)
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    means = torch.from_numpy(np.array(luma.mean(axis=(1, 2))))
    got = enhance.enhance_gray_plain(torch.from_numpy(gray), means, out_dtype)
    assert got.shape == ref.shape
    _assert_matches(got, ref, ATOL)


# The port's luma means and XLA's sum in different orders: they differ by
# up to 6 float32 ulps on these pages, and by 8 on eight seeded 960 x 960
# pages.
MEAN_MAX_ULPS = 8


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 37, 45), (2, 960, 960)])
def test_gray_means_match_jax_luma_mean(shape):
    """The detector's means (``gray_means``, the luma of the repeated
    channels) against the mean the Pallas kernel's wrapper computes."""
    gray = np.random.default_rng(4).integers(0, 256, shape, np.uint8)
    rgb = jnp.repeat(_jax_unit(jnp.asarray(gray))[..., None], 3, -1)
    luma = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    ref = np.array(jax.jit(lambda x: x.mean(axis=(1, 2)))(luma))
    got = enhance.gray_means(torch.from_numpy(gray)).numpy()
    assert got.dtype == np.float32
    assert np.abs(got.view(np.int32) - ref.view(np.int32)).max() <= MEAN_MAX_ULPS


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 37, 45)])
def test_enhance_gray_bf16_with_port_means_matches_pallas(shape):
    """The served detector input: the bf16 form given the port's own means
    against the Pallas kernel (float32, its own means) rounded to bf16.
    Each element is within one bf16 ulp of it, or within ATOL: means a few
    float32 ulps apart move an output by ~1e-6, which near zero is many
    bf16 ulps."""
    gray = np.random.default_rng(4).integers(0, 256, shape, np.uint8)
    rgb = jnp.repeat(_jax_unit(jnp.asarray(gray))[..., None], 3, -1)
    ref = torch.tensor(np.asarray(jax_enhance(rgb, interpret=True)).transpose(0, 3, 1, 2))
    t = torch.from_numpy(gray)
    got = enhance.enhance_gray_plain(t, enhance.gray_means(t), torch.bfloat16).float()
    want = ref.to(torch.bfloat16).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    err = (got - want).abs()
    assert bool(((err <= ulp) | (err <= ATOL)).all()), float(err.max())


def test_fused_enhance_bf16_matches_pallas():
    imgs = np.random.default_rng(5).random((1, 48, 100, 3)).astype(np.float32)
    ref = np.asarray(jax_enhance(jnp.asarray(imgs), interpret=True))
    got = enhance.fused_enhance(torch.from_numpy(imgs), out_dtype=torch.bfloat16)
    assert got.shape == ref.shape
    _assert_matches(got, ref, ATOL)


def _boxes(P, N, S, H, W, seed, max_h, rows, min_h=8):
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 255, (P, rows, S), np.uint8)
    x0 = rng.uniform(-10, S - 60, (P, N))  # incl. off-page starts
    y0 = rng.uniform(-5, max(rows - 30, 2), (P, N))
    w = rng.uniform(20, 100, (P, N))
    h = rng.uniform(min_h, max_h, (P, N))
    aabbs = np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)
    wv = np.clip(w / h * H, 16, W).astype(np.int32)
    return pages, aabbs, wv


@pytest.mark.parametrize(
    "P,N,S,H,W,seed,max_h,rows",
    [
        (2, 4, 256, 48, 320, 1, 40, None),  # TestCropMatmul cases
        (1, 3, 200, 48, 160, 1, 40, None),  # unaligned page width
        (1, 4, 256, 48, 320, 7, 40, None),  # page-edge boxes
        (3, 2, 320, 48, 320, 1, 30, 48),  # line-strip pages
    ],
)
def test_crop_matches_pallas(P, N, S, H, W, seed, max_h, rows):
    pages, aabbs, wv = _boxes(P, N, S, H, W, seed, max_h, rows or S)
    ref = np.asarray(crop_boxes_matmul(
        jnp.asarray(pages), jnp.asarray(aabbs), jnp.asarray(wv), (H, W),
        interpret=True,
    ))
    got = crop.crop_boxes(torch.from_numpy(pages), torch.from_numpy(aabbs),
                          torch.from_numpy(wv), (H, W)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < CROP_VS_PALLAS_ATOL
    assert np.abs(got - _crop_exact(pages, aabbs, wv, H, W)).max() < ATOL


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=str)
def test_crop_forms_match_pallas(out_dtype):
    pages, aabbs, wv = _boxes(2, 4, 256, 48, 320, 3, 40, 256)
    ref = np.asarray(crop_boxes_matmul(
        jnp.asarray(pages), jnp.asarray(aabbs), jnp.asarray(wv), (48, 320),
        interpret=True,
    ))
    got = crop.crop_boxes_plain(torch.from_numpy(pages), torch.from_numpy(aabbs),
                                torch.from_numpy(wv), (48, 320), out_dtype)
    assert got.shape == ref.shape
    _assert_matches(got, ref, CROP_VS_PALLAS_ATOL)


def test_crop_tall_boxes_match_separable():
    """Boxes taller than the TPU kernel's 112-row slab (which it cannot
    crop) against the separable gather path: no height bound here. Boxes
    lie on the page, where the two JAX paths agree up to the rounding of
    their sample coordinates (linspace there), which moves values by up to
    ~3e-5: held at the Pallas tolerance, and at ATOL against float64."""
    P, N, S, H, W = 2, 5, 400, 48, 320
    rng = np.random.default_rng(11)
    pages = rng.integers(0, 255, (P, S, S), np.uint8)
    x0 = rng.uniform(0, 150, (P, N))
    y0 = rng.uniform(0, 100, (P, N))
    w = rng.uniform(100, 240, (P, N))
    h = rng.uniform(120, 290, (P, N))
    aabbs = np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)
    wv = np.clip(w / h * H, 16, W).astype(np.int32)
    pg = jnp.asarray(pages).astype(jnp.float32) / 255.0
    ref = jax.vmap(lambda p, b: crop_boxes_separable(p, b, (H, W)))(
        pg, jnp.asarray(aabbs))
    ref = _mask_pad(ref.reshape(-1, H, W)[..., None],
                    jnp.asarray(wv).reshape(-1))[..., 0]
    got = crop.crop_boxes(torch.from_numpy(pages), torch.from_numpy(aabbs),
                          torch.from_numpy(wv), (H, W)).numpy()
    assert np.abs(got - np.asarray(ref)).max() < CROP_VS_PALLAS_ATOL
    assert np.abs(got - _crop_exact(pages, aabbs, wv, H, W)).max() < ATOL


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers compute the plain versions and launch (and
    count) nothing."""
    before = (enhance.LAUNCHES.value, crop.LAUNCHES.value)
    gray = torch.randint(0, 256, (1, 16, 16), dtype=torch.uint8)
    means = enhance.to_unit(gray).mean(dim=(1, 2))
    assert torch.equal(enhance.enhance_gray(gray, means), enhance.enhance_gray_plain(gray, means))
    pages = torch.randint(0, 255, (1, 16, 16), dtype=torch.uint8)
    aabbs = torch.tensor([[[1.0, 2.0, 12.0, 9.0]]])
    wv = torch.tensor([[60]], dtype=torch.int32)
    assert torch.equal(crop.crop_boxes(pages, aabbs, wv, (48, 80)),
                       crop.crop_boxes_plain(pages, aabbs, wv, (48, 80)))
    assert (enhance.LAUNCHES.value, crop.LAUNCHES.value) == before


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_stages_request_their_compute_dtype(monkeypatch, compute):
    """Detector and Recognizer ask both kernels for their policy's compute
    dtype, so no cast pass follows them."""
    asked = {}

    def spy(name, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            asked.setdefault(name, set()).add(out.dtype)
            return out
        return wrapped

    monkeypatch.setattr(detector_mod, "enhance_gray", spy("enhance", enhance.enhance_gray))
    monkeypatch.setattr(recognizer_mod, "crop_boxes", spy("crop", crop.crop_boxes))
    settings = Settings(compute_dtype=compute, det_image_buckets=(64,), rec_width_buckets=(80,))
    det = detector_mod.Detector(settings, device="cpu")
    det._forward(det._pack_wire(np.full((1, 64, 64), 200, np.uint8)))
    rec = recognizer_mod.Recognizer(settings, device="cpu")
    page = np.full((40, 60, 3), 255, np.uint8)
    rec.recognize_page(page, np.array([[[2, 2], [30, 2], [30, 14], [2, 14]]], np.float32))
    assert asked == {"enhance": {getattr(torch, compute)}, "crop": {getattr(torch, compute)}}
