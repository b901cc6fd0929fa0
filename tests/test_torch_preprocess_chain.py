"""The port's page preprocessing chain (ops/image_ops.py, ops/sampling.py)
against the JAX package's, on the CPU: ``resize_bilinear`` against
``jax.image.resize`` within 2e-6 (downscale, upscale, mixed axes; gray and
RGB); ``letterbox``'s shape, scale and pixels (2e-6); ``median_denoise3``
exactly; ``rotation_matrix``, ``in_bounds_mask``, ``affine_sample`` and
``rotate`` within 1e-5 (against the JAX functions compiled, as the JAX
deskew runs them: XLA contracts the matrix's translation into fused
multiply-adds, which the port's ``rotation_matrix`` does too); ``deskew`` on seeded skewed pages (a straight page
under the 0.5-degree gate and the stair layout of tests/test_ops.py
included): the same candidate angle bit for bit, a rotation matrix equal
to the JAX one within the float32 rounding of the sine and cosine, the
image within 1e-5 of the JAX package's warp by the port's matrix, and
against the JAX deskew itself within 1e-5 plus the displacement that the
two matrices' difference allows (none where they are bit for bit equal);
``preprocess_page`` in all 8 flag combinations within 1e-5, held the same
way."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_system_tpu.ops import image_ops as jax_image_ops
from ocr_system_tpu.ops import sampling as jax_sampling
from ocr_system_tpu_torch.ops import image_ops, sampling

torch.set_num_threads(1)

RESIZE_TOL = 2e-6
WARP_TOL = 1e-5


def _rand(seed, shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _max_diff(got: torch.Tensor, want) -> float:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    return float(np.abs(got.numpy() - want).max())


@pytest.mark.parametrize("shape,out_hw", [
    ((96, 128), (40, 52)),       # downscale
    ((30, 44), (71, 90)),        # upscale
    ((64, 40), (25, 97)),        # mixed: one axis down, one up
    ((80, 120, 3), (33, 47)),    # RGB, channel last
    ((36, 20, 3), (50, 64)),
])
def test_resize_bilinear_matches_jax(shape, out_hw):
    img = _rand(1, shape)
    got = image_ops.resize_bilinear(torch.from_numpy(img), out_hw)
    want = jax_image_ops.resize_bilinear(jnp.asarray(img), out_hw)
    assert _max_diff(got, want) <= RESIZE_TOL


@pytest.mark.parametrize("shape,target,fill", [
    ((100, 200), (64, 64), 0.0),
    ((120, 90, 3), (96, 128), 1.0),
    ((50, 50), (80, 60), 0.5),
])
def test_letterbox_matches_jax(shape, target, fill):
    img = _rand(2, shape)
    got, scale = image_ops.letterbox(torch.from_numpy(img), target, fill)
    want, want_scale = jax_image_ops.letterbox(jnp.asarray(img), target, fill)
    assert scale == want_scale
    assert _max_diff(got, want) <= RESIZE_TOL


@pytest.mark.parametrize("shape", [(32, 41), (24, 30, 3)])
def test_median_denoise3_is_exact(shape):
    img = _rand(3, shape)
    img[img > 0.9] = 0.0  # salt
    got = image_ops.median_denoise3(torch.from_numpy(img))
    want = np.asarray(jax_image_ops.median_denoise3(jnp.asarray(img)))
    if len(shape) == 2:
        assert np.array_equal(got.numpy(), want)
    else:
        # RGB goes through the luma dot product first; its rounding is
        # XLA's and PyTorch's own, so it is held at float32 resolution
        assert _max_diff(got, want) <= 1e-6


@pytest.mark.parametrize("angle", [0.0, 7.5, -23.0, 90.0])
def test_rotation_matrix_matches_jax(angle):
    center = (31.5, 20.0)
    got = sampling.rotation_matrix(angle, center)
    want = jax.jit(lambda a: jax_sampling.rotation_matrix(a, center))(jnp.float32(angle))
    assert _max_diff(got, want) <= WARP_TOL


def test_in_bounds_mask_matches_jax():
    xy = np.random.default_rng(4).uniform(-3, 40, (2, 50, 60)).astype(np.float32)
    xy[0, 0, :4] = [0.0, 29.0, -0.0, 29.000002]  # the edges themselves
    got = sampling.in_bounds_mask(20, 30, torch.from_numpy(xy[0]), torch.from_numpy(xy[1]))
    want = jax_sampling.in_bounds_mask(20, 30, jnp.asarray(xy[0]), jnp.asarray(xy[1]))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(40, 56), (33, 47, 3)])
@pytest.mark.parametrize("fill", [0.0, 1.0])
def test_affine_sample_matches_jax(shape, fill):
    img = _rand(5, shape)
    m = np.array([[0.9, -0.2, 4.5], [0.15, 1.1, -3.0]], np.float32)
    got = sampling.affine_sample(torch.from_numpy(img), torch.from_numpy(m), (45, 52), fill)
    want = jax_sampling.affine_sample(jnp.asarray(img), jnp.asarray(m), (45, 52), fill)
    assert _max_diff(got, want) <= WARP_TOL


@pytest.mark.parametrize("shape", [(64, 64), (50, 71, 3)])
@pytest.mark.parametrize("angle", [3.0, -12.0, 0.0])
def test_rotate_matches_jax(shape, angle):
    img = _rand(6, shape)
    got = sampling.rotate(torch.from_numpy(img), angle, fill_value=1.0)
    want = jax.jit(lambda im, a: jax_sampling.rotate(im, a, fill_value=1.0))(
        jnp.asarray(img), jnp.float32(angle))
    assert _max_diff(got, want) <= WARP_TOL


def _lines_page(seed: int, angle: float, rgb: bool = False) -> np.ndarray:
    """A text-like page of dark word bars on light paper, turned by
    ``angle`` with the JAX package's rotate (white outside)."""
    rng = np.random.default_rng(seed)
    page = np.full((256, 240), 0.96, np.float32)
    for y in range(18, 236, 14):
        x = 10
        while x < 200:
            w = int(rng.integers(8, 36))
            page[y:y + 6, x:x + w] = rng.uniform(0.0, 0.25)
            x += w + int(rng.integers(4, 10))
    if angle:
        page = np.asarray(jax_sampling.rotate(jnp.asarray(page), angle, fill_value=1.0))
    if rgb:
        page = np.stack([page, page * 0.98, page * 0.95], axis=-1)
    return np.ascontiguousarray(page, dtype=np.float32)


def _stair_page() -> np.ndarray:
    """tests/test_ops.py's stair layout: each row indented further."""
    page = np.ones((256, 256), np.float32)
    for i, y in enumerate(range(20, 80, 12)):
        x0 = 20 + i * 30
        page[y:y + 5, x0:x0 + 50] = 0.0
    return page


DESKEW_PAGES = {
    "straight": _lines_page(7, 0.0),
    "turned_7": _lines_page(8, 7.0),
    "turned_-4": _lines_page(9, -4.0),
    "turned_-5": _lines_page(11, -5.0),
    "turned_-10_rgb": _lines_page(10, -10.0, rgb=True),
    "stair": _stair_page(),
}


def _matrices(page, got_angle, want_angle):
    """The port's rotation matrix at its angle and the JAX package's
    compiled one at its angle, about the page centre."""
    h, w = page.shape[:2]
    center = ((w - 1) / 2.0, (h - 1) / 2.0)
    got = sampling.rotation_matrix(float(got_angle), center).numpy()
    want = np.asarray(jax.jit(lambda a: jax_sampling.rotation_matrix(a, center))(
        jnp.float32(float(want_angle))))
    return got, want


def _jax_chain(page, matrix, contrast: bool, binarize: bool) -> np.ndarray:
    """The JAX package's chain with its rotation by ``matrix`` (None: no
    rotation): compiled affine_sample, then its enhancement steps."""
    img = jnp.asarray(page)
    if matrix is not None:
        img = jax.jit(lambda im, m: jax_sampling.affine_sample(im, m, page.shape[:2], 1.0))(
            img, jnp.asarray(matrix))
    if contrast:
        img = jax_image_ops.enhance_sharpness(jax_image_ops.enhance_contrast(img, 1.2), 1.1)
    if binarize:
        img = jax_image_ops.adaptive_binarize(img)
    return np.asarray(img)


def _same_candidate(got_angle, want_angle, name) -> None:
    """The same candidate of the skew search, bit for bit: the port's
    candidates are the compiled ``jnp.linspace``'s float32 values
    (``image_ops.skew_candidates``; torch's linspace differs at 15 of the
    31, 5 against 4.999999)."""
    assert np.float32(got_angle).tobytes() == np.float32(want_angle).tobytes()
    if name in ("straight", "stair"):
        assert float(got_angle) == 0.0  # the no-op under the 0.5-degree gate
    else:
        assert float(got_angle) != 0.0


def _displacement(m_got: np.ndarray, m_want: np.ndarray, shape) -> float:
    """The largest distance, in pixels, between where the two 2x3 matrices
    send an output pixel of ``shape`` (the corners bound it): a bilinear
    warp of [0, 1] values moves by at most that much."""
    h, w = shape[:2]
    corners = np.array([[0, 0, 1], [w - 1, 0, 1], [0, h - 1, 1], [w - 1, h - 1, 1]],
                       np.float64)
    d = corners @ (m_got.astype(np.float64) - m_want.astype(np.float64)).T
    return float(np.abs(d).sum(axis=1).max())


@pytest.mark.parametrize("name", sorted(DESKEW_PAGES))
def test_deskew_matches_jax(name):
    """The warp equals the JAX package's compiled warp by the port's matrix
    within 1e-5; that matrix is the JAX one within float32 rounding of the
    sine and cosine (XLA's and libm's last bits differ at some angles: cos
    4 degrees), and the port's deskew is within 1e-5 of the JAX deskew
    itself, plus the displacement between the two matrices: none but on
    turned_-4 (ROADMAP Queue 3)."""
    page = DESKEW_PAGES[name]
    got, got_angle = image_ops.deskew(torch.from_numpy(page))
    want, want_angle = jax_image_ops.deskew(jnp.asarray(page))
    _same_candidate(got_angle, want_angle, name)
    if float(got_angle) == 0.0:
        assert np.array_equal(got.numpy(), np.asarray(want))
        return
    m_got, m_want = _matrices(page, got_angle, want_angle)
    assert np.abs(m_got[:, :2] - m_want[:, :2]).max() <= 2.5e-7
    assert _max_diff(got, _jax_chain(page, m_got, False, False)) <= WARP_TOL
    slack = _displacement(m_got, m_want, page.shape)
    assert (slack == 0.0) == (name != "turned_-4")
    assert _max_diff(got, want) <= WARP_TOL + slack


@pytest.mark.parametrize("flags", list(itertools.product((False, True), repeat=3)))
@pytest.mark.parametrize("name", ["turned_7", "turned_-4", "turned_-10_rgb"])
def test_preprocess_page_matches_jax(name, flags):
    """All 8 flag combinations, held as ``test_deskew_matches_jax`` holds
    the rotation: against the JAX chain with the port's matrix, and against
    the JAX ``preprocess_page`` itself where the matrices are equal."""
    page = DESKEW_PAGES[name]
    deskew, contrast, binarize = flags
    got, got_angle = image_ops.preprocess_page(torch.from_numpy(page), deskew, contrast,
                                               binarize)
    want, want_angle = jax_image_ops.preprocess_page(jnp.asarray(page), deskew, contrast,
                                                     binarize)
    _same_candidate(got_angle, want_angle, "straight" if not deskew else name)
    m_got, m_want = _matrices(page, got_angle, want_angle) if deskew else (None, None)
    assert _max_diff(got, _jax_chain(page, m_got, contrast, binarize)) <= WARP_TOL
    if not deskew or np.array_equal(m_got, m_want):
        assert _max_diff(got, want) <= WARP_TOL
