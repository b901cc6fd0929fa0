"""The port's ops and host helpers against the JAX package (and against
OpenCV for the helpers the JAX package delegates to it)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_system_tpu.engine import detector as jax_detector
from ocr_system_tpu.ops import boxes as jax_boxes
from ocr_system_tpu.ops import ctc as jax_ctc
from ocr_system_tpu.ops import device_boxes as jax_device_boxes
from ocr_system_tpu.ops import image_ops as jax_image_ops
from ocr_system_tpu.ops import sampling as jax_sampling
from ocr_system_tpu.models.charsets import get_charset as jax_charset
from ocr_system_tpu_torch.engine import detector, host_image
from ocr_system_tpu_torch.engine.recognizer import quad_crops
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.ops import boxes, ctc, device_boxes, image_ops, sampling

torch.set_num_threads(1)


def _text_page(seed, h=256, w=256, angle=0.0):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 245, np.uint8)
    for y in range(16, h - 16, 14):
        x = 10
        while x < w - 40:
            bw = int(rng.integers(8, 40))
            img[y:y + 6, x:x + bw] = int(rng.integers(0, 60))
            x += bw + int(rng.integers(4, 10))
    if angle:
        m = cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, 1.0)
        img = cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_CUBIC,
                             borderValue=(255, 255, 255))
    return img


@pytest.mark.parametrize("angle", [0.0, 3.0, -6.0, 10.0])
def test_skew_angle_matches_jax(angle):
    gray = cv2.cvtColor(_text_page(1, 320, 288, angle), cv2.COLOR_RGB2GRAY)
    f = gray.astype(np.float32) / 255.0
    ref = float(jax_image_ops.estimate_skew_angle(jnp.asarray(f)))
    got = float(image_ops.estimate_skew_angle(torch.from_numpy(f)[None])[0])
    assert got == pytest.approx(ref, abs=1e-5)
    if angle:
        assert got != 0.0


def test_enhance_ops_match_jax():
    img = np.random.default_rng(2).random((40, 56)).astype(np.float32)
    t = torch.from_numpy(img)
    for ref, got in [
        (jax_image_ops.enhance_contrast(jnp.asarray(img)), image_ops.enhance_contrast(t)),
        (jax_image_ops.enhance_sharpness(jnp.asarray(img)), image_ops.enhance_sharpness(t)),
        (jax_image_ops.normalize_for_model(jnp.asarray(img)), image_ops.normalize_for_model(t)),
    ]:
        assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5


def _prob_maps():
    """Blobs of several shapes: bars, a rotated bar, touching diagonals,
    speckle, and one component spanning the map."""
    rng = np.random.default_rng(3)
    maps = np.zeros((2, 64, 80), np.float32)
    maps[0, 5:9, 4:40] = 0.9
    maps[0, 12:16, 4:20] = 0.6
    maps[0, 12:16, 24:60] = 0.45
    for k in range(20):  # diagonal stroke: only 8-connected
        maps[0, 25 + k, 10 + k] = 0.8
    yy, xx = np.mgrid[:64, :80]
    rot = np.abs((yy - 45) - 0.4 * (xx - 50)) < 2.5
    maps[0][rot & (xx > 30) & (xx < 75)] = 0.7
    maps[0][rng.random((64, 80)) > 0.97] = 0.35
    maps[1] = rng.random((64, 80)).astype(np.float32) * 0.2
    maps[1, 2:62, 3] = 0.8
    maps[1, 30, 3:78] = 0.8
    return maps


@pytest.mark.parametrize("k", [64, 8])
def test_component_stats_row_for_row(k):
    maps = _prob_maps()
    ref_stats, ref_n = jax_device_boxes.component_stats(jnp.asarray(maps), 0.3, k)
    got_stats, got_n = device_boxes.component_stats(torch.from_numpy(maps), 0.3, k)
    ref_stats = np.asarray(ref_stats)
    got_stats = got_stats.numpy()
    assert np.array_equal(got_n.numpy(), np.asarray(ref_n))
    assert got_stats.shape == ref_stats.shape
    # counts, bbox extents: exact; sums, moments and oriented extents to
    # float32 rounding of the reference's matmul sums
    exact = [0, 2, 3, 4, 5]
    assert np.array_equal(got_stats[..., exact], ref_stats[..., exact])
    assert np.abs(got_stats - ref_stats).max() < 1e-3


def test_boxes_from_stats_matches_jax():
    maps = _prob_maps()
    stats, n = jax_device_boxes.component_stats(jnp.asarray(maps), 0.3, 320)
    for j in range(2):
        kw = dict(box_thresh=0.5, unclip_ratio=2.6, scale_xy=(2.0, 2.0),
                  clip_wh=(160, 128))
        ref = jax_boxes.boxes_from_stats(np.asarray(stats[j]), int(n[j]), **kw)
        got = boxes.boxes_from_stats(np.asarray(stats[j]), int(n[j]), **kw)
        assert len(got) == len(ref) > 0
        for a, b in zip(ref, got):
            assert np.abs(a.quad - b.quad).max() < 1e-4 and a.score == b.score


def test_boxes_from_prob_map_matches_jax():
    """The component-overflow fallback, against the branch the JAX package
    serves (cv2.minAreaRect + cv2.boxPoints)."""
    prob = _prob_maps()[0]
    kw = dict(bin_thresh=0.3, box_thresh=0.5, unclip_ratio=2.6)

    def key(b):
        return (-b.score, b.quad.round(3).tolist())

    ref = sorted(jax_boxes.boxes_from_prob_map(prob, **kw), key=key)
    got = sorted(boxes.boxes_from_prob_map(prob, **kw), key=key)
    assert len(got) == len(ref) > 0
    for a, b in zip(ref, got):
        assert a.score == pytest.approx(b.score, abs=1e-6)
        assert np.abs(a.quad - b.quad).max() < 1e-4


def _min_area_rect_sets(n_sets=3000):
    """Half random integer points, half thin diagonal strokes (1-3 px
    thick) with a few stray points: many rectangles tie in area there."""
    rng = np.random.default_rng(0)
    sets = []
    for k in range(n_sets):
        if k % 2 == 0:
            n, span = int(rng.integers(3, 60)), int(rng.integers(2, 80))
            sets.append(rng.integers(0, span, (n, 2)).astype(np.float32))
            continue
        length, thick = int(rng.integers(5, 80)), int(rng.integers(1, 4))
        step = np.array([rng.choice([-1, 1]) * rng.uniform(0.3, 1.0), rng.uniform(0.3, 1.0)])
        t = np.arange(length)[:, None]
        stroke = np.concatenate([np.floor(t * step + [o, 0]) for o in range(thick)])
        stray = rng.integers(-10, 60, (int(rng.integers(0, 4)), 2))
        sets.append(np.concatenate([stroke, stray]).astype(np.float32) + 20)
    return sets


def test_min_area_rect_matches_cv2_branch():
    """The port's min_area_rect equals the JAX package's served branch
    (cv2.minAreaRect -> cv2.boxPoints -> _order_quad) on every set, ties
    and 45-degree rectangles included."""
    worst = 0.0
    for pts in _min_area_rect_sets():
        ref_q, ref_w, ref_h = jax_boxes.min_area_rect(pts)
        got_q, got_w, got_h = boxes.min_area_rect(pts)
        worst = max(worst, float(np.abs(got_q - ref_q).max()),
                    abs(got_w - ref_w), abs(got_h - ref_h))
    assert worst <= 1e-3


def test_crops_match_jax():
    rng = np.random.default_rng(4)
    img = rng.random((60, 90)).astype(np.float32)
    quads = np.array([
        [[5, 5], [50, 9], [48, 25], [3, 21]],
        [[-10, 40], [70, 40], [70, 70], [-10, 70]],  # partly off the page
        [[20.5, 10.25], [80.5, 10.25], [80.5, 30.75], [20.5, 30.75]],
    ], np.float32)
    ref = jax_sampling.crop_quads(jnp.asarray(img), jnp.asarray(quads), (16, 48))
    got = sampling.crop_quads(torch.from_numpy(img), torch.from_numpy(quads), (16, 48))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5
    aabbs = sampling.quads_to_aabbs(quads)
    assert np.array_equal(aabbs, jax_sampling.quads_to_aabbs(quads))
    ref = jax_sampling.crop_boxes_separable(jnp.asarray(img), jnp.asarray(aabbs), (16, 48))
    got = sampling.crop_boxes_separable(torch.from_numpy(img), torch.from_numpy(aabbs), (16, 48))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 1e-5
    assert np.array_equal(sampling.axis_aligned_mask(quads),
                          jax_sampling.axis_aligned_mask(quads))


def test_rotated_quad_crops_round_as_jitted_jax():
    """The recognizer's rotated-quad crops take the u8 stack to [0, 1] as
    the JAX recognizer's jitted ``pages / 255.0`` does (a multiply by
    float32(1/255)), on the CPU as on the card: bit for bit the port's
    crop of the JAX-converted page, and within 1e-5 of the JAX quad crop
    itself. The page is made of the six 4-bit wire levels where a true
    division rounds otherwise, and the other 4-bit levels."""
    rng = np.random.default_rng(11)
    levels = np.arange(0, 256, 17, dtype=np.uint8)
    assert {51, 102, 119, 204, 221, 238} <= set(levels.tolist())
    stack = rng.choice(levels, (3, 64, 80)).astype(np.uint8)
    quads = np.zeros((3, 5, 4, 2), np.float32)
    for k in (0, 2):  # row 1 holds only padding crops
        for j in range(5):
            x, y = rng.uniform(2, 40), rng.uniform(2, 40)
            w, h, t = rng.uniform(10, 35), rng.uniform(6, 20), rng.uniform(-0.3, 0.3)
            quads[k, j] = [[x, y], [x + w, y + t * h], [x + w - t * h, y + (1 + t) * h],
                           [x - t * h, y + h]]
    shape = (48, 80)
    got = quad_crops(torch.from_numpy(stack), torch.from_numpy(quads), [0, 2], shape)
    got = got.numpy().reshape(3, 5, *shape)
    assert not got[1].any()
    unit = np.array(jax.jit(lambda g: g.astype(jnp.float32) / 255.0)(jnp.asarray(stack)))
    true_div = stack.astype(np.float32) / np.float32(255.0)
    ref_jax = jax.jit(jax.vmap(lambda p, q: jax_sampling.crop_quads(p, q, shape)))(
        jnp.asarray(unit), jnp.asarray(quads))
    for k in (0, 2):
        same_page = sampling.crop_quads(torch.from_numpy(unit[k]), torch.from_numpy(quads[k]),
                                        shape).numpy()
        assert np.array_equal(got[k].view(np.uint32), same_page.view(np.uint32))
        assert np.abs(got[k] - np.asarray(ref_jax[k])).max() < 1e-5
        other = sampling.crop_quads(torch.from_numpy(true_div[k]),
                                    torch.from_numpy(quads[k]), shape).numpy()
        assert (other != got[k]).any()  # the test sees the rounding


def test_ctc_decode_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((6, 20, 96)).astype(np.float32) * 3
    logits[:, ::3, 0] += 4.0  # blanks between repeats
    lengths = np.array([20, 17, 9, 1, 20, 5], np.int32)
    r_ids, r_conf, r_n = jax_ctc.ctc_greedy_decode(jnp.asarray(logits), jnp.asarray(lengths))
    g_ids, g_conf, g_n = ctc.ctc_greedy_decode(torch.from_numpy(logits), torch.from_numpy(lengths))
    assert np.array_equal(g_ids.numpy(), np.asarray(r_ids))
    assert np.array_equal(g_n.numpy(), np.asarray(r_n))
    assert np.abs(g_conf.numpy() - np.asarray(r_conf)).max() < 1e-6
    assert ctc.ids_to_text(g_ids.numpy(), get_charset("latin")) == jax_ctc.ids_to_text(
        np.asarray(r_ids), jax_charset("latin"))


_LETTERBOX_CASES = [
    # text pages (the first three keep their ids)
    pytest.param((300, 220), 256, "text", id="shape0-256"),
    pytest.param((120, 90), 256, "text", id="shape1-256"),
    pytest.param((256, 200), 256, "text", id="shape2-256"),
] + [
    # random RGB pages, downscaled and upscaled
    pytest.param(shape, bucket, "noise", id=f"noise-{shape[0]}x{shape[1]}-{bucket}")
    for shape, bucket in [((300, 220), 256), ((1100, 850), 960), ((120, 90), 256),
                          ((1650, 1275), 960), ((500, 377), 1280), ((64, 50), 640)]
]


@pytest.mark.parametrize("shape,bucket,page", _LETTERBOX_CASES)
def test_letterbox_matches_cv2(shape, bucket, page):
    """cv2.resize(INTER_LINEAR) + cvtColor, bit for bit: the port's resize
    is OpenCV's 11-bit fixed point."""
    if page == "text":
        img = _text_page(6, *shape)
    else:
        img = np.random.default_rng(9).integers(0, 256, (*shape, 3), np.uint8)
    ref, ref_scale = jax_detector._letterbox_host(img, bucket)  # cv2
    got, scale = detector._letterbox_host(img, bucket)
    assert scale == ref_scale
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("angle", [3.0, -2.5, 12.0])
def test_rotate_matches_cv2(angle):
    page = _text_page(7, 200, 150)
    ref = jax_detector._rotate_host(page, angle)  # cv2.warpAffine, cubic
    got = detector._rotate_host(page, angle)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_gray_matches_cv2():
    page = np.random.default_rng(8).integers(0, 256, (64, 80, 3), np.uint8)
    ref = cv2.cvtColor(page, cv2.COLOR_RGB2GRAY)
    assert np.abs(host_image.rgb_to_gray(page).astype(int) - ref).max() <= 1
