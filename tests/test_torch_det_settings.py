"""The port's detector at each setting the JAX detector serves besides the
default (page wire 2 and 8 bits, prob wire 1, 4 and 8 bits, contrast
enhancement off, adaptive binarization on), against the JAX detector with
the trained DBNet: the wire pack and unpack bit for bit, adaptive
binarization, the forward's prob-wire outputs at a small bucket, and the
boxes of detect_batch on two committed forms. Also the JAX package's own
checks that prob wires 1 and 0 agree with 4 (tests/test_engine.py), on the
port."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.mesh import build_mesh, mesh_context
from ocr_system_tpu.engine.detector import Detector as JaxDetector
from ocr_system_tpu.ops import image_ops as jax_image_ops
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine import detector as detector_mod
from ocr_system_tpu_torch.engine.detector import Detector
from ocr_system_tpu_torch.engine.host_image import resize_linear
from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine
from ocr_system_tpu_torch.engine.preprocess import PageImage
from ocr_system_tpu_torch.kernels import enhance
from ocr_system_tpu_torch.ops import image_ops
from ocr_system_tpu_torch.utils import smoke

torch.set_num_threads(1)

SETTINGS = smoke.DET_SETTINGS
DET_NPZ = str(smoke.PACKAGE / "weights" / "det.npz")
FWD_BUCKET = 320
BOX_BUCKET = FWD_BUCKET  # one compiled JAX forward per setting
_CACHE: dict = {}


def _pair(name: str, bucket: int):
    """The port's and the JAX package's detector at setting ``name``, float32,
    the trained DBNet, one bucket."""
    key = (name, bucket)
    if key not in _CACHE:
        kw = dict(det_image_buckets=(bucket,), compute_dtype="float32", **SETTINGS[name])
        _CACHE[key] = (Detector(Settings(det_checkpoint=DET_NPZ, **kw), device="cpu"),
                       JaxDetector(JaxSettings(det_checkpoint="checkpoints/det", **kw)))
    return _CACHE[key]


@pytest.fixture(scope="module")
def forms():
    forms, _ = smoke.smoke_forms()
    return forms


@pytest.fixture(scope="module")
def canvases(forms):
    """Two committed forms as gray canvases of the forward's bucket."""
    return np.stack([detector_mod._letterbox_host(f, FWD_BUCKET)[0] for f in forms[1:3]])


@pytest.mark.parametrize("name", list(SETTINGS))
def test_settings_are_accepted(name):
    det = Detector(Settings(**SETTINGS[name]), device="cpu")
    s = det.settings
    assert det.use_kernel == (s.enable_contrast_enhancement
                              and not s.enable_adaptive_binarization)


@pytest.mark.parametrize("update", [{"det_wire_bits": 3}, {"det_wire_bits": 16},
                                    {"det_prob_wire_bits": 2}, {"det_prob_wire_bits": 16}])
def test_unknown_widths_still_raise(update):
    with pytest.raises(ValueError, match="port"):
        Detector(Settings(**update), device="cpu")


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_wire_pack_and_unpack_bit_for_bit(bits, canvases):
    """``_pack_wire`` as the JAX detector's, and the device unpack as the
    JAX forward's own (its canvas output)."""
    port, ref = _pair({2: "wire_2", 4: "prob_wire_4", 8: "wire_8"}[bits], FWD_BUCKET)
    packed = port._pack_wire(canvases)
    want = ref._pack_wire(canvases)
    assert packed.dtype == want.dtype and np.array_equal(packed, want)
    assert packed.shape[-1] == FWD_BUCKET * bits // 8
    canvas = ref._forward(FWD_BUCKET, len(canvases))(jnp.asarray(want), ref.variables)[-1]
    got = detector_mod.unpack_wire(torch.from_numpy(packed), bits)
    assert np.array_equal(got.numpy(), np.asarray(canvas))


def test_adaptive_binarize_matches_jax(canvases):
    """Gray pages and an RGB page: the local Gaussian mean within 1e-6 of
    JAX, and the thresholded 0/1 page equal to JAX's at every pixel whose
    margin to the threshold exceeds 1e-6 (at a tie the two summation
    orders may round to either side)."""
    f = canvases.astype(np.float32) / 255.0
    for img in (*f, np.stack([f[0], f[1], f[0]], axis=-1)):
        want = np.asarray(jax_image_ops.adaptive_binarize(jnp.asarray(img)))
        got = image_ops.adaptive_binarize(torch.from_numpy(img)).numpy()
        gray = np.asarray(jax_image_ops.to_grayscale(jnp.asarray(img)))
        mean = np.asarray(jax_image_ops.gaussian_blur(jnp.asarray(gray), 2.0, 5))
        port_mean = image_ops.gaussian_blur(torch.from_numpy(gray), 2.0, 5).numpy()
        assert np.abs(port_mean - mean).max() <= 1e-6
        clear = np.abs(gray - (mean - 2.0 / 255.0)) > 1e-6
        assert got.shape == want.shape and np.array_equal(got[clear], want[clear])
        assert (~clear).mean() < 1e-3
    for sigma, radius in ((2.0, 5), (1.3, None), (0.6, 1)):
        want = np.asarray(jax_image_ops.gaussian_blur(jnp.asarray(f[0]), sigma, radius))
        got = image_ops.gaussian_blur(torch.from_numpy(f[0]), sigma, radius).numpy()
        assert np.abs(got - want).max() <= 1e-6


def _levels(packed: np.ndarray, mode: int) -> np.ndarray:
    """A prob-wire map as integer levels per pixel."""
    if mode == 8:
        return packed.astype(np.int32)
    if mode == 1:
        return np.unpackbits(packed, axis=-1).astype(np.int32)
    return np.stack([packed >> 4, packed & 15], axis=-1).reshape(
        *packed.shape[:-1], -1).astype(np.int32)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_forward_outputs_match_jax(name, canvases):
    """The forward's outputs against the JAX ``fwd`` on the same wire batch:
    skew angles bit for bit, and the prob-wire maps of the setting's mode (the
    component statistics under mode 0, covered by test_torch_ops, aside),
    each within 1 level on at most 0.1% of the pixels."""
    port, ref = _pair(name, FWD_BUCKET)
    packed = port._pack_wire(canvases)
    want = ref._forward(FWD_BUCKET, len(canvases))(jnp.asarray(packed), ref.variables)
    got = port._forward(packed)
    mode = port.settings.det_prob_wire_bits
    angles, want_angles = got["angles"].numpy(), np.asarray(want[-2])
    assert angles.dtype == want_angles.dtype == np.float32
    assert np.array_equal(angles.view(np.uint32), want_angles.view(np.uint32))
    maps = {0: [("prob", 2)], 1: [("prob", 0), ("score", 1)], 4: [("prob", 0)],
            8: [("prob", 0)]}[mode]
    for key, at in maps:
        a = _levels(got[key].numpy(), 4 if key == "score" else mode)
        b = _levels(np.asarray(want[at]), 4 if key == "score" or mode == 0 else mode)
        assert a.shape == b.shape, key
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (key, diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("name", list(SETTINGS))
def test_detect_batch_boxes_match_jax(name, forms):
    """detect_batch on two committed forms at a 320 bucket: the same boxes,
    each corner within 0.5 px, the same skew; the prob map carried as the
    JAX detector carries it."""
    port, ref = _pair(name, BOX_BUCKET)
    pages = [np.ascontiguousarray(resize_linear(f, (BOX_BUCKET, BOX_BUCKET))) for f in forms[:2]]
    got = port.detect_batch(pages)
    with mesh_context(build_mesh("dp=1")):
        want = ref.detect_batch(pages)
    for a, b in zip(got, want, strict=True):
        assert a.skew_angle == b.skew_angle
        qa = sorted(tuple(x.quad.reshape(-1)) for x in a.boxes)
        qb = sorted(tuple(x.quad.reshape(-1)) for x in b.boxes)
        assert len(qa) == len(qb)
        for p, q in zip(qa, qb):
            assert np.abs(np.subtract(p, q)).max() <= 0.5
        if b.prob_map is None:
            assert a.prob_map is None
        else:
            assert a.prob_map.shape == b.prob_map.shape
            assert np.abs(a.prob_map.astype(np.float32) - b.prob_map).max() <= 1 / 15 + 1e-6


@pytest.mark.parametrize("name", list(SETTINGS))
def test_enhance_kernel_serves_where_jax_runs_its_pallas_kernel(name, canvases, monkeypatch):
    """The kernel's wrapper is called exactly where the JAX detector calls
    ``fused_enhance``: contrast on and binarization off."""
    calls = []
    monkeypatch.setattr(detector_mod, "enhance_gray",
                        lambda *a, **k: calls.append(1) or enhance.enhance_gray(*a, **k))
    port, _ = _pair(name, FWD_BUCKET)
    port._forward(port._pack_wire(canvases[:1]))
    s = port.settings
    assert bool(calls) == (s.enable_contrast_enhancement and not s.enable_adaptive_binarization)


def _quads(det) -> list[tuple]:
    return sorted(tuple(map(float, b.quad.reshape(-1))) for b in det.boxes)


@pytest.mark.parametrize("mode", [1, 0])
def test_prob_wire_boxes_agree_with_wire4(mode, form_image):
    """tests/test_engine.py's checks, on the port's engine with the same
    page and settings (seeded random weights): the geometry of modes 1 and
    0 matches the 4-bit map's within 1 px, the score gate dropping at most
    two borderline boxes."""
    page = form_image[:256, :256].copy()
    kw = dict(det_image_buckets=(256,), rec_width_buckets=(80, 160), rec_batch_size=8,
              ocr_engine="jax", enable_deskew=False)
    d4 = TorchOCREngine(Settings(**kw, det_prob_wire_bits=4), device="cpu").det_stage(
        [PageImage(page, 1)])[0]
    dm = TorchOCREngine(Settings(**kw, det_prob_wire_bits=mode), device="cpu").det_stage(
        [PageImage(page, 1)])[0]
    q4, qm = _quads(d4), _quads(dm)
    assert dm.canvas_stack is not None
    matched = sum(1 for q in qm if any(np.allclose(q, r, atol=1.0) for r in q4))
    assert matched >= len(qm) - 2
    assert abs(len(qm) - len(q4)) <= 2
