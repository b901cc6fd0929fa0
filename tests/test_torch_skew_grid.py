"""The skew search's candidate grid and the served detector's skew angles
against the JAX package's, bit for bit.

``image_ops.skew_candidates`` builds the 31 candidate angles and their
tangents on the host in float32 as XLA compiles ``jnp.linspace`` and
``jnp.tan(jnp.deg2rad(.))``: the angles for any grid, the tangents at the
default grid (elsewhere a tangent may be a few ulps off XLA's compiled
chain, which only moves the scores). Then the served ``Detector`` on the
seeded skewed pages of ``test_torch_preprocess_chain`` (a straight page,
the stair layout, pages turned by 7, -4, -5 and -10 degrees) against the
JAX ``Detector`` with the trained DBNet at float32: the forward's angles
and ``DetResult.skew_angle`` bit for bit, and the deskewed page within the
one gray level of ``rotate_cubic`` against cv2 (ROADMAP Queue 3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.mesh import build_mesh, mesh_context
from ocr_system_tpu.engine.detector import Detector as JaxDetector
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.detector import Detector, _letterbox_host
from ocr_system_tpu_torch.ops import image_ops
from ocr_system_tpu_torch.utils import smoke
from test_torch_preprocess_chain import DESKEW_PAGES

torch.set_num_threads(1)

BUCKET = 320
DEFAULT = (15.0, 31)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    assert a.dtype == np.float32
    return a.view(np.uint32)


@pytest.mark.parametrize("max_angle,num", [DEFAULT, (10.0, 21), (5.0, 11), (20.0, 41),
                                           (45.0, 91), (3.7, 31), (15.0, 64)])
def test_candidates_equal_the_compiled_linspace(max_angle, num):
    got = image_ops.skew_candidates(max_angle, num)
    want = jax.jit(lambda: jnp.linspace(-max_angle, max_angle, num))()
    assert got.shape == (2, num)
    assert np.array_equal(_bits(got[0]), _bits(want))


def test_default_grid_and_tangents_equal_xla():
    """At the default grid, the eager linspace too, and every tangent equal
    to XLA's compiled float32 ``tan`` of the float32 radians."""
    got = image_ops.skew_candidates(*DEFAULT)
    angles = jnp.linspace(-DEFAULT[0], DEFAULT[0], DEFAULT[1])
    assert np.array_equal(_bits(got[0]), _bits(angles))
    tans = jax.jit(lambda: jnp.tan(jnp.deg2rad(jnp.linspace(-15.0, 15.0, 31))))()
    assert np.array_equal(_bits(got[1]), _bits(tans))


def _u8(page: np.ndarray) -> np.ndarray:
    gray = (np.clip(page, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return np.ascontiguousarray(np.stack([gray] * 3, axis=-1) if gray.ndim == 2 else gray)


@pytest.fixture(scope="module")
def served():
    """Both detectors' forward angles and detect_batch results on the
    skewed pages, once."""
    kw = dict(det_image_buckets=(BUCKET,), compute_dtype="float32")
    port = Detector(Settings(det_checkpoint=smoke.TRAINED["det_checkpoint"], **kw), device="cpu")
    ref = JaxDetector(JaxSettings(det_checkpoint="checkpoints/det", **kw))
    names = sorted(DESKEW_PAGES)
    pages = [_u8(DESKEW_PAGES[n]) for n in names]
    canvases = np.stack([_letterbox_host(p, BUCKET)[0] for p in pages])
    fwd = ref._forward(BUCKET, len(canvases))(jnp.asarray(ref._pack_wire(canvases)), ref.variables)
    angles = {
        "port": dict(zip(names, port._forward(port._pack_wire(canvases))["angles"].numpy())),
        "jax": dict(zip(names, np.asarray(fwd[-2]))),
    }
    with mesh_context(build_mesh("dp=1")):
        want = ref.detect_batch(pages)
    dets = {"port": dict(zip(names, port.detect_batch(pages))), "jax": dict(zip(names, want))}
    return angles, dets


@pytest.mark.parametrize("name", sorted(DESKEW_PAGES))
def test_served_angles_equal_the_jax_detector(name, served):
    angles, dets = served
    got, want = angles["port"][name], angles["jax"][name]
    assert np.array_equal(_bits(got), _bits(want))
    a, b = dets["port"][name], dets["jax"][name]
    # the applied angle reaches DetResult unrounded: the float32 candidate
    assert a.skew_angle == b.skew_angle
    if name in ("straight", "stair"):
        assert a.skew_angle == 0.0
    else:
        assert a.skew_angle == float(got) != 0.0
        assert float(got) in {float(v) for v in -image_ops.skew_candidates()[0]}
    assert a.page.shape == b.page.shape
    assert np.abs(a.page.astype(np.int16) - b.page.astype(np.int16)).max() <= 1


def test_skew_record_is_the_port_search():
    """The JAX record that chip_smoke.py's skew gate holds the card to
    (``smoke_forms_expected.json``, "skew": the JAX served detector on the
    committed forms and the turned copies of ``utils/smoke.SKEW_TURNS``)
    is what the port's search gives on the same 4-bit wire canvases, bit
    for bit, and each applied angle is the estimate inside the deskew
    gate, else 0."""
    from ocr_system_tpu_torch.engine.detector import (
        MAX_DESKEW_DEG, MIN_DESKEW_DEG, unpack_wire)
    from ocr_system_tpu_torch.kernels.enhance import to_unit

    want = smoke.smoke_forms()[1]["skew"]
    names, pages = smoke.skew_pages()
    assert names == [r["name"] for r in want["pages"]]
    assert [smoke.digest({"page": p}) for p in pages] == [r["digest"] for r in want["pages"]]
    det = Detector(Settings(det_image_buckets=(want["bucket"],)), device="cpu")
    packed = det._pack_wire(np.stack([_letterbox_host(p, want["bucket"])[0] for p in pages]))
    got = image_ops.estimate_skew_angle(
        to_unit(unpack_wire(torch.from_numpy(packed), det.settings.det_wire_bits))).numpy()
    est = np.array([r["estimate"] for r in want["pages"]], np.float32)
    assert np.array_equal(_bits(got), _bits(est))
    gate = (np.abs(est) >= MIN_DESKEW_DEG) & (np.abs(est) <= MAX_DESKEW_DEG)
    assert [r["applied"] for r in want["pages"]] == np.where(gate, est, 0.0).tolist()
    # the turned pages reach candidates where torch's grid differs
    assert {float(v) for v in got} >= {-5.000000476837158, -9.000000953674316,
                                       1.9999990463256836}
