"""The port's slice end to end against the JAX package: the same
training/synth_forms pages through ``JaxOCREngine.process_pages`` and
``TorchOCREngine.process_pages`` with the trained det and rec_latin
checkpoints, converted by ocr_system_tpu_torch/core/weights.py."""

import jax
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.mesh import build_mesh, mesh_context
from ocr_system_tpu.engine.detector import _rotate_host
from ocr_system_tpu.engine.pipeline import JaxOCREngine
from ocr_system_tpu.engine.preprocess import PageImage as JaxPageImage
from ocr_system_tpu.training import synth_forms
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.detector import Detector
from ocr_system_tpu_torch.engine.pipeline import SLICE_SETTINGS, TorchOCREngine
from ocr_system_tpu_torch.engine.preprocess import PageImage
from ocr_system_tpu_torch.engine.recognizer import Recognizer

torch.set_num_threads(1)

SMALL = dict(
    SLICE_SETTINGS,
    det_image_buckets=(256,),
    rec_width_buckets=(80, 160),
    rec_batch_size=8,
    det_checkpoint="checkpoints/det",
    rec_checkpoint="checkpoints/rec_latin",
)


@pytest.fixture(scope="module")
def pages():
    """Synthetic forms at the bucket's size (canvas scale 1: the recognizer
    crops from the det canvases, through the crop kernel's path), one of
    them rotated so the deskew re-pass runs."""
    gen = synth_forms.FormGenerator(seed=3)
    out = []
    for _ in range(3):
        img = synth_forms.render_spec(gen.generate(256)).image
        out.append((np.asarray(img) * 255).round().astype(np.uint8))
    out[1] = _rotate_host(out[1], 4.0)
    return out


def _run(pages, dtype):
    jax_eng = JaxOCREngine(JaxSettings(**SMALL, compute_dtype=dtype))
    tree = lambda v: jax.tree.map(np.asarray, v)  # noqa: E731
    s = Settings(**{**SMALL, "det_checkpoint": "", "rec_checkpoint": ""},
                 compute_dtype=dtype)
    eng = TorchOCREngine(
        s,
        detector=Detector(s, weights.dbnet_state_dict(
            tree(jax_eng.detector.variables)), device="cpu"),
        recognizer=Recognizer(s, weights.svtr_state_dict(
            tree(jax_eng.recognizer.variables)), device="cpu"),
    )
    # one device: the checkpoints restore onto one, so no dp mesh
    with mesh_context(build_mesh("dp=1")):
        ref = jax_eng.process_pages(
            [JaxPageImage(p, i + 1) for i, p in enumerate(pages)])
    got = eng.process_pages([PageImage(p, i + 1) for i, p in enumerate(pages)])
    return ref, got, eng


def _words(out):
    return [b for b in out.layout_boxes if b["type"] == "word"]


def _iou(a, b):
    ax, ay, bx, by = a[0::2], a[1::2], b[0::2], b[1::2]
    ix = max(0.0, min(max(ax), max(bx)) - max(min(ax), min(bx)))
    iy = max(0.0, min(max(ay), max(by)) - max(min(ay), min(by)))
    inter = ix * iy
    area = lambda xs, ys: (max(xs) - min(xs)) * (max(ys) - min(ys))  # noqa: E731
    return inter / max(area(ax, ay) + area(bx, by) - inter, 1e-9)


def test_slice_f32_matches_jax(pages):
    ref, got, eng = _run(pages, "float32")
    # the rotated page took the deskew re-pass
    assert [d.skew_angle != 0 for d in eng.detector.detect_batch(pages)] == [
        False, True, False]
    for r, g in zip(ref, got):
        assert g.success and (g.page_width, g.page_height) == (r.page_width, r.page_height)
        rw, gw = _words(r), _words(g)
        assert len(rw) == len(gw) > 0
        for a, b in zip(rw, gw):
            assert np.abs(np.array(a["polygon"]) - np.array(b["polygon"])).max() <= 1.0
            assert a["content"] == b["content"]
        assert g.markdown == r.markdown


def test_slice_bf16_close_to_jax(pages):
    ref, got, _ = _run(pages, "bfloat16")
    n = same = 0
    for r, g in zip(ref, got):
        assert g.success
        rw, gw = _words(r), _words(g)
        for a in rw:
            n += 1
            best = max(gw, key=lambda b: _iou(a["polygon"], b["polygon"]), default=None)
            if best is not None and _iou(a["polygon"], best["polygon"]) >= 0.9:
                same += a["content"] == best["content"]
    assert n > 0 and same >= 0.95 * n
