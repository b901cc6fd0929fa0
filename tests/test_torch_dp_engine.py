"""The port's engine with its pages split over dp, on the fixtures of
tests/test_torch_slice.py at float32: the neural engine and the served
engine (hybrid detection, script routing between both recognizers, marks,
handwriting and glue split) at dp=4 on a mesh of repeated ``cpu`` devices
give the words, polygons and markdown of the same engine at dp=1, and the
words of the JAX package's engine under ``mesh_context(build_mesh("dp=4"))``
on its 8-device CPU mesh; each wave (3 pages) is padded to 4 with a white
page. The page scheduler's det worker serves under the caller's mesh."""

import jax
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.mesh import build_mesh as jax_build_mesh
from ocr_system_tpu.core.mesh import mesh_context as jax_mesh_context
from ocr_system_tpu.engine.pipeline import JaxOCREngine
from ocr_system_tpu.engine.pipeline import _build_engine as jax_build_engine
from ocr_system_tpu.engine.preprocess import PageImage as JaxPageImage
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.core.mesh import ShardedBatch, build_mesh, mesh_context
from ocr_system_tpu_torch.engine.detector import Detector
from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine
from ocr_system_tpu_torch.engine.preprocess import PageImage
from ocr_system_tpu_torch.engine.recognizer import Recognizer
from ocr_system_tpu_torch.engine.scheduler import PageScheduler
from ocr_system_tpu_torch.utils.smoke import LAYOUT_TYPES, new_engine, page_record

from test_torch_slice import SERVED, SMALL, forms, mixed, pages  # noqa: F401

torch.set_num_threads(1)

tree = lambda v: jax.tree.map(np.asarray, v)  # noqa: E731


def _dp4():
    return build_mesh("dp=4", ["cpu"] * 4)


def _uncommitted(jax_eng):
    """The JAX engine's restored weights as host arrays: the checkpoints
    restore onto one device, which a dp=4 jit refuses beside its sharded
    pages; host arrays are placed by the jit."""
    det = getattr(jax_eng.detector, "neural", jax_eng.detector)
    det.variables = tree(det.variables)
    for rec in (jax_eng.recognizer, jax_eng._devanagari_recognizer()):
        if rec is not None:
            rec.variables = tree(rec.variables)
    return jax_eng


def _records(outs, eng=None):
    if eng is None:
        return [page_record(o) for o in outs]
    return [page_record(*r) for r in zip(outs, eng.routed, eng.rescued)]


def _words(rec):
    return [(w["content"], tuple(w["polygon"])) for w in rec["word"]]


def _assert_same(a, b):
    for r, g in zip(a, b):
        for typ in LAYOUT_TYPES:
            assert r[typ] == g[typ], typ
        assert r["markdown"] == g["markdown"]


def _assert_words_like_jax(ref, got):
    for r, g in zip(ref, got):
        assert len(r["word"]) == len(g["word"]) > 0
        for a, b in zip(r["word"], g["word"]):
            assert a["content"] == b["content"]
            assert np.abs(np.array(a["polygon"]) - np.array(b["polygon"])).max() <= 1.0


def test_neural_engine_dp4(pages):  # noqa: F811
    """The neural engine (one page turned, so the deskew re-pass runs
    sharded too) at dp=4 against dp=1, and against the JAX engine at dp=4;
    the det canvases stay split for the recognizer."""
    jax_eng = _uncommitted(JaxOCREngine(JaxSettings(**SMALL, compute_dtype="float32")))
    s = Settings(**{**SMALL, "det_checkpoint": "", "rec_checkpoint": ""},
                 compute_dtype="float32")
    det_sd = weights.dbnet_state_dict(tree(jax_eng.detector.variables))
    rec_sd = weights.svtr_state_dict(tree(jax_eng.recognizer.variables))

    def port():
        return TorchOCREngine(s, detector=Detector(s, det_sd, device="cpu"),
                              recognizer=Recognizer(s, rec_sd, device="cpu"))

    wave = [PageImage(p, i + 1) for i, p in enumerate(pages)]
    one = _records(port().process_pages(wave))
    eng = port()
    with mesh_context(_dp4()):
        dets = eng.det_stage(wave)
        assert isinstance(dets[0].canvas_stack, ShardedBatch)
        assert dets[0].canvas_stack.shape[0] == 4 and [d.skew_angle != 0 for d in dets] == [
            False, True, False]
        four = _records(eng.rec_stage(wave, dets))
    _assert_same(one, four)
    with jax_mesh_context(jax_build_mesh("dp=4")):
        ref = _records(jax_eng.process_pages(
            [JaxPageImage(p, i + 1) for i, p in enumerate(pages)]))
    _assert_words_like_jax(ref, four)


def test_served_engine_dp4(mixed):  # noqa: F811
    """The served engine on the mixed wave (two Hindi forms, a Latin one):
    both recognizers crop from the split stack; words, boxes, routing and
    rescue counts at dp=4 as at dp=1, and the words and routing as the JAX
    served engine's at dp=4."""
    cfg = dict(SERVED, compute_dtype="float32")
    jax_eng = _uncommitted(jax_build_engine("hybrid", JaxSettings(
        **cfg, det_checkpoint="checkpoints/det", rec_checkpoint="checkpoints/rec_latin",
        rec_checkpoint_devanagari="checkpoints/rec_devanagari")))
    wave = [PageImage(p, i + 1) for i, p in enumerate(mixed)]
    eng1 = new_engine("cpu", **cfg)
    one = _records(eng1.process_pages(wave), eng1)
    eng4 = new_engine("cpu", **cfg)
    with mesh_context(_dp4()):
        four = _records(eng4.process_pages(wave), eng4)
    assert eng1.detector.neural._mesh() is None and eng4.detector.neural._mesh() is not None
    _assert_same(one, four)
    assert [r["rescued"] for r in one] == [r["rescued"] for r in four]
    assert {w["recognizer"] for r in four for w in r["word"]} == {"latin", "devanagari"}
    from export_torch_weights import run_jax_wave

    with jax_mesh_context(jax_build_mesh("dp=4")):
        ref, routed, rescued = run_jax_wave(
            jax_eng, [JaxPageImage(p, i + 1) for i, p in enumerate(mixed)])
    ref = [page_record(*r) for r in zip(ref, routed, rescued)]
    _assert_words_like_jax(ref, four)
    for r, g in zip(ref, four):
        assert [w["recognizer"] for w in r["word"]] == [w["recognizer"] for w in g["word"]]


def test_scheduler_serves_under_the_callers_mesh(pages):  # noqa: F811
    """PageScheduler.process at dp=4 (two waves of 2 pages; its det worker
    thread sees the caller's mesh) gives the pages of the dp=1 run."""
    cfg = {k: v for k, v in SMALL.items() if not k.endswith("checkpoint")}
    wave = [PageImage(p, i + 1) for i, p in enumerate(pages)] + [PageImage(pages[0], 4)]
    eng1 = new_engine("cpu", **cfg, compute_dtype="float32", det_batch_size=2)
    one = _records(PageScheduler(eng1, eng1.settings).process(wave))
    eng = new_engine("cpu", **cfg, compute_dtype="float32", det_batch_size=2)
    sched = PageScheduler(eng, eng.settings)
    with mesh_context(_dp4()):
        four = _records(sched.process(wave))
    assert sched.stats.waves == 2 and eng.detector._mesh() is not None
    _assert_same(one, four)
