"""The port's slice end to end against the JAX package: the same
training/synth_forms pages through ``JaxOCREngine.process_pages`` and
``TorchOCREngine.process_pages`` with the trained det, rec_latin and
rec_devanagari checkpoints, converted by
ocr_system_tpu_torch/core/weights.py: the neural engine and the hybrid
engine (selection marks, handwriting and glue split on) with Latin
recognition, and the served engine at every serving default (script
routing included) on a wave of Hindi and Latin forms, each built by its
package's ``get_engine`` path from the orbax checkpoints and from their
exported .npz copies."""

import jax
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.mesh import build_mesh, mesh_context
from ocr_system_tpu.engine.detector import _rotate_host
from ocr_system_tpu.engine.pipeline import JaxOCREngine
from ocr_system_tpu.engine.pipeline import _build_engine as jax_build_engine
from ocr_system_tpu.engine.preprocess import PageImage as JaxPageImage
from ocr_system_tpu.training import synth_forms
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.detector import Detector
from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine, get_engine
from ocr_system_tpu_torch.engine.preprocess import PageImage
from ocr_system_tpu_torch.engine.recognizer import Recognizer
from ocr_system_tpu_torch.utils.smoke import (
    BF16_WORD_SHARE,
    LAYOUT_TYPES,
    compare_to_expected,
    draw_checkboxes,
    page_record,
)

from export_torch_weights import draw_forms, run_jax_wave

torch.set_num_threads(1)

# the neural engine alone, with Latin recognition: no classical pass,
# marks, handwriting or glue split
SMALL = dict(
    rec_charset="latin",
    ocr_engine="jax",
    enable_selection_marks=False,
    enable_handwriting_detection=False,
    det_glue_split=False,
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


# the hybrid engine with Latin recognition, at the 512 bucket (at 256 the
# drawn checkboxes fall under the marks' 8 px minimum)
HYBRID = dict(
    rec_charset="latin",
    ocr_engine="hybrid",
    det_image_buckets=(512,),
    rec_width_buckets=(80, 160, 320),
    rec_batch_size=8,
)
REPO_WEIGHTS = "ocr_system_tpu_torch/weights"


@pytest.fixture(scope="module")
def forms():
    """Three synthetic forms at 512 with signature squiggles, a table and
    drawn checkboxes."""
    gen = synth_forms.FormGenerator(seed=6, deva_fraction=0.0)
    rng = np.random.default_rng(6)
    out = []
    for _ in range(3):
        img = synth_forms.render_spec(gen.generate(512)).image
        out.append(draw_checkboxes((np.asarray(img) * 255).round().astype(np.uint8), rng, 4))
    return out


def _run_hybrid(forms, dtype):
    jax_eng = jax_build_engine("hybrid", JaxSettings(
        **HYBRID, compute_dtype=dtype, det_checkpoint="checkpoints/det",
        rec_checkpoint="checkpoints/rec_latin"))
    eng = get_engine(Settings(**HYBRID, compute_dtype=dtype,
                              det_checkpoint=f"{REPO_WEIGHTS}/det.npz",
                              rec_checkpoint=f"{REPO_WEIGHTS}/rec_latin.npz"), device="cpu")
    with mesh_context(build_mesh("dp=1")):
        ref = jax_eng.process_pages([JaxPageImage(p, i + 1) for i, p in enumerate(forms)])
    got = eng.process_pages([PageImage(p, i + 1) for i, p in enumerate(forms)])
    return [page_record(r) for r in ref], [page_record(g) for g in got], eng


def test_hybrid_slice_f32_matches_jax(forms):
    """Every layout box (word, line, table, selection mark, handwriting)
    with its content and state, and the markdown, as the JAX package's
    hybrid engine gives them; polygons within 1 px."""
    ref, got, eng = _run_hybrid(forms, "float32")
    assert set(eng.stage_ms) >= {"det", "det_neural", "det_classical", "rec", "glue", "finish"}
    assert any(r["selection_mark"] for r in ref) and any(r["handwriting"] for r in ref)
    assert any(r["table"] for r in ref)
    for r, g in zip(ref, got):
        for typ in LAYOUT_TYPES:
            assert len(r[typ]) == len(g[typ]), typ
            for a, b in zip(r[typ], g[typ]):
                assert np.abs(np.array(a["polygon"]) - np.array(b["polygon"])).max() <= 1.0
                assert a["content"] == b["content"] and a.get("state") == b.get("state")
        assert r["markdown"] == g["markdown"]


def test_hybrid_slice_bf16_close_to_jax(forms):
    """bf16 serving against the JAX package's bf16: at least 95% of its
    words matched (IoU >= 0.9, same text), and BF16_WORD_SHARE of them with
    dot-leader runs of any length alike, as chip_smoke.py holds the
    committed forms; marks and handwriting equal."""
    ref, got, _ = _run_hybrid(forms, "bfloat16")
    n = matched = leaders = 0
    for r, g in zip(ref, got):
        c = compare_to_expected(r, g)
        n, matched = n + c["words"], matched + c["matched"]
        leaders += c["matched_leaders"]
        assert c["marks_ok"] and c["handwriting_ok"]
    assert n > 0 and matched >= 0.95 * n
    assert leaders >= BF16_WORD_SHARE * n


# the served engine at every serving default: script routing between the
# Latin and the Devanagari recognizer, and its rescues
SERVED = dict(HYBRID, rec_charset="auto")


@pytest.fixture(scope="module")
def mixed(forms):
    """Two Hindi forms at 512 with drawn checkboxes, then a Latin one."""
    return list(draw_forms(7, 2, 1.0, side=512)) + forms[:1]


def _run_served(pages, dtype):
    jax_eng = jax_build_engine("hybrid", JaxSettings(
        **SERVED, compute_dtype=dtype, det_checkpoint="checkpoints/det",
        rec_checkpoint="checkpoints/rec_latin",
        rec_checkpoint_devanagari="checkpoints/rec_devanagari"))
    eng = get_engine(Settings(**SERVED, compute_dtype=dtype,
                              det_checkpoint=f"{REPO_WEIGHTS}/det.npz",
                              rec_checkpoint=f"{REPO_WEIGHTS}/rec_latin.npz",
                              rec_checkpoint_devanagari=f"{REPO_WEIGHTS}/rec_devanagari.npz"),
                     device="cpu")
    with mesh_context(build_mesh("dp=1")):
        ref, routed, rescued = run_jax_wave(
            jax_eng, [JaxPageImage(p, i + 1) for i, p in enumerate(pages)])
    got = eng.process_pages([PageImage(p, i + 1) for i, p in enumerate(pages)])
    return ([page_record(*r) for r in zip(ref, routed, rescued)],
            [page_record(*g) for g in zip(got, eng.routed, eng.rescued)], eng)


def test_mixed_slice_f32_matches_jax(mixed):
    """Every layout box with its content and state, the markdown, each
    word's recognizer and each page's rescue counts, as the JAX package's
    served engine gives them; polygons within 1 px."""
    ref, got, eng = _run_served(mixed, "float32")
    assert set(eng.stage_ms) >= {"det", "route", "rec", "rescue", "glue", "finish"}
    scripts = [{w["recognizer"] for w in r["word"]} for r in ref]
    assert scripts[:2] == [{"latin", "devanagari"}] * 2 and scripts[2] == {"latin"}
    assert sum(r["rescued"]["confidence"][1] for r in ref) > 0
    for r, g in zip(ref, got):
        for typ in LAYOUT_TYPES:
            assert len(r[typ]) == len(g[typ]), typ
            for a, b in zip(r[typ], g[typ]):
                assert np.abs(np.array(a["polygon"]) - np.array(b["polygon"])).max() <= 1.0
                assert a["content"] == b["content"] and a.get("state") == b.get("state")
                assert a.get("recognizer") == b.get("recognizer")
        assert r["markdown"] == g["markdown"]
        assert r["rescued"] == g["rescued"]


def test_mixed_slice_bf16_close_to_jax(mixed):
    """bf16 serving against the JAX package's bf16 on the mixed wave:
    BF16_WORD_SHARE of its words matched with dot-leader runs of any length
    alike, on all pages and on the Hindi pages alone; marks and
    handwriting equal."""
    ref, got, _ = _run_served(mixed, "bfloat16")
    rows = [compare_to_expected(r, g) for r, g in zip(ref, got)]
    assert all(c["marks_ok"] and c["handwriting_ok"] for c in rows)
    for part in (rows, rows[:2]):
        n = sum(c["words"] for c in part)
        assert n > 0 and sum(c["matched_leaders"] for c in part) >= BF16_WORD_SHARE * n
