"""The port's detection and page-finishing passes against the JAX
package's, one function at a time on the same seeded pages, boxes and
texts: the classical detector, the hybrid merge, the page components,
selection marks, handwriting and glue split; and the exported weights
against the orbax checkpoints they came from."""

import copy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.engine import classical_detector as jax_classical
from ocr_system_tpu.engine import glue_split as jax_glue
from ocr_system_tpu.engine import handwriting as jax_hand
from ocr_system_tpu.engine import hybrid_detector as jax_hybrid
from ocr_system_tpu.engine import selection_marks as jax_marks
from ocr_system_tpu.engine.detector import Detector as JaxDetector
from ocr_system_tpu.engine.detector import _rotate_host
from ocr_system_tpu.engine.recognizer import Recognizer as JaxRecognizer
from ocr_system_tpu.extract import postfix as jax_postfix
from ocr_system_tpu.ops.boxes import DetectedBox as JaxBox
from ocr_system_tpu.training import synth_forms
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine import classical_detector, glue_split, handwriting
from ocr_system_tpu_torch.engine import hybrid_detector, selection_marks
from ocr_system_tpu_torch.engine.host_image import rgb_to_gray
from ocr_system_tpu_torch.extract import postfix
from ocr_system_tpu_torch.ops.boxes import DetectedBox
from ocr_system_tpu_torch.utils.smoke import draw_checkboxes

from export_torch_weights import glued_lines_page

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def forms():
    """Three synthetic forms at 512 (signature squiggles among their
    fields) with drawn checkboxes, and a fourth turned by 3 degrees."""
    gen = synth_forms.FormGenerator(seed=6, deva_fraction=0.0)
    rng = np.random.default_rng(6)
    out = []
    for _ in range(3):
        img = synth_forms.render_spec(gen.generate(512)).image
        out.append(draw_checkboxes((np.asarray(img) * 255).round().astype(np.uint8), rng, 4))
    out.append(_rotate_host(out[0], 3.0))
    return out


def _same_boxes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.quad, y.quad) and x.score == y.score


def test_classical_detector_matches_jax(forms):
    """Every page, the turned one through the classical deskew too."""
    s = Settings(ocr_engine="classical", rec_charset="latin")
    got = classical_detector.ClassicalDetector(s).detect_batch(forms)
    want = jax_classical.ClassicalDetector(JaxSettings(ocr_engine="classical")).detect_batch(forms)
    assert [g.skew_angle != 0 for g in got] == [False, False, False, True]
    for g, w in zip(got, want):
        assert g.skew_angle == w.skew_angle
        _same_boxes(g.boxes, w.boxes)
        assert len(g.boxes) > 5


@pytest.mark.parametrize("page", range(4))
def test_classical_steps_match_jax(forms, page):
    p = forms[page]
    mask = classical_detector._ink_mask(p)
    assert np.array_equal(mask, jax_classical._ink_mask(p))
    assert (classical_detector._estimate_char_height(mask)
            == jax_classical._estimate_char_height(mask))
    assert classical_detector._estimate_skew_host(p) == jax_classical._estimate_skew_host(p)
    for k in (3, 4, 7, 8):  # odd and even kernels
        assert np.array_equal(classical_detector._dilate_horizontal(mask, k),
                              jax_classical._dilate_horizontal(mask, k))


def _random_boxes(rng, n, cls):
    out = []
    for _ in range(n):
        x, y = rng.uniform(0, 400), rng.uniform(0, 400)
        w, h = rng.uniform(10, 80), rng.uniform(8, 30)
        quad = np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h]], np.float32)
        out.append(cls(quad=quad, score=float(rng.choice([0.5, 0.6, 0.7, 0.9]))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_merge_boxes_matches_jax(seed):
    """Containment dedup, the score cap and a stable sort with many ties."""
    rng = np.random.default_rng(seed)
    neural = _random_boxes(rng, 40, DetectedBox)
    classical = _random_boxes(rng, 60, DetectedBox)
    # some classical boxes inside neural ones
    for k in range(0, 40, 4):
        q = neural[k].quad.copy()
        q[:, 0] += [2, -2, -2, 2]
        classical[k] = DetectedBox(quad=q, score=0.9)
    as_jax = lambda bs: [JaxBox(quad=b.quad.copy(), score=b.score) for b in bs]  # noqa: E731
    for cap in (512, 50):
        got = hybrid_detector.merge_boxes(neural, classical, max_boxes=cap)
        want = jax_hybrid.merge_boxes(as_jax(neural), as_jax(classical), max_boxes=cap)
        _same_boxes(got, want)


@pytest.mark.parametrize("page", range(4))
def test_page_components_match_jax(forms, page):
    """On the RGB page and on its luma (the det stage passes the luma)."""
    for view in (forms[page], rgb_to_gray(forms[page])):
        got = selection_marks.page_components(view)
        want = jax_marks.page_components(view)
        assert got[2] == want[2] > 0
        for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert np.array_equal(g, w)


def _word_boxes(page, seed):
    """Word layout boxes on the page's classical boxes, with a mix of clean
    printed text, symbol soup and empty decodes."""
    rng = np.random.default_rng(seed)
    boxes = jax_classical.ClassicalDetector(JaxSettings(enable_deskew=False)).detect_batch([page])[0].boxes
    texts = ["Date", "Signature:", "\\W^M", "", "Total Amount", "12/31", "Y4", "O", "(Rev)"]
    out = []
    for b in boxes:
        out.append({"type": "word", "content": str(rng.choice(texts)),
                    "confidence": float(rng.choice([0.5, 0.8, 0.95])),
                    "polygon": [float(v) for v in b.quad.reshape(-1)], "page_number": 1})
    return out


@pytest.mark.parametrize("page", range(4))
def test_selection_marks_match_jax(forms, page):
    p = forms[page]
    cc = selection_marks.page_components(p)
    got = selection_marks.detect_selection_marks(p, 2, cc=cc)
    want = jax_marks.detect_selection_marks(p, 2)
    assert got == want
    words = _word_boxes(p, page)
    assert (selection_marks.filter_marks_against_words(got, words)
            == jax_marks.filter_marks_against_words(want, words))


def test_forms_carry_marks_and_handwriting(forms):
    """The inputs exercise both passes: drawn checkboxes in both states
    and signature squiggles."""
    marks = [m for p in forms for m in selection_marks.detect_selection_marks(p)]
    hands = [h for p in forms for h in handwriting.detect_handwriting(p, [])]
    assert {m["state"] for m in marks} == {"selected", "unselected"}
    assert len(hands) >= 2


@pytest.mark.parametrize("page", range(4))
def test_handwriting_matches_jax(forms, page):
    p = forms[page]
    words = _word_boxes(p, 10 + page)
    for ws in ([], words):
        got = handwriting.detect_handwriting(p, ws, 3, cc=selection_marks.page_components(p))
        assert got == jax_hand.detect_handwriting(p, ws, 3)


@pytest.mark.parametrize("text", ["Yes", "Signature:", "\\W^M", "Date 12/31", "mary novak",
                                  "O'Brien", "Q&A", "printed words here", "2Aucr"])
def test_is_clean_text_matches_jax(text):
    for conf in (0.5, 0.8, 0.95):
        for geom in ((None, None), (200.0, 20.0), (30.0, 20.0)):
            assert (handwriting._is_clean_text(text, conf, *geom)
                    == jax_hand._is_clean_text(text, conf, *geom))


@pytest.mark.parametrize("key", ["Blood Type:", "Signature..........", "0rigin", "lndex",
                                 "ImPortant SupPort:", "McDonald", "Date . . ...  ", "5 lbs",
                                 "Ph0ne Number", "", "AIice", "siIva@acme.com"])
def test_postfix_keys_match_jax(key):
    assert postfix.clean_key(key) == jax_postfix.clean_key(key)
    for label in ("Blood Type", "Physician", "Insurance ID", ""):
        assert postfix._cer(label, key) == jax_postfix._cer(label, key)


def test_form_key_lexicon_matches_jax():
    assert postfix.FORM_KEY_LEXICON == jax_postfix.FORM_KEY_LEXICON


def _glued_page():
    """A white page with text-like ink in two column groups per row, the
    rows' quads and decodes: some carry a known label glued to a value."""
    rng = np.random.default_rng(7)
    gray = np.full((200, 420), 245, np.uint8)
    quads, texts = [], []
    decodes = ["mary novakBlood Type:", "john smithPhysician:", "plain prose, no label",
               "12 Main StInsurance ID:", "x:", "ABCDEFGHIJ:"]
    for r, text in enumerate(decodes):
        y = 10 + 30 * r
        gap = int(rng.integers(110, 160))
        for x0, x1 in ((10, gap), (gap + int(rng.integers(8, 20)), 400)):
            x = x0
            while x < x1 - 6:  # glyph bars with small gaps
                gray[y + 3:y + 17, x:x + 4] = 20
                x += int(rng.integers(6, 9))
        quads.append(np.array([[5, y], [405, y], [405, y + 20], [5, y + 20]], np.float32))
        texts.append(text)
    return gray, quads, texts


def test_plan_splits_matches_jax():
    gray, quads, texts = _glued_page()
    got = glue_split.plan_splits(gray, [DetectedBox(q, 0.9) for q in quads], texts)
    want = jax_glue.plan_splits(gray, [JaxBox(q, 0.9) for q in quads], texts)
    assert len(got) == len(want) >= 2
    for (gi, gl, gr, glab), (wi, wl, wr, wlab) in zip(got, want):
        assert gi == wi and glab == wlab
        assert np.array_equal(gl, wl) and np.array_equal(gr, wr)
    for text in texts + ["Total AmountDue Date:", "abc"]:
        g, w = glue_split.find_glued_label(text), jax_glue.find_glued_label(text)
        assert (g is None) == (w is None)
        if g is not None:
            assert (g.char_start, g.label) == (w.char_start, w.label)


def test_exported_weights_equal_the_checkpoints():
    """weights/*.npz (export_torch_weights.py) equal the orbax checkpoints,
    loaded by the JAX package and converted, array for array."""
    from ocr_system_tpu.models.charsets import get_charset

    tree = lambda v: jax.tree.map(np.asarray, v)  # noqa: E731
    s = JaxSettings(det_checkpoint=str(REPO / "checkpoints/det"),
                    rec_checkpoint=str(REPO / "checkpoints/rec_latin"), rec_charset="latin")
    deva = JaxRecognizer(s.model_copy(update={
        "rec_checkpoint": str(REPO / "checkpoints/rec_devanagari")}),
        charset=get_charset("devanagari"))
    for name, want in (
        ("det", weights.dbnet_state_dict(tree(JaxDetector(s).variables))),
        ("rec_latin", weights.svtr_state_dict(tree(JaxRecognizer(s).variables))),
        ("rec_devanagari", weights.svtr_state_dict(tree(deva.variables))),
    ):
        got = weights.load_npz(REPO / "ocr_system_tpu_torch" / "weights" / f"{name}.npz")
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == torch.float32
            assert torch.equal(got[k], want[k]), (name, k)


def test_hybrid_detector_uses_the_neural_page(forms):
    """The hybrid pass hands the classical detector the neural pass's
    (deskewed) page and keeps the neural pass's page, luma and components."""
    s = Settings(rec_charset="latin", det_image_buckets=(512,))
    det = hybrid_detector.HybridDetector(s, device="cpu")
    seen = []
    det.classical.detect_batch = lambda pages: seen.extend(pages) or [
        copy.copy(r) for r in classical_detector.ClassicalDetector(s).detect_batch(pages)]
    out = det.detect_batch(forms[3:])
    assert seen[0] is out[0].page and out[0].cc is not None and out[0].gray is not None
    assert set(det.stage_ms) == {"det_neural", "det_classical"}


def test_classical_pass_re_deskews_the_neural_page():
    """Committed smoke form 1 is turned by 2 degrees in the neural pass;
    the classical pass then estimates -1 degree on that page and turns it
    again, in both packages alike, so its boxes live in a frame 1 degree
    off the neural boxes' (the reference's behaviour, kept)."""
    from ocr_system_tpu_torch.utils.smoke import NEURAL, build_engine, smoke_forms

    form = smoke_forms()[0][0]
    neural = build_engine("cpu", **NEURAL).detector.detect_batch([form])[0]
    assert neural.skew_angle == 2.0
    got = classical_detector.ClassicalDetector(Settings(rec_charset="latin")).detect_batch(
        [neural.page])[0]
    want = jax_classical.ClassicalDetector(JaxSettings()).detect_batch([neural.page])[0]
    assert got.skew_angle == want.skew_angle == -1.0
    _same_boxes(got.boxes, want.boxes)


def test_split_glued_matches_jax():
    """Glue split end to end: plan on the luma, re-recognize both halves
    with the trained rec weights, keep a split only where the right half
    still reads as the label; the port's boxes and decodes after the pass
    equal the JAX package's."""
    from ocr_system_tpu.engine.detector import DetResult as JaxDet
    from ocr_system_tpu.engine.pipeline import JaxOCREngine
    from ocr_system_tpu.engine.recognizer import RecResult as JaxRec
    from ocr_system_tpu_torch.engine.detector import DetResult
    from ocr_system_tpu_torch.engine.recognizer import RecResult
    from ocr_system_tpu_torch.utils.smoke import NEURAL, build_engine

    page, quads, texts = glued_lines_page()
    gray = rgb_to_gray(page)
    jax_eng = JaxOCREngine(JaxSettings(rec_charset="latin", compute_dtype="float32",
                                       rec_checkpoint=str(REPO / "checkpoints/rec_latin")))
    eng = build_engine("cpu", **NEURAL, compute_dtype="float32")
    jdet = [JaxDet(boxes=[JaxBox(q.copy(), 0.8) for q in quads], skew_angle=0.0, page=page,
                   gray=gray)]
    jrecs = [[JaxRec(t, 0.9) for t in texts]]
    jax_eng._split_glued([None], jdet, jrecs, [jax_eng.recognizer])
    det = [DetResult(boxes=[DetectedBox(q.copy(), 0.8) for q in quads], skew_angle=0.0,
                     page=page, gray=gray)]
    recs = [[RecResult(t, 0.9) for t in texts]]
    eng._split_glued(det, recs, [eng.recognizer])
    assert len(jdet[0].boxes) > len(quads)  # the pass split something
    assert [r.text for r in recs[0]] == [r.text for r in jrecs[0]]
    _same_boxes(det[0].boxes, jdet[0].boxes)


def test_glued_lines_asset_matches_jax():
    """The committed glued-lines page is the one above, and the port's glue
    split of it equals the committed JAX record at float32 (chip_smoke.py
    holds the card to the same record)."""
    from ocr_system_tpu_torch.engine.detector import DetResult
    from ocr_system_tpu_torch.engine.recognizer import RecResult
    from ocr_system_tpu_torch.utils.smoke import NEURAL, build_engine, glued_lines

    page, quads, texts, want = glued_lines()
    built_page, built_quads, built_texts = glued_lines_page()
    assert np.array_equal(page, built_page) and np.array_equal(quads, built_quads)
    assert texts == built_texts
    eng = build_engine("cpu", **NEURAL, compute_dtype="float32")
    det = [DetResult(boxes=[DetectedBox(q.copy(), want["score"]) for q in quads],
                     skew_angle=0.0, page=page, gray=rgb_to_gray(page))]
    recs = [[RecResult(t, want["confidence"]) for t in texts]]
    eng._split_glued(det, recs, [eng.recognizer])
    assert len(det[0].boxes) > len(quads)
    assert [r.text for r in recs[0]] == want["float32"]["texts"]
    assert [b.quad.tolist() for b in det[0].boxes] == want["float32"]["quads"]


def test_split_glued_skips_pages_not_routed_to_the_primary():
    """Glue split runs on pages routed to the primary (Latin) recognizer
    only: a page routed elsewhere, as a whole or per box, keeps its boxes
    and decodes."""
    from ocr_system_tpu_torch.engine.detector import DetResult
    from ocr_system_tpu_torch.engine.recognizer import RecResult
    from ocr_system_tpu_torch.utils.smoke import NEURAL, build_engine

    page, quads, texts = glued_lines_page()
    eng = build_engine("cpu", **NEURAL, compute_dtype="float32")
    assert eng.devanagari is not None
    for routing in (eng.devanagari, [eng.recognizer] * len(quads)):
        det = [DetResult(boxes=[DetectedBox(q.copy(), 0.8) for q in quads], skew_angle=0.0,
                         page=page, gray=rgb_to_gray(page))]
        recs = [[RecResult(t, 0.9) for t in texts]]
        eng._split_glued(det, recs, [routing])
        assert [r.text for r in recs[0]] == texts
        assert [b.quad.tolist() for b in det[0].boxes] == [q.tolist() for q in quads]
