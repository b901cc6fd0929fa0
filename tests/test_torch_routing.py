"""Script routing in the port's engine against JaxOCREngine's on the same
det boxes, pages and weights: the per-page and per-box recognizer choice
and the Devanagari re-segmentation (``_route_and_normalize``), the
fallback to Latin without Devanagari weights, recognition grouped by
recognizer with both rescue passes (``_recognize``: the same dispatches,
crop for crop, and the same results), and the masked dispatch through
``Recognizer.recognize_on_device_stack``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu.core.mesh import build_mesh, mesh_context
from ocr_system_tpu.engine.detector import DetResult as JaxDet
from ocr_system_tpu.engine.pipeline import JaxOCREngine
from ocr_system_tpu.engine.pipeline import _build_engine as jax_build_engine
from ocr_system_tpu.ops.boxes import DetectedBox as JaxBox
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.classical_detector import ClassicalDetector
from ocr_system_tpu_torch.engine.detector import DetResult
from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine, box_recognizers, get_engine
from ocr_system_tpu_torch.ops.boxes import DetectedBox
from ocr_system_tpu_torch.utils.profiler import SPANS, span

from export_torch_weights import draw_forms, jax_wave_probe

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WEIGHTS = REPO / "ocr_system_tpu_torch" / "weights"
SMALL = dict(det_image_buckets=(512,), rec_width_buckets=(80, 160, 320), rec_batch_size=8)
JAX_CKPT = dict(det_checkpoint=str(REPO / "checkpoints/det"),
                rec_checkpoint=str(REPO / "checkpoints/rec_latin"),
                rec_checkpoint_devanagari=str(REPO / "checkpoints/rec_devanagari"))
PORT_CKPT = dict(det_checkpoint=str(WEIGHTS / "det.npz"),
                 rec_checkpoint=str(WEIGHTS / "rec_latin.npz"),
                 rec_checkpoint_devanagari=str(WEIGHTS / "rec_devanagari.npz"))


@pytest.fixture(scope="module")
def pages():
    """Two Hindi forms and one Latin form at 512, with drawn checkboxes."""
    return list(draw_forms(7, 2, 1.0, side=512)) + list(draw_forms(6, 1, 0.0, side=512))


@pytest.fixture(scope="module")
def classical_boxes(pages):
    """Each page's classical det boxes (the same inputs for both engines)."""
    return [d.boxes for d in ClassicalDetector(Settings()).detect_batch(pages)]


def _port_dets(pages, boxes):
    from ocr_system_tpu_torch.engine.host_image import rgb_to_gray

    return [DetResult(boxes=[DetectedBox(b.quad.copy(), b.score) for b in bs], skew_angle=0.0,
                      page=p, gray=rgb_to_gray(p)) for p, bs in zip(pages, boxes)]


def _jax_dets(pages, boxes):
    from ocr_system_tpu_torch.engine.host_image import rgb_to_gray

    return [JaxDet(boxes=[JaxBox(b.quad.copy(), b.score) for b in bs], skew_angle=0.0,
                   page=p, gray=rgb_to_gray(p)) for p, bs in zip(pages, boxes)]


def _names(routing, n):
    rows = routing if isinstance(routing, list) else [routing] * n
    return [r.charset.name for r in rows]


def _same_boxes(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(x.quad, y.quad) and x.score == y.score


ROUTE_CASES = [
    {},
    {"det_split_column_gaps": True},
    {"deva_percrop_routing": False},
    {"rec_charset": "devanagari"},
    {"rec_charset": "latin", "det_split_column_gaps": True},
]


@pytest.mark.parametrize("update", ROUTE_CASES)
def test_route_and_normalize_matches_jax(pages, classical_boxes, update):
    """Each page's recognizer choice (per page or per box), and the boxes
    after re-segmentation (Hindi pages) or the column split (Latin pages),
    as JaxOCREngine gives them; on the whole wave (the thread pool) and on
    one page."""
    jax_eng = JaxOCREngine(JaxSettings(**SMALL, **update,
                                       rec_checkpoint_devanagari=JAX_CKPT[
                                           "rec_checkpoint_devanagari"]))
    eng = TorchOCREngine(Settings(**SMALL, **update,
                                  rec_checkpoint_devanagari=PORT_CKPT[
                                      "rec_checkpoint_devanagari"]), device="cpu")
    for idx in ([0, 1, 2], [0]):
        sub = [pages[i] for i in idx]
        dets = _port_dets(sub, [classical_boxes[i] for i in idx])
        jdets = _jax_dets(sub, [classical_boxes[i] for i in idx])
        got = eng._route_and_normalize(dets)
        want = jax_eng._route_and_normalize(sub, jdets)
        names = []
        for d, jd, g, w in zip(dets, jdets, got, want):
            _same_boxes(d.boxes, jd.boxes)
            assert isinstance(g, list) == isinstance(w, list)
            names.append(_names(g, len(d.boxes)))
            assert names[-1] == _names(w, len(jd.boxes))
        if not update and len(idx) == 3:
            # Hindi pages route per box to both recognizers; the Latin page
            # keeps its boxes and the Latin recognizer
            assert all({"latin", "devanagari"} == set(n) for n in names[:2])
            assert set(names[2]) == {"latin"}
            assert len(dets[2].boxes) == len(classical_boxes[2])


def test_without_devanagari_weights_every_page_routes_to_latin(pages, classical_boxes, tmp_path):
    """rec_charset "auto" with no Devanagari weights (none named, none at
    <checkpoint_dir>/rec_devanagari.npz): no second recognizer, every page
    to the primary one with its boxes untouched, and no rescue."""
    eng = TorchOCREngine(Settings(**SMALL, checkpoint_dir=str(tmp_path)), device="cpu")
    assert eng.devanagari is None
    dets = _port_dets(pages, classical_boxes)
    assert eng._route_and_normalize(dets) == [eng.recognizer] * len(pages)
    for d, boxes in zip(dets, classical_boxes):
        _same_boxes(d.boxes, boxes)
    jax_eng = JaxOCREngine(JaxSettings(**SMALL, checkpoint_dir=str(tmp_path)))
    assert jax_eng._route_and_normalize(pages, _jax_dets(pages, classical_boxes)) == [
        jax_eng.recognizer] * len(pages)
    # the default probe finds an exported copy by its file name
    (tmp_path / "rec_devanagari.npz").write_bytes(
        Path(PORT_CKPT["rec_checkpoint_devanagari"]).read_bytes())
    found = TorchOCREngine(Settings(**SMALL, checkpoint_dir=str(tmp_path)), device="cpu")
    assert found.devanagari.charset.name == "devanagari"


@pytest.fixture(scope="module")
def engines():
    s = dict(SMALL, compute_dtype="float32")
    jax_eng = jax_build_engine("hybrid", JaxSettings(**s, **JAX_CKPT))
    eng = get_engine(Settings(**s, **PORT_CKPT), device="cpu")
    return jax_eng, eng


def _mirror(jdets, eng, jax_eng):
    """The JAX det stage's routed DetResults as the port's, canvases too."""
    by_name = {jax_eng.recognizer.charset.name: eng.recognizer, "devanagari": eng.devanagari}
    stack = torch.from_numpy(np.array(jdets[0].canvas_stack))  # one stack, as the det stage's
    out = []
    for d in jdets:
        r = d.routing
        routing = [by_name[x.charset.name] for x in r] if isinstance(r, list) else by_name[
            r.charset.name]
        out.append(DetResult(
            boxes=[DetectedBox(b.quad.copy(), b.score) for b in d.boxes], skew_angle=d.skew_angle,
            page=np.asarray(d.page), canvas_stack=stack,
            canvas_row=d.canvas_row, canvas_scale=d.canvas_scale, gray=d.gray, routing=routing))
    return out


@pytest.mark.parametrize("wave,rescue", [([0, 1, 2], "confidence"), ([2], "digit_glyph")])
def test_rescues_match_jax(pages, engines, wave, rescue):
    """Recognition grouped by recognizer, then the rescue: on a mixed wave
    (two Hindi forms and a Latin one) the confidence rescue, on a Latin
    wave the digit-glyph rescue. Same dispatches (recognizer and quads,
    crop for crop), same texts, and the same crops re-decoded and replaced
    per page."""
    from ocr_system_tpu.engine.preprocess import PageImage as JaxPageImage

    jax_eng, eng = engines
    sub = [JaxPageImage(pages[i], k + 1) for k, i in enumerate(wave)]
    with mesh_context(build_mesh("dp=1")), jax_wave_probe(jax_eng) as probe:
        jdets = jax_eng.det_stage(sub)
        quads_list = [np.array([b.quad for b in d.boxes], np.float32).reshape(-1, 4, 2)
                      for d in jdets]
        want = jax_eng._recognize(sub, jdets, quads_list, [d.routing for d in jdets])
    dets = _mirror(jdets, eng, jax_eng)
    calls = []
    eng._recognize_with = lambda rec, d, q: calls.append(
        (rec.charset.name, [np.array(x) for x in q])) or TorchOCREngine._recognize_with(
        eng, rec, d, q)
    try:
        got, rescued = eng._recognize(dets, quads_list, [d.routing for d in dets])
    finally:
        del eng._recognize_with
    assert len(calls) == len(probe["calls"]) >= 2
    for (gn, gq), (wn, wq) in zip(calls, probe["calls"]):
        assert gn == wn and all(np.array_equal(a, b) for a, b in zip(gq, wq))
    for g_row, w_row in zip(got, want):
        assert [r.text for r in g_row] == [r.text for r in w_row]
        np.testing.assert_allclose([r.confidence for r in g_row],
                                   [r.confidence for r in w_row], atol=1e-4)
    assert rescued == probe["rescued"]
    assert sum(r[rescue][0] for r in rescued) > 0
    if rescue == "confidence":
        assert {n for n, _ in calls} == {"latin", "devanagari"}


def test_masked_dispatch_matches_unmasked(engines):
    """recognize_on_device_stack with most stack rows empty (the sparse-wave
    compaction the rescues' masked dispatches reach) gives each crop the
    result it gets when every row holds quads."""
    from ocr_system_tpu_torch.utils.smoke import draw_page

    _, eng = engines
    rng = np.random.default_rng(11)
    stack = torch.from_numpy(np.stack([draw_page(rng, 256, 256)[..., 0] for _ in range(8)]))
    quads = []
    for _ in range(8):
        x0 = rng.uniform(5, 120, 6)
        y0 = rng.uniform(5, 220, 6)
        w, h = rng.uniform(20, 120, 6), rng.uniform(10, 24, 6)
        quads.append(np.stack([np.stack([x0, y0], -1), np.stack([x0 + w, y0], -1),
                               np.stack([x0 + w, y0 + h], -1), np.stack([x0, y0 + h], -1)],
                              1).astype(np.float32))
    full = eng.recognizer.recognize_on_device_stack(stack, quads)
    keep = [1, 5]
    masked = [q if i in keep else np.zeros((0, 4, 2), np.float32) for i, q in enumerate(quads)]
    sparse = eng.recognizer.recognize_on_device_stack(stack, masked)
    for i in range(8):
        if i not in keep:
            assert sparse[i] == []
            continue
        assert [r.text for r in sparse[i]] == [r.text for r in full[i]]
        np.testing.assert_allclose([r.confidence for r in sparse[i]],
                                   [r.confidence for r in full[i]], atol=1e-6)


@pytest.fixture(scope="module")
def wave(engines):
    """test_masked_dispatch_matches_unmasked's stack of 8 drawn pages, 6
    axis-aligned quads a row, and every crop's result from the full stack."""
    from ocr_system_tpu_torch.utils.smoke import draw_page

    rng = np.random.default_rng(11)
    stack = torch.from_numpy(np.stack([draw_page(rng, 256, 256)[..., 0] for _ in range(8)]))
    quads = []
    for _ in range(8):
        x0 = rng.uniform(5, 120, 6)
        y0 = rng.uniform(5, 220, 6)
        w, h = rng.uniform(20, 120, 6), rng.uniform(10, 24, 6)
        quads.append(np.stack([np.stack([x0, y0], -1), np.stack([x0 + w, y0], -1),
                               np.stack([x0 + w, y0 + h], -1), np.stack([x0, y0 + h], -1)],
                              1).astype(np.float32))
    return stack, quads, engines[1].recognizer.recognize_on_device_stack(stack, quads)


def _rectangle_slots(row_quads, buckets, h_rec):
    """Σ over width buckets of (rows holding quads × the bucket's largest
    count on one row): the slots of axis-aligned quads' ragged rectangles."""
    buckets = np.asarray(sorted(buckets))
    per_row = []
    for q in row_quads:
        if len(q):
            w = np.linalg.norm(q[:, 1] - q[:, 0], axis=1)
            aspect = w / np.linalg.norm(q[:, 3] - q[:, 0], axis=1)
            b = np.searchsorted(buckets, np.clip(aspect * h_rec, 16, buckets[-1]))
            per_row.append(np.bincount(b, minlength=len(buckets)))
    return len(per_row) * int(np.max(per_row, axis=0).sum())


@pytest.mark.parametrize("case", ["dense", "sparse", "host_pages"])
def test_dispatch_runs_the_ragged_rectangle(engines, wave, case):
    """A group's batch is the stack rows that hold quads × its largest count
    on one row, with no page, row or count padding beyond it: ``rec.slots``
    over one recorded dispatch equals that sum, on a dense wave with counts
    that are no powers of two, a sparse wave (2 of 8 rows) and host pages
    (one of 3 without quads); every crop reads as from the full stack."""
    stack, quads, full = wave
    rec = engines[1].recognizer
    empty = np.zeros((0, 4, 2), np.float32)
    if case == "dense":
        counts = (3, 5, 6, 3, 6, 5, 3, 6)
        row_quads = [q[:c] for q, c in zip(quads, counts)]
        want = [f[:c] for f, c in zip(full, counts)]
    elif case == "sparse":
        row_quads = [q if i in (1, 5) else empty for i, q in enumerate(quads)]
        want = [f if i in (1, 5) else [] for i, f in enumerate(full)]
    else:
        pages = [np.repeat(stack[i].numpy()[..., None], 3, -1) for i in (0, 2, 3)]
        row_quads = [quads[0], empty, quads[3][:5]]
        want = [full[0], [], full[3][:5]]
    SPANS.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]), \
            span("dispatch"):
        got = (rec.recognize_pages(pages, row_quads) if case == "host_pages"
               else rec.recognize_on_device_stack(stack, row_quads))
    total = {k: sum(s.counts.get(k, 0) for s in SPANS.spans) for k in ("rec.crops", "rec.slots")}
    SPANS.clear()
    assert total["rec.crops"] == sum(len(q) for q in row_quads)
    assert total["rec.slots"] == _rectangle_slots(
        row_quads, rec.settings.rec_width_buckets, rec.settings.rec_image_height)
    for g, w in zip(got, want):
        assert [r.text for r in g] == [r.text for r in w]
        np.testing.assert_allclose([r.confidence for r in g], [r.confidence for r in w],
                                   atol=1e-6)


def test_box_recognizers_names_every_box(pages, classical_boxes):
    eng = TorchOCREngine(Settings(**SMALL, **{k: PORT_CKPT[k] for k in (
        "rec_checkpoint_devanagari",)}), device="cpu")
    dets = _port_dets(pages[:1], classical_boxes[:1])
    dets[0].routing = eng._route_and_normalize(dets)[0]
    names = box_recognizers(dets[0])
    assert len(names) == len(dets[0].boxes) and set(names.values()) == {"latin", "devanagari"}
    assert list(names) == [tuple(b.flat_polygon()) for b in dets[0].boxes]


def test_whole_page_routing_matches_jax(pages):
    """deva_percrop_routing off: Hindi pages go wholly to the Devanagari
    recognizer, so a Hindi-only wave uses one recognizer that is not the
    primary and runs neither rescue; the same words, recognizers and
    (zero) rescue counts as the JAX engine."""
    from ocr_system_tpu.engine.preprocess import PageImage as JaxPageImage
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.utils.smoke import page_record

    from export_torch_weights import run_jax_wave

    s = dict(SMALL, compute_dtype="float32", deva_percrop_routing=False)
    jax_eng = jax_build_engine("hybrid", JaxSettings(**s, **JAX_CKPT))
    eng = get_engine(Settings(**s, **PORT_CKPT), device="cpu")
    with mesh_context(build_mesh("dp=1")):
        ref = run_jax_wave(jax_eng, [JaxPageImage(p, i + 1) for i, p in enumerate(pages[:2])])
    got = eng.process_pages([PageImage(p, i + 1) for i, p in enumerate(pages[:2])])
    want = [page_record(*r) for r in zip(*ref)]
    have = [page_record(*r) for r in zip(got, eng.routed, eng.rescued)]
    assert eng.stage_ms["rescue"] == 0.0
    for w, h in zip(want, have):
        assert {x["recognizer"] for x in h["word"]} == {"devanagari"}
        assert [(x["content"], x["recognizer"]) for x in h["word"]] == [
            (x["content"], x["recognizer"]) for x in w["word"]]
        assert h["rescued"] == w["rescued"] == {"confidence": [0, 0], "digit_glyph": [0, 0]}
