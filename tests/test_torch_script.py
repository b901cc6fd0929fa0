"""The port's engine/script.py against the JAX package's, function by
function on the same inputs, exactly: the same booleans and labels, the
same quads bit for bit, the same box counts. Inputs: Hindi and Latin lines
drawn with PIL (the synthetic Devanagari font and DejaVu, as
tests/test_script_routing.py draws them), seeded synthetic forms with
their element boxes padded as det boxes are, and seeded arrays."""

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw, ImageFont

from ocr_system_tpu.engine import script as jax_script
from ocr_system_tpu.ops.boxes import DetectedBox as JaxBox
from ocr_system_tpu.training import synth_forms
from ocr_system_tpu.training.devanagari_font import ensure_font
from ocr_system_tpu_torch.engine import script
from ocr_system_tpu_torch.ops.boxes import DetectedBox

torch.set_num_threads(1)

HINDI_LINES = ["नाम राशि कुल", "ग्राहक भुगतान", "चालान संख्या तारीख"]
LATIN_LINES = ["Name Total Amount", "Customer payment", "Invoice number"]
DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


@pytest.fixture(scope="module")
def fonts():
    return {"deva": ImageFont.truetype(str(ensure_font()), 26),
            "latin": ImageFont.truetype(DEJAVU, 24)}


def _draw(rows, fonts, size=(760, 520)):
    """rows: [(x, font key, text), ...] per line, on a white page -> (page,
    (N, 4, 2) text bboxes, one per drawn run)."""
    img = Image.new("RGB", size, "white")
    d = ImageDraw.Draw(img)
    quads = []
    y = 24
    for row in rows:
        y1 = y
        for x, key, text in row:
            x0, y0, x1, yb = d.textbbox((x, y), text, font=fonts[key])
            d.text((x, y), text, fill="black", font=fonts[key])
            quads.append([[x0, y0], [x1, y0], [x1, yb], [x0, yb]])
            y1 = max(y1, yb)
        y = y1 + 22
    return np.asarray(img, np.uint8).copy(), np.array(quads, np.float32)


def _pad(quads, ratio=0.65, shape=None):
    """Det-style padding: ratio x height on every side, clipped to the page."""
    h = (quads[:, 2, 1] - quads[:, 0, 1])[:, None]
    out = quads.copy()
    out[:, [0, 3], 0] -= ratio * h
    out[:, [1, 2], 0] += ratio * h
    out[:, [0, 1], 1] -= ratio * h
    out[:, [2, 3], 1] += ratio * h
    if shape is not None:
        out[..., 0] = out[..., 0].clip(0, shape[1] - 1)
        out[..., 1] = out[..., 1].clip(0, shape[0] - 1)
    return out


@pytest.fixture(scope="module")
def pages(fonts):
    """name -> (page, quads): Hindi lines, Latin lines, mixed-script rows
    (a Devanagari key and an ASCII value on one row, as on Hindi forms), two
    Latin fields a column apart, and one Hindi word repeated 30 times (ties
    in component counts at page_script's 24-component cut)."""
    out = {
        "hindi": _draw([[(30, "deva", t)] for t in HINDI_LINES], fonts),
        "latin": _draw([[(30, "latin", t)] for t in LATIN_LINES], fonts),
        "mixed": _draw([[(30, "deva", "कुल राशि"), (300, "latin", "51,191.67 USD")],
                        [(30, "deva", "तारीख"), (300, "latin", "2013-02-13")],
                        [(30, "latin", "Phone 827964687")]], fonts),
        "columns": _draw([[(20, "latin", "Name: John"), (480, "latin", "Date: 2020")],
                          [(20, "latin", "Route Tala ....... 5367 Oak")]], fonts),
        "repeated": _draw([[(20 + 180 * k, "deva", "चालान") for k in range(4)]
                           for _ in range(8)], fonts, size=(760, 760)),
    }
    return out


@pytest.fixture(scope="module")
def forms():
    """Seeded synthetic forms at 512 (two Hindi, one Latin) with their
    element boxes, det-padded."""
    out = []
    for seed, deva in ((7, 1.0), (8, 1.0), (6, 0.0)):
        sample = synth_forms.render_spec(
            synth_forms.FormGenerator(seed=seed, deva_fraction=deva).generate(512))
        page = (np.asarray(sample.image) * 255).round().astype(np.uint8)
        quads = _pad(np.asarray(sample.quads, np.float32), 0.3, page.shape)
        out.append((page, quads))
    return out


def _all_inputs(pages, forms):
    return list(pages.values()) + list(forms)


def _boxes(quads, rng=None):
    scores = (np.full(len(quads), 0.9) if rng is None
              else rng.uniform(0.3, 1.0, len(quads)))
    return ([DetectedBox(q.copy(), float(s)) for q, s in zip(quads, scores)],
            [JaxBox(q.copy(), float(s)) for q, s in zip(quads, scores)])


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.quad.dtype == w.quad.dtype and np.array_equal(g.quad, w.quad)
        assert g.score == w.score


def _crops(pages, forms):
    """Every drawn run's padded and tight crops, plus blank and empty ones."""
    out = []
    for page, quads in _all_inputs(pages, forms):
        gray = script._to_gray(page)
        for q in list(quads) + list(_pad(quads, 0.3, gray.shape)):
            out.append(script._crop_aabb(gray, q))
    out += [np.full((20, 60), 250, np.uint8), np.zeros((0, 5), np.uint8),
            np.full((3, 40), 10, np.uint8)]
    return out


def test_gray_and_crops_match_jax(pages, forms):
    for page, quads in _all_inputs(pages, forms):
        gray = script._to_gray(page)
        assert np.array_equal(gray, jax_script._to_gray(page))
        assert script._to_gray(gray) is gray
        for q in np.concatenate([quads, _pad(quads, 2.0)]):
            assert np.array_equal(script._crop_aabb(gray, q), jax_script._crop_aabb(gray, q))


def test_ink_headline_and_crop_script_match_jax(pages, forms):
    crops = _crops(pages, forms)
    heads = scripts = 0
    for c in crops:
        assert np.array_equal(script._ink(c), jax_script._ink(c))
        assert script.has_headline(c) == jax_script.has_headline(c)
        assert script.crop_script(c) == jax_script.crop_script(c)
        heads += script.has_headline(c)
        scripts += script.crop_script(c) == "devanagari"
    assert 0 < heads < len(crops) and 0 < scripts < len(crops)


@pytest.mark.parametrize("seed", range(4))
def test_longest_run_matches_jax(seed):
    """Seeded rows with holes of 1 to 4 pixels, leading and trailing gaps."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 120))
        row = rng.random(n) < rng.uniform(0.3, 0.95)
        for bridge in (0, 1, 2):
            assert script._longest_run(row, bridge) == jax_script._longest_run(row, bridge)
    assert script._longest_run(np.zeros(9, bool)) == 0


def test_page_script_matches_jax(pages, forms):
    got = {}
    for name, (page, quads) in list(pages.items()) + [(f"form{k}", f) for k, f in
                                                      enumerate(forms)]:
        padded = _pad(quads, 0.65, page.shape[:2])
        for q in (quads, padded, quads[:1]):
            want = jax_script.page_script(page, q)
            assert script.page_script(page, q) == want, name
        for sample in (1, 5):
            assert (script.page_script(page, padded, sample)
                    == jax_script.page_script(page, padded, sample)), (name, sample)
        got[name] = script.page_script(page, padded)
    assert script.page_script(pages["latin"][0], np.zeros((0, 4, 2), np.float32)) == "latin"
    blank = np.full((100, 100, 3), 255, np.uint8)
    assert script.page_script(blank, pages["latin"][1][:1]) == "latin"
    assert got["hindi"] == got["repeated"] == got["form0"] == "devanagari"
    assert got["latin"] == got["form2"] == "latin"


def test_page_script_ties_at_the_cut(pages):
    """30 copies of one word: equal component counts across the sample cut
    of 24, taken in the order numpy's default argsort gives both."""
    page, quads = pages["repeated"]
    gray = script._to_gray(page)
    ink = script._ink(gray)
    labels, n = script._label_components(ink)
    cnt = np.bincount(labels.reshape(-1))[1:]
    assert n >= 30 and np.unique(cnt).size < n  # tied counts
    for sample in (7, 24, 25):
        assert (script.page_script(page, quads, sample)
                == jax_script.page_script(page, quads, sample))


def test_tighten_y_matches_jax(pages, forms):
    rng = np.random.default_rng(5)
    for page, quads in _all_inputs(pages, forms):
        padded = _pad(quads, 0.65, page.shape[:2])
        # every third quad rotated (its right side lowered by a fifth to a
        # half of its height): those pass through untouched
        turned = padded.copy()
        drop = rng.uniform(0.2, 0.5, len(turned[::3])) * (turned[::3, 3, 1] - turned[::3, 0, 1])
        turned[::3, 1, 1] += drop
        turned[::3, 2, 1] += drop
        for q in (padded, turned):
            got = script.tighten_y(page, q)
            want = jax_script.tighten_y(page, q)
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(script.tighten_y(page, turned)[::3], turned[::3])
    empty = np.zeros((0, 4, 2), np.float32)
    assert script.tighten_y(page, empty) is empty


def test_split_column_merged_matches_jax(pages, forms):
    page, quads = pages["columns"]
    # each row merged into one box across the column gap, as DBNet's
    # stride-2 map bridges it
    rows = np.array([[[quads[0, 0, 0], quads[0, 0, 1]], [quads[1, 1, 0], quads[0, 0, 1]],
                      [quads[1, 1, 0], quads[0, 2, 1]], [quads[0, 0, 0], quads[0, 2, 1]]],
                     quads[2]], np.float32)
    merged = _pad(rows, 0.3, page.shape[:2])
    got, want = _boxes(merged)
    _same(script.split_column_merged(page, got), jax_script.split_column_merged(page, want))
    assert len(script.split_column_merged(page, got)) == 3  # the leader row stays whole
    for page, quads in _all_inputs(pages, forms):
        got, want = _boxes(_pad(quads, 0.65, page.shape[:2]), np.random.default_rng(1))
        _same(script.split_column_merged(page, got), jax_script.split_column_merged(page, want))
    assert script.split_column_merged(page, []) == []


def test_rows_from_boxes_matches_jax(forms):
    for page, quads in forms:
        got, want = _boxes(quads, np.random.default_rng(2))
        g_rows, w_rows = script._rows_from_boxes(got), jax_script._rows_from_boxes(want)
        assert len(g_rows) == len(w_rows) > 1
        for g, w in zip(g_rows, w_rows):
            _same(g, w)


@pytest.mark.parametrize("seed", range(3))
def test_fit_aspect_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        cols = rng.random(int(rng.integers(40, 600))) < 0.8
        cols[rng.integers(0, len(cols), 5)] = False
        segs = [(0, len(cols))]
        for ink_h, gap, aspect in ((8, 2, 4.0), (12, 3, 12.0), (5, 1, 2.0)):
            assert (script._fit_aspect(segs, cols, ink_h, gap, aspect)
                    == jax_script._fit_aspect(segs, cols, ink_h, gap, aspect))


def _multirow(quads, shape):
    """Boxes covering two or three consecutive drawn runs' rows each."""
    out = []
    for k in range(0, len(quads) - 2, 3):
        q = quads[k: k + 3]
        x0, y0 = q[:, :, 0].min(), q[:, :, 1].min()
        x1, y1 = q[:, :, 0].max(), q[:, :, 1].max()
        out.append([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])
    return _pad(np.array(out, np.float32).reshape(-1, 4, 2), 0.2, shape)


def test_split_multirow_boxes_matches_jax(pages, forms):
    split = 0
    for page, quads in _all_inputs(pages, forms):
        gray = script._to_gray(page)
        for q in (_multirow(quads, gray.shape), _pad(quads, 0.65, gray.shape)):
            got, want = _boxes(q)
            g = script._split_multirow_boxes(gray, got)
            _same(g, jax_script._split_multirow_boxes(gray, want))
            split += len(g) > len(got)
    assert split > 0


def test_split_multirow_boxes_ties_in_cy0():
    """Components whose tops share a row: the row clustering sorts them by
    cy0 with a stable sort, so label (raster) order breaks the ties; marks
    (short blobs) attach to the nearest row."""
    rng = np.random.default_rng(9)
    gray = np.full((120, 400), 250, np.uint8)
    for top in (10, 50, 90):
        xs = np.sort(rng.choice(np.arange(5, 380, 20), 8, replace=False))
        for x in xs:
            h = int(rng.integers(14, 22))
            gray[top: top + h, x: x + 12] = 20  # equal tops, various bottoms
        gray[top - 6: top - 3, xs[0]: xs[0] + 3] = 20  # a mark above the row
    box = np.array([[[0, 0], [399, 0], [399, 119], [0, 119]]], np.float32)
    got, want = _boxes(box)
    g = script._split_multirow_boxes(gray, got)
    _same(g, jax_script._split_multirow_boxes(gray, want))
    assert len(g) == 3


@pytest.mark.parametrize("latin_pad", [None, 0.65])
def test_resegment_devanagari_matches_jax(pages, forms, latin_pad):
    """Det-padded boxes, and multi-row boxes, on the Hindi, mixed-script and
    repeated-word pages and the synthetic forms."""
    for page, quads in [pages["hindi"], pages["mixed"], pages["repeated"], *forms]:
        shape = page.shape[:2]
        for q in (_pad(quads, 0.65, shape), _multirow(quads, shape)):
            got, want = _boxes(q, np.random.default_rng(3))
            for kw in ({}, {"pad_ratio": 0.12}, {"pad_ratio": 0.12, "pad_ratio_y": 0.3}):
                g = script.resegment_devanagari(page, got, latin_pad_ratio=latin_pad, **kw)
                w = jax_script.resegment_devanagari(page, want, latin_pad_ratio=latin_pad, **kw)
                _same(g, w)
    assert script.resegment_devanagari(page, []) == []
