"""The port's synthetic training data against the JAX package's, byte for
byte at a seed: the form generator and its tokens, the noise functions, the
layout and rec batch iterators, the rendered lines and pages with their DB
targets, the det iterator's parts (page sources, renders, wire encoding)
and the Devanagari font. Rendering uses this machine's PIL and DejaVu fonts
in both packages; the Devanagari font is built by each package's own
builder."""

import dataclasses
import random

import numpy as np
import pytest
import torch

from ocr_system_tpu.models.charsets import get_charset as jax_charset
from ocr_system_tpu.training import devanagari_font as JDF
from ocr_system_tpu.training import synth as JS
from ocr_system_tpu.training import synth_forms as JSF
from ocr_system_tpu.training import train as JT
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.training import devanagari_font as DF
from ocr_system_tpu_torch.training import synth as S
from ocr_system_tpu_torch.training import synth_forms as SF
from ocr_system_tpu_torch.training import train as T

torch.set_num_threads(1)
# the port always lists its committed Devanagari font; the JAX renderer
# lists its own once it exists, so build it before comparing renders
JDF.ensure_font()

# (seed, deva_fraction): a Latin generator and one with Hindi forms
GENERATORS = [(0, None), (5, 0.5)]


def _generator(mod, seed, deva):
    return mod.FormGenerator(seed=seed) if deva is None else mod.FormGenerator(
        seed=seed, deva_fraction=deva)


def _equal_arrays(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


@pytest.mark.parametrize("seed,deva", GENERATORS)
def test_form_specs_and_tokens_equal_jax(seed, deva):
    """FormGenerator.generate, noisy_spec, spec_to_tokens (with OCR noise and
    coordinate jitter), spec_to_word_boxes and spec_ocr_text: equal, field by
    field and byte for byte, over 6 forms."""
    gens = _generator(SF, seed, deva), _generator(JSF, seed, deva)
    cs, jcs = get_charset("multilingual"), jax_charset("multilingual")
    for i in range(6):
        spec, jspec = (g.generate(640 + 160 * (i % 3)) for g in gens)
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
        rate = 0.02 * i
        noisy = SF.noisy_spec(spec, random.Random(i), rate)
        assert dataclasses.asdict(noisy) == dataclasses.asdict(
            JSF.noisy_spec(jspec, random.Random(i), rate))
        got = SF.spec_to_tokens(spec, cs, 512, rate, random.Random(i), coord_jitter=True)
        want = JSF.spec_to_tokens(jspec, jcs, 512, rate, random.Random(i), coord_jitter=True)
        for a, b in zip(got, want, strict=True):
            _equal_arrays(a, b, "tokens")
        assert SF.spec_to_word_boxes(spec, rate, random.Random(i)) == \
            JSF.spec_to_word_boxes(jspec, rate, random.Random(i))
        assert SF.spec_ocr_text(spec, rate, random.Random(i)) == \
            JSF.spec_ocr_text(jspec, rate, random.Random(i))


@pytest.mark.parametrize("seed,deva", GENERATORS)
def test_layout_batch_iterator_equal_jax(seed, deva):
    """layout_batch_iterator: three batches (8 x 256, pos_offset windows
    over 2048) equal the JAX iterator's, key by key, byte for byte."""
    kw = dict(max_len=256, seed=seed, pos_span=2048, deva_fraction=deva)
    got = T.layout_batch_iterator(get_charset("multilingual"), 8, **kw)
    want = JT.layout_batch_iterator(jax_charset("multilingual"), 8, **kw)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.keys() == b.keys()
        for k in a:
            _equal_arrays(a[k], b[k], k)


def test_text_renderer_equal_jax():
    """TextRenderer.render_line (augmented and not), render_page and
    make_db_targets: equal images, texts, widths, quads and DB targets."""
    r, jr = S.TextRenderer(get_charset("latin"), seed=3), JS.TextRenderer(
        jax_charset("latin"), seed=3)
    for i in range(6):
        kw = dict(max_width=320, augment=i % 3 != 2)
        a, b = r.render_line(**kw), jr.render_line(**kw)
        assert (a.text, a.width) == (b.text, b.width)
        _equal_arrays(a.image, b.image, "line")
    for size in (128, 192):
        a, b = r.render_page(size=size), jr.render_page(size=size)
        assert a.texts == b.texts
        for f in ("image", "quads", "shrink_map", "shrink_mask", "thresh_map", "thresh_mask"):
            _equal_arrays(getattr(a, f), getattr(b, f), f)
        for x, y in zip(S.make_db_targets(size, a.quads, 0.5),
                        JS.make_db_targets(size, b.quads, 0.5), strict=True):
            _equal_arrays(x, y, "db targets")
        cs, jcs = get_charset("multilingual"), jax_charset("multilingual")
        for x, y in zip(S.layout_page_to_tokens(a, cs, 128, size),
                        JS.layout_page_to_tokens(b, jcs, 128, size), strict=True):
            _equal_arrays(x, y, "page tokens")


def test_rec_batch_iterator_equal_jax():
    """rec_batch_iterator (pool of 4 x batch, refreshed between batches):
    three batches of 6 lines at width 160 equal the JAX iterator's."""
    kw = dict(width=160, seed=4, refresh_per_step=3)
    got = T.rec_batch_iterator(get_charset("latin"), 6, **kw)
    want = JT.rec_batch_iterator(jax_charset("latin"), 6, **kw)
    for _ in range(3):
        a, b = next(got), next(want)
        for k in b:
            _equal_arrays(a[k], b[k], k)


def _jax_render_one(sources, size, forms_fraction=0.5, deva_fraction=0.0):
    """The JAX det iterator's page render and wire encoding
    (training/train.det_batch_iterator.render_one), written out: the
    function is local to the iterator there."""
    renderer, gen, r, deva = sources
    roll = r.random()
    if deva is not None and roll >= 1.0 - deva_fraction:
        page = deva.render_page(size=size, augment=False)
    elif roll >= forms_fraction:
        page = renderer.render_page(size=size, augment=False)
    else:
        page = JSF.render_spec(gen.generate(size), augment=False)
    to_u8 = lambda a: np.clip(a * 255.0, 0, 255).astype(np.uint8)  # noqa: E731
    to_bits = lambda a: np.packbits(a > 0.5, axis=-1)  # noqa: E731
    g4 = to_u8(page.image[..., 0]) >> 4
    return ((g4[:, 0::2] << 4 | g4[:, 1::2]).astype(np.uint8),
            to_bits(page.shrink_map), to_bits(page.shrink_mask),
            to_u8(page.thresh_map)[::2, ::2], to_bits(page.thresh_mask))


@pytest.mark.parametrize("deva_fraction", [0.0, 0.4])
def test_det_iterator_parts_equal_jax(deva_fraction):
    """The det iterator's pool is filled by two racing workers in both
    packages, so its batch order is not deterministic; its parts are: each
    worker's page sources, text pages, form pages (render_spec) and
    Devanagari pages, and their wire encoding, over 6 pages of 128 px."""
    seed = 104729 + 2
    sources = T.det_page_sources(seed, None, deva_fraction)
    jsources = (JS.TextRenderer(jax_charset("latin"), seed=seed), JSF.FormGenerator(seed=seed),
                np.random.default_rng(seed),
                JS.TextRenderer(jax_charset("devanagari"), seed=seed + 7)
                if deva_fraction > 0 else None)
    for _ in range(6):
        got = T.det_render_one(sources, 128, 0.5, deva_fraction)
        want = _jax_render_one(jsources, 128, 0.5, deva_fraction)
        for a, b in zip(got, want, strict=True):
            _equal_arrays(a, b, "wire")
    it = T.det_batch_iterator(2, size=64, seed=1, pool_size=4)
    batch = next(it)
    it.close()
    assert batch["images"].shape == (2, 64, 32) and batch["thresh_map"].shape == (2, 32, 32)
    assert batch["noise_seed"].dtype == np.int32


def test_devanagari_font_equal_jax(tmp_path):
    """build_font writes the same glyph outlines, advances and character map
    in both packages; ensure_font builds into the shared assets/fonts/, and
    Devanagari lines render alike."""
    from fontTools.ttLib import TTFont

    a = TTFont(DF.build_font(tmp_path / "port.ttf"))
    b = TTFont(JDF.build_font(tmp_path / "jax.ttf"))
    assert a.getGlyphOrder() == b.getGlyphOrder()
    assert a.getBestCmap() == b.getBestCmap()
    assert a["hmtx"].metrics == b["hmtx"].metrics
    for name in a.getGlyphOrder():
        ga, gb = a["glyf"][name], b["glyf"][name]
        assert ga.getCoordinates(a["glyf"]) == gb.getCoordinates(b["glyf"]), name
    assert DF.ensure_font() == JDF.ensure_font()
    r, jr = (S.TextRenderer(get_charset("devanagari"), seed=9),
             JS.TextRenderer(jax_charset("devanagari"), seed=9))
    for _ in range(3):
        x, y = r.render_line(max_width=320), jr.render_line(max_width=320)
        assert x.text == y.text
        _equal_arrays(x.image, y.image, "devanagari line")
