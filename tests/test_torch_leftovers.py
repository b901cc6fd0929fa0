"""The port's counterparts of the last JAX functions without one, against
the JAX package on the CPU: ``compress_to_limit`` (bytes equal, at budgets
that end in its quality loop and budgets that end in its resize loop, the
halving being ``host_image.resize_bicubic_pil``, which equals PIL's
``Image.resize`` bit for bit), ``extract_table_fields`` (equal fields on
tests/test_tables.py's grid and on seeded grids), and the text-PDF font:
with the system font directories made to miss, the renderer draws in the
package's DejaVu (``engine/pdf.FONTS_SERVED``) and renders the parity
tests' text PDF pixel for pixel as the JAX package does, which is also the
committed render that the card's run reports against."""


import numpy as np
import pytest
import torch
from PIL import Image

from ocr_system_tpu.engine import pdf as jax_pdf
from ocr_system_tpu.engine import preprocess as jax_pre
from ocr_system_tpu.extract import tables as jax_tables
from ocr_system_tpu_torch.engine import host_image, pdf, preprocess
from ocr_system_tpu_torch.extract import tables
from ocr_system_tpu_torch.utils import smoke

from test_torch_pdf import text_pdf

torch.set_num_threads(1)


def _inputs():
    rng = np.random.default_rng(21)
    forms, _ = smoke.smoke_forms()
    return {
        "form_rgb": forms[2],
        "form_gray": np.ascontiguousarray(forms[5][..., 0]),
        "noise_tall": rng.integers(0, 256, (300, 90, 3), dtype=np.uint8),
        "noise_wide": rng.integers(0, 256, (70, 410), dtype=np.uint8),
        "small": rng.integers(0, 256, (40, 50, 3), dtype=np.uint8),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_resize_bicubic_pil_equals_pil(name):
    img = INPUTS[name]
    h, w = img.shape[:2]
    for nh, nw in ((h // 2, w // 2), (max(h // 2, 64), max(w // 2, 64)), (h // 3 + 1, 2 * w + 1),
                   (17, 9), (h, w // 2), (h // 2, w)):
        want = np.asarray(Image.fromarray(img).resize((nw, nh)))
        assert np.array_equal(host_image.resize_bicubic_pil(img, (nh, nw)), want), (nh, nw)


def _quality_sizes(img) -> dict[int, int]:
    return {q: len(jax_pre.encode_jpeg(img, q)) for q in range(95, 25, -10)}


@pytest.mark.parametrize("name", ["form_rgb", "form_gray", "noise_tall", "noise_wide"])
def test_compress_to_limit_bytes_equal_jax(name):
    img = INPUTS[name]
    sizes = _quality_sizes(img)
    budgets = {
        "fits_at_95": sizes[95],
        "fits_at_65": sizes[65],
        "fits_at_35": sizes[35],
        "one_halving": sizes[35] - 1,
        "several_halvings": sizes[35] // 20,
        "down_to_64": 10,
    }
    ends = set()
    for label, budget in budgets.items():
        got = preprocess.compress_to_limit(img, budget)
        want = jax_pre.compress_to_limit(img, budget)
        assert got == want, label
        ends.add(len(got) <= budget)
    assert ends == {True, False}  # a budget too small ends at width 64


def test_compress_to_limit_default_budget():
    img = INPUTS["form_rgb"]
    assert preprocess.compress_to_limit(img) == jax_pre.compress_to_limit(img)


def _word(text, x, y, w=40, h=12, page=1):
    return {"type": "word", "content": text, "confidence": 0.95,
            "polygon": [x, y, x + w, y, x + w, y + h, x, y + h], "page_number": page}


def _grid(cols_x=(50, 200, 350), rows_y=(100, 130, 160, 190)):
    """tests/test_tables.py's make_grid."""
    return [_word(f"r{r}c{c}", x, y) for r, y in enumerate(rows_y) for c, x in enumerate(cols_x)]


def _seeded_boxes(seed: int) -> list[dict]:
    """Two grids of seeded size and pitch on one page, with stray words."""
    rng = np.random.default_rng(seed)
    boxes = []
    y0 = 40
    for _ in range(2):
        cols = np.cumsum(rng.integers(90, 180, int(rng.integers(2, 5)))) + 20
        rows = y0 + np.arange(int(rng.integers(2, 6))) * int(rng.integers(24, 34))
        boxes += [_word(f"v{int(rng.integers(0, 999))}", int(x), int(y))
                  for y in rows for x in cols]
        y0 = int(rows[-1]) + 120
    boxes += [_word("note", int(rng.integers(0, 500)), int(rng.integers(0, 900)))
              for _ in range(3)]
    return boxes


@pytest.mark.parametrize("boxes", [_grid(), _grid(cols_x=(50, 250))]
                         + [_seeded_boxes(s) for s in range(6)])
def test_extract_table_fields_equals_jax(boxes):
    got = [f.to_dict() for f in tables.extract_table_fields(tables.find_tables(boxes))]
    want = [f.to_dict() for f in
            jax_tables.extract_table_fields(jax_tables.find_tables(boxes))]
    assert got == want
    assert got and all(f["field_type"] == "table" for f in got)


def test_text_pdf_uses_the_package_fonts_when_the_system_has_none(monkeypatch):
    package = pdf.FONT_DIRS[0]
    monkeypatch.setattr(pdf, "FONT_DIRS", (package, "/nonexistent/dejavu", "/nonexistent/mpl"))
    monkeypatch.setattr(pdf, "FONTS_SERVED", type(pdf.FONTS_SERVED)())
    data, dpi = text_pdf(), smoke.TEXT_PDF_DPI
    got = pdf.render_pdf(data, dpi=dpi)
    served = set(pdf.FONTS_SERVED)
    assert served and all(p.startswith(package) and p.endswith(".ttf") for p in served)
    assert {p.rsplit("/", 1)[1] for p in served} <= {"DejaVuSans.ttf", "DejaVuSans-Bold.ttf"}
    want = jax_pdf.render_pdf(data, dpi=dpi)
    assert len(got) == len(want) == 1 and np.array_equal(got[0], want[0])
    assert np.array_equal(got[0][..., 0], smoke.text_pdf_render())
    assert smoke.text_pdf() == data


def test_package_fonts_are_the_system_fonts():
    """The package's DejaVu files are this host's system files, byte for byte
    (so the package-first search changes nothing here)."""
    import os

    for name in ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf"):
        system = os.path.join("/usr/share/fonts/truetype/dejavu", name)
        if not os.path.isfile(system):
            pytest.skip("no system DejaVu on this host")
        with open(system, "rb") as a, open(os.path.join(pdf.FONT_DIRS[0], name), "rb") as b:
            assert a.read() == b.read()
