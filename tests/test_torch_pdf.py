"""The port's PDF rasterization and JPEG encoding against the JAX
package's: ``render_pdf``, ``_pdf_extract_images`` and ``load_document``
pixel for pixel on the PDFs of tests/test_pdf_render.py (text, compressed
text, scanned, rotated), a two-page scan and the committed upload PDF
(whose two tiers agree, pixel for pixel, with the committed forms' gray);
the parser, the stream decoders, object streams and ToUnicode CMaps on
seeded inputs; and ``encode_jpeg``, a first-party encoder, against PIL's
JPEG writer."""

import base64
import io
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from ocr_system_tpu.engine import pdf as jax_pdf
from ocr_system_tpu.engine import preprocess as jax_pre
from ocr_system_tpu_torch.engine import jpeg
from ocr_system_tpu_torch.engine import pdf
from ocr_system_tpu_torch.engine import preprocess
from ocr_system_tpu_torch.utils import smoke

torch.set_num_threads(1)


def _build_pdf(objects: list[bytes]) -> bytes:
    """Numbered objects (1..n) as a classic-xref PDF (tests/test_pdf_render.py)."""
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objects, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref_at = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objects) + 1)
    out += b"".join(b"%010d 00000 n \n" % off for off in offsets)
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF"
            % (len(objects) + 1, xref_at))
    return bytes(out)


def _stream_obj(sdict: bytes, payload: bytes) -> bytes:
    return sdict + b"\nstream\n" + payload + b"\nendstream"


def text_pdf(compress: bool = False, rotate: int = 0) -> bytes:
    content = (
        b"BT /F1 24 Tf 72 700 Td (INVOICE 2024-001) Tj ET\n"
        b"BT /F1 14 Tf 72 650 Td (Total Amount: $1,234.56) Tj ET\n"
        b"BT /F1 14 Tf 72 620 Td [(Customer:) -500 (Jane Doe)] TJ ET\n"
        b"1 w 70 600 m 400 600 l S\n"
        b"0.8 g 70 520 200 40 re f\n"
    )
    if compress:
        body = zlib.compress(content)
        stream = _stream_obj(b"<< /Length %d /Filter /FlateDecode >>" % len(body), body)
    else:
        stream = _stream_obj(b"<< /Length %d >>" % len(content), content)
    return _build_pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Rotate %d "
        b"/Resources << /Font << /F1 4 0 R >> >> /Contents 5 0 R >>" % rotate,
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
        stream,
    ])


def _jpeg(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    return buf.getvalue()


def scanned_jpeg_pdf() -> bytes:
    """One embedded JPEG placed over the page via cm + Do."""
    img = np.full((100, 200), 255, np.uint8)
    img[50, 20:180] = 0
    data = _jpeg(img)
    content = b"q 612 0 0 792 0 0 cm /Im0 Do Q"
    return _build_pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] "
        b"/Resources << /XObject << /Im0 4 0 R >> >> /Contents 5 0 R >>",
        _stream_obj(b"<< /Type /XObject /Subtype /Image /Width 200 /Height 100 "
                    b"/ColorSpace /DeviceGray /BitsPerComponent 8 "
                    b"/Filter /DCTDecode /Length %d >>" % len(data), data),
        _stream_obj(b"<< /Length %d >>" % len(content), content),
    ])


def seeded_scan() -> bytes:
    """Two pages of seeded gray strokes as a Flate-coded scan (the upload
    PDF's layout, at a small size)."""
    rng = np.random.default_rng(3)
    pages = []
    for h, w in ((120, 90), (64, 100)):
        p = np.full((h, w), 250, np.uint8)
        for _ in range(12):
            y, x = int(rng.integers(0, h - 4)), int(rng.integers(0, w - 20))
            p[y: y + 3, x: x + int(rng.integers(5, 20))] = int(rng.integers(0, 80))
        pages.append(p)
    return smoke.scanned_pdf(pages)


PDFS = {
    "text": (text_pdf(), 150),
    "text_compressed": (text_pdf(True), 150),
    "text_rotated": (text_pdf(True, rotate=90), 100),
    "scanned_jpeg": (scanned_jpeg_pdf(), 72),
    "scanned_flate": (seeded_scan(), 72),
}


def _same_pages(a: list[np.ndarray], b: list[np.ndarray]) -> None:
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.uint8 and x.shape == y.shape
        assert np.array_equal(x, y)


@pytest.mark.parametrize("name", sorted(PDFS))
def test_render_pdf_matches_jax(name):
    data, dpi = PDFS[name]
    got, want = pdf.render_pdf(data, dpi=dpi), jax_pdf.render_pdf(data, dpi=dpi)
    _same_pages(got, want)
    assert (got[0][..., 0] < 128).sum() > 100  # the page has ink


@pytest.mark.parametrize("name", sorted(PDFS))
def test_pdf_extract_images_matches_jax(name):
    data, _ = PDFS[name]
    got, want = preprocess._pdf_extract_images(data), jax_pre._pdf_extract_images(data)
    assert len(got) == len(want)
    if want:
        _same_pages(got, want)


@pytest.mark.parametrize("name", sorted(PDFS))
def test_load_document_matches_jax(name):
    data, dpi = PDFS[name]
    got = preprocess.load_document(data, "doc.pdf", dpi=dpi)
    want = jax_pre.load_document(data, "doc.pdf", dpi=dpi)
    assert [(p.page_number, p.dpi) for p in got] == [(p.page_number, p.dpi) for p in want]
    _same_pages([p.pixels for p in got], [p.pixels for p in want])
    assert preprocess.pdf_page_count(data) == jax_pre.pdf_page_count(data)


def test_rasterize_counts_the_tier_that_served():
    """Here PIL renders: the text PDF and the scans are served by the
    renderer; a PDF whose content the renderer cannot read (an unknown
    filter) but which embeds a Flate image falls through to the
    extractor, as in the JAX package."""
    before = dict(preprocess.RASTER_TIERS)
    preprocess.rasterize_pdf(PDFS["text"][0], 72)
    assert preprocess.RASTER_TIERS["render"] == before.get("render", 0) + 1
    img = zlib.compress(np.full((20, 30), 40, np.uint8).tobytes())
    draw = b"q 30 0 0 20 0 0 cm /Im0 Do Q"
    data = _build_pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 30 20] "
        b"/Resources << /XObject << /Im0 4 0 R >> >> /Contents 5 0 R >>",
        _stream_obj(b"<< /Type /XObject /Subtype /Image /Width 30 /Height 20 /ColorSpace "
                    b"/DeviceGray /BitsPerComponent 8 /Filter /FlateDecode /Length %d >>"
                    % len(img), img),
        _stream_obj(b"<< /Filter /JBIG2Decode /Length %d >>" % len(draw), draw),
    ])
    pages = preprocess.rasterize_pdf(data, 72)
    want = jax_pre.rasterize_pdf(data, 72)
    _same_pages([p.pixels for p in pages], [p.pixels for p in want])
    assert preprocess.RASTER_TIERS["embedded"] == before.get("embedded", 0) + 1


def test_upload_pdf_tiers_agree_with_the_forms():
    """The committed upload PDF: at SERVICE_DPI the renderer pastes each page
    image 1:1, so both tiers give the committed forms' gray, in both
    packages."""
    forms, _ = smoke.smoke_forms()
    data = smoke.SERVICE_UPLOAD.read_bytes()
    gray = [np.repeat(f[..., :1], 3, axis=2) for f in forms]
    for tier in (pdf.render_pdf(data, dpi=smoke.SERVICE_DPI), preprocess._pdf_extract_images(data),
                 jax_pdf.render_pdf(data, dpi=smoke.SERVICE_DPI),
                 jax_pre._pdf_extract_images(data)):
        _same_pages(tier, gray)
    assert preprocess.pdf_page_count(data) == len(forms)


# ---- the parser and the decoders on seeded inputs ----


def _plain(v):
    """A parsed PDF value of either package as comparable Python data."""
    if isinstance(v, dict):
        return {str(k): _plain(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_plain(x) for x in v]
    if type(v).__name__ == "Ref":
        return ("R", tuple(v))
    if type(v).__name__ == "Name":
        return ("/", str(v))
    return v


def _outcome(fn, *args):
    try:
        return ("ok", _plain(fn(*args)))
    except Exception as e:  # both packages must fail alike
        return ("raises", type(e).__name__)


OBJECTS = [
    b"<< /A 1 /B 2.5 /C (hi) /D [1 2 R 3] /E /Nm >>", rb"(a\(b\)c\\d\101)", b"<48656C6C6F>",
    b"[ -3 +4 .5 true false null /N#20ame ]", b"<< /K << /L [<< /M 7 0 R >>] >> >>",
    b"(nested (paren) string)", b"}}}", b"<4>", b"[1 0 R 2 0 R]", b"  % comment\n 42 ",
]


@pytest.mark.parametrize("i", range(len(OBJECTS)))
def test_parse_object_matches_jax(i):
    assert _outcome(pdf.parse_object, OBJECTS[i], 0) == \
        _outcome(jax_pdf.parse_object, OBJECTS[i], 0)


def _png_rows(rng, colors: int, columns: int, rows: int) -> bytes:
    rowlen = columns * colors
    return b"".join(bytes([int(rng.integers(0, 5))]) + rng.bytes(rowlen) for _ in range(rows))


def _rl_encode(rng, n: int) -> bytes:
    out = bytearray()
    for _ in range(n):
        if rng.random() < 0.5:
            lit = rng.bytes(int(rng.integers(1, 128)))
            out += bytes([len(lit) - 1]) + lit
        else:
            out += bytes([257 - int(rng.integers(2, 129))]) + rng.bytes(1)
    return bytes(out + b"\x80")


@pytest.mark.parametrize("seed", range(4))
def test_stream_decoders_match_jax(seed):
    rng = np.random.default_rng(seed)
    colors, columns = int(rng.choice([1, 3])), int(rng.integers(3, 40))
    raw = _png_rows(rng, colors, columns, int(rng.integers(2, 12)))
    assert pdf._png_predictor(raw, colors, 8, columns) == \
        jax_pdf._png_predictor(raw, colors, 8, columns)
    blob = rng.bytes(int(rng.integers(10, 400)))
    a85 = base64.a85encode(blob) + b"~>"
    assert pdf._a85_decode(a85) == jax_pdf._a85_decode(a85) == blob
    rl = _rl_encode(rng, int(rng.integers(1, 20)))
    assert pdf._rl_decode(rl) == jax_pdf._rl_decode(rl)
    junk = rng.bytes(int(rng.integers(5, 200)))
    assert _outcome(pdf._lzw_decode, junk) == _outcome(jax_pdf._lzw_decode, junk)
    # a filter chain with a PNG predictor, resolved by each package
    coded = zlib.compress(raw).hex().encode() + b">"
    sdict = {"Filter": ["ASCIIHexDecode", "FlateDecode"],
             "DecodeParms": [None, {"Predictor": 12, "Colors": colors, "Columns": columns}]}
    assert pdf.decode_stream(sdict, coded, lambda v: v) == \
        jax_pdf.decode_stream(sdict, coded, lambda v: v)


def test_lzw_spec_vector():
    """The PDF reference's LZW example decodes the same in both packages."""
    data = bytes.fromhex("800b6050220c0c8501")
    assert pdf._lzw_decode(data) == jax_pdf._lzw_decode(data) == b"-----A---B"


def objstm_pdf() -> bytes:
    """The page tree and a font stored in a compressed object stream, a
    ToUnicode CMap, a Type0-free simple font with /Widths."""
    cmap = (b"/CIDInit /ProcSet findresource begin 12 dict begin begincmap\n"
            b"1 begincodespacerange <00> <FF> endcodespacerange\n"
            b"2 beginbfchar <41> <0042> <42> <0041> endbfchar\n"
            b"1 beginbfrange <61> <63> <0078> endbfrange\n"
            b"endcmap CMapName currentdict /CMap defineresource pop end end")
    inner = [b"<< /Type /Pages /Kids [4 0 R] /Count 1 >>",
             b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica-Bold /FirstChar 65 "
             b"/Widths [700 600] /ToUnicode 6 0 R >>"]
    header = b"2 0 3 %d " % (len(inner[0]) + 1)
    body = header + inner[0] + b" " + inner[1]
    objstm = zlib.compress(body)
    content = b"BT /F1 20 Tf 40 700 Td (ABabc) Tj ET"
    return _build_pdf([
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"null",
        b"null",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 300 800] "
        b"/Resources << /Font << /F1 3 0 R >> >> /Contents 7 0 R >>",
        _stream_obj(b"<< /Type /ObjStm /N 2 /First %d /Filter /FlateDecode /Length %d >>"
                    % (len(header), len(objstm)), objstm),
        _stream_obj(b"<< /Length %d >>" % len(cmap), cmap),
        _stream_obj(b"<< /Length %d >>" % len(content), content),
    ])


def test_document_model_matches_jax():
    """Object streams, the page walk, fonts with ToUnicode, and the render
    of a page whose resources live in an object stream."""
    data = objstm_pdf()
    mine, ref = pdf.PdfDocument(data), jax_pdf.PdfDocument(data)
    assert _plain(mine.pages()) == _plain(ref.pages())
    assert _plain(mine.get(3)) == _plain(ref.get(3))
    font_m = pdf.load_font(mine, mine.resolve(mine.get(3)))
    font_r = jax_pdf.load_font(ref, ref.resolve(ref.get(3)))
    assert font_m.decode(b"ABabc") == font_r.decode(b"ABabc")
    assert [font_m.width(c) for c in range(60, 70)] == [font_r.width(c) for c in range(60, 70)]
    cmap = mine.decoded_stream(6)
    assert pdf._parse_tounicode(cmap) == jax_pdf._parse_tounicode(cmap)
    _same_pages(pdf.render_pdf(data, dpi=72), jax_pdf.render_pdf(data, dpi=72))


# ---- encode_jpeg against PIL ----


def _pil_jpeg(px: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def _jpeg_inputs():
    rng = np.random.default_rng(11)
    forms, _ = smoke.smoke_forms()
    return {
        "form_rgb": forms[2],
        "form_gray": np.ascontiguousarray(forms[5][..., 0]),
        "noise_rgb_odd": rng.integers(0, 256, (37, 53, 3), dtype=np.uint8),
        "noise_rgb": rng.integers(0, 256, (48, 64, 3), dtype=np.uint8),
        "noise_gray": rng.integers(0, 256, (29, 70), dtype=np.uint8),
        "color_ramp": (np.add.outer(np.arange(70), np.arange(90))[..., None] * [1, 2, 3]
                       % 256).astype(np.uint8),
    }


JPEG_INPUTS = _jpeg_inputs()


@pytest.mark.parametrize("quality", [30, 75, 92])
@pytest.mark.parametrize("name", sorted(JPEG_INPUTS))
def test_encode_jpeg_decodes_as_pils(name, quality, capsys):
    """PIL opens the port's JPEG at the image's size and mode and decodes it
    within 2 gray levels of its decoding of its own JPEG. Whether the bytes
    are PIL's is reported, not gated."""
    px = JPEG_INPUTS[name]
    mine, theirs = jpeg.encode_jpeg(px, quality), _pil_jpeg(px, quality)
    img = Image.open(io.BytesIO(mine))
    assert img.format == "JPEG" and img.size == (px.shape[1], px.shape[0])
    assert img.mode == ("L" if px.ndim == 2 else "RGB")
    got = np.asarray(img).astype(np.int16)
    want = np.asarray(Image.open(io.BytesIO(theirs))).astype(np.int16)
    assert np.abs(got - want).max() <= 2
    assert mine[:2] == b"\xff\xd8" and mine[-2:] == b"\xff\xd9"
    with capsys.disabled():
        print(f"\nencode_jpeg {name} q{quality}: bytes equal to PIL's: {mine == theirs} "
              f"({len(mine)} / {len(theirs)} bytes)")


def test_encode_jpeg_is_the_save_stages_encoder():
    """preprocess.encode_jpeg is the first-party encoder (the JAX package's
    is PIL), and it refuses what is not uint8 pixels."""
    assert preprocess.encode_jpeg is jpeg.encode_jpeg
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((8, 8, 3), np.float32))
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((8, 8, 4), np.uint8))
