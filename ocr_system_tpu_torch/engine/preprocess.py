"""Host-side page ingestion (port of ocr_system_tpu/engine/preprocess.py):
image decode with EXIF orientation, PDF rasterization, JPEG encoding of
processed pages for the review UI, bucket assignment.

PIL is imported only inside ``decode_image``: the rest of the port runs
without it. JPEG encoding is first-party (``engine/jpeg.py``), so the save
stage and ``compress_to_limit`` (whose halving is PIL's bicubic resize in
numpy, ``engine/host_image.resize_bicubic_pil``) run without PIL too.

PDF rasterization has the JAX package's three tiers: pdf2image/poppler
when installed, else the first-party content-stream renderer
(``engine/pdf.py``, whose canvas is PIL), else the embedded-image
extractor below (numpy and zlib; a JPEG-coded scan goes through
``decode_image``). Without PIL, scanned PDFs of Flate-coded images are
therefore served by the extractor; ``RASTER_TIERS`` counts which tier
served each document.
"""

from __future__ import annotations

import collections
import io
import threading
import zlib
from dataclasses import dataclass

import numpy as np

from ocr_system_tpu_torch.engine.host_image import resize_bicubic_pil
from ocr_system_tpu_torch.engine.jpeg import encode_jpeg

# documents each rasterization tier served in this process: "poppler",
# "render" (engine/pdf.py) and "embedded" (_pdf_extract_images)
RASTER_TIERS: collections.Counter = collections.Counter()
_TIERS_LOCK = threading.Lock()


@dataclass
class PageImage:
    pixels: np.ndarray  # (H, W, 3) uint8 RGB
    page_number: int  # 1-based
    dpi: int = 300

    @property
    def width(self) -> int:
        return self.pixels.shape[1]

    @property
    def height(self) -> int:
        return self.pixels.shape[0]


def decode_image(data: bytes, orient: bool = True) -> np.ndarray:
    """bytes -> (H, W, 3) uint8 RGB, EXIF auto-oriented unless ``orient`` is
    False (an image embedded in a PDF is placed by the PDF, not by EXIF)."""
    from PIL import Image, ImageOps

    Image.MAX_IMAGE_PIXELS = 512 * 1024 * 1024  # decompression-bomb guard
    img = Image.open(io.BytesIO(data))
    if orient:
        img = ImageOps.exif_transpose(img)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def compress_to_limit(pixels: np.ndarray, max_bytes: int = 2 * 1024 * 1024) -> bytes:
    """Iterative JPEG compression to a byte budget (the reference's
    compress_for_azure): quality 95 down to 35 in steps of 10, then halve
    the size (floor, at least 64 a side) and encode at quality 60 until the
    bytes fit or the width is 64. The bytes are PIL's for the same steps."""
    for quality in range(95, 25, -10):
        data = encode_jpeg(pixels, quality)
        if len(data) <= max_bytes:
            return data
    img = pixels
    while True:
        h, w = img.shape[:2]
        img = resize_bicubic_pil(img, (max(h // 2, 64), max(w // 2, 64)))
        data = encode_jpeg(img, 60)
        if len(data) <= max_bytes or img.shape[1] <= 64:
            return data


# ---- minimal PDF raster ----


def _pdf_extract_images(data: bytes) -> list[np.ndarray]:
    """Extract embedded image XObjects from a PDF byte stream.

    Handles DCTDecode (JPEG, through ``decode_image``) and FlateDecode raw
    bitmaps (DeviceRGB/DeviceGray) — the encodings scanners produce.
    Parsing is tolerant: any stream it can't decode is skipped.
    """
    out: list[np.ndarray] = []
    pos = 0
    while True:
        s = data.find(b"stream", pos)
        if s < 0:
            break
        # locate the dict preceding this stream
        d = data.rfind(b"<<", 0, s)
        header = data[d:s] if d >= 0 else b""
        body_start = s + len(b"stream")
        if data[body_start: body_start + 2] == b"\r\n":
            body_start += 2
        elif data[body_start: body_start + 1] == b"\n":
            body_start += 1
        e = data.find(b"endstream", body_start)
        if e < 0:
            break
        body = data[body_start:e]
        pos = e + len(b"endstream")
        if b"/Image" not in header:
            continue
        try:
            if b"/DCTDecode" in header:
                out.append(decode_image(body, orient=False))
            elif b"/FlateDecode" in header:
                raw = zlib.decompress(body)
                w = _pdf_int(header, b"/Width")
                h = _pdf_int(header, b"/Height")
                if not w or not h:
                    continue
                if len(raw) >= w * h * 3:
                    arr = np.frombuffer(raw[: w * h * 3], np.uint8).reshape(h, w, 3)
                elif len(raw) >= w * h:
                    g = np.frombuffer(raw[: w * h], np.uint8).reshape(h, w)
                    arr = np.stack([g] * 3, axis=-1)
                else:
                    continue
                out.append(arr.copy())
        except Exception:
            continue
    return out


def _pdf_int(header: bytes, key: bytes) -> int | None:
    i = header.find(key)
    if i < 0:
        return None
    j = i + len(key)
    while j < len(header) and header[j] in b" \t":
        j += 1
    k = j
    while k < len(header) and header[k: k + 1].isdigit():
        k += 1
    return int(header[j:k]) if k > j else None


def pdf_page_count(data: bytes) -> int:
    """Count pages (poppler's count when installed, else the page objects)."""
    try:
        import pdf2image  # type: ignore

        return pdf2image.pdfinfo_from_bytes(data)["Pages"]
    except Exception:
        return max(data.count(b"/Type /Page") - data.count(b"/Type /Pages"),
                   data.count(b"/Type/Page") - data.count(b"/Type/Pages"),
                   1)


def _served(tier: str) -> None:
    with _TIERS_LOCK:
        RASTER_TIERS[tier] += 1


def rasterize_pdf(data: bytes, dpi: int = 300) -> list[PageImage]:
    """PDF bytes -> page images. Tiers: poppler -> first-party renderer
    (engine/pdf.py) -> embedded-image extraction; the tier that served is
    counted in ``RASTER_TIERS``."""
    try:
        import pdf2image  # type: ignore

        pages = pdf2image.convert_from_bytes(data, dpi=dpi)
        _served("poppler")
        return [
            PageImage(np.asarray(p.convert("RGB"), dtype=np.uint8), i + 1, dpi)
            for i, p in enumerate(pages)
        ]
    except Exception:
        pass
    rendered: list[np.ndarray] = []
    try:
        from ocr_system_tpu_torch.engine.pdf import render_pdf

        rendered = render_pdf(data, dpi=dpi)
        # all-blank output usually means the interpreter understood the
        # structure but none of the content (e.g. exotic filters) — prefer
        # embedded-scan salvage THEN, but keep the renders if salvage finds
        # nothing (a genuinely blank/faint PDF is still a valid document)
        if any(int(p.min()) < 250 for p in rendered):
            _served("render")
            return [PageImage(img, i + 1, dpi) for i, img in enumerate(rendered)]
    except Exception:
        pass
    images = _pdf_extract_images(data)
    if images:
        _served("embedded")
    elif rendered:
        _served("render")
    return [PageImage(img, i + 1, dpi) for i, img in enumerate(images or rendered)]


def load_document(data: bytes, filename: str, dpi: int = 300) -> list[PageImage]:
    """Dispatch by extension: PDF -> pages; image -> single page."""
    ext = filename.rsplit(".", 1)[-1].lower() if "." in filename else ""
    if ext == "pdf" or data[:5] == b"%PDF-":
        pages = rasterize_pdf(data, dpi)
        if pages:
            return pages
        raise ValueError("PDF contains no rasterizable pages")
    return [PageImage(decode_image(data), 1, dpi)]


def pick_bucket(size: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= size, else the largest bucket."""
    for b in sorted(buckets):
        if size <= b:
            return b
    return max(buckets)
