"""Host-side page ingestion (port of the image half of
ocr_system_tpu/engine/preprocess.py).

PIL is imported only inside ``decode_image``: the rest of the port runs
without it. PDF rasterization (pdf2image / the JAX package's engine/pdf.py
renderer) is a later slice of the port; ``load_document`` refuses PDFs.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np


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


def decode_image(data: bytes) -> np.ndarray:
    """bytes -> (H, W, 3) uint8 RGB, EXIF auto-oriented."""
    from PIL import Image, ImageOps

    Image.MAX_IMAGE_PIXELS = 512 * 1024 * 1024  # decompression-bomb guard
    img = Image.open(io.BytesIO(data))
    img = ImageOps.exif_transpose(img)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def load_document(data: bytes, filename: str, dpi: int = 300) -> list[PageImage]:
    """Image bytes -> a single page. PDFs are not ported yet."""
    ext = filename.rsplit(".", 1)[-1].lower() if "." in filename else ""
    if ext == "pdf" or data[:5] == b"%PDF-":
        raise ValueError("PDF rasterization is not ported to the torch engine yet")
    return [PageImage(decode_image(data), 1, dpi)]
