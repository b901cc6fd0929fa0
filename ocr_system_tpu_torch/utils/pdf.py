"""Minimal PDF writer on stdlib — no reportlab in the image.

Port of ``ocr_system_tpu/utils/pdf.py``: the same code, on the port's modules.

Covers the export service's report needs (reference export_service.py:414-554
builds a reportlab table report with confidence-colored rows): multi-page A4
documents of text lines and filled rectangles with the base-14 Helvetica
fonts. Output is a valid PDF 1.4 byte stream with an xref table.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

A4 = (595.0, 842.0)  # points


def _esc_text(s: str) -> str:
    # latin-1 PDF strings; non-encodable chars degrade to '?'
    s = s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
    return s.encode("latin-1", errors="replace").decode("latin-1")


@dataclass
class Page:
    width: float = A4[0]
    height: float = A4[1]
    ops: list[str] = field(default_factory=list)

    def text(
        self, x: float, y: float, s: str, size: float = 10.0,
        bold: bool = False, color: tuple[float, float, float] = (0, 0, 0),
    ) -> None:
        """y measured from the TOP of the page (UI convention)."""
        font = "/F2" if bold else "/F1"
        r, g, b = color
        self.ops.append(
            f"BT {r:.3f} {g:.3f} {b:.3f} rg {font} {size:.1f} Tf "
            f"{x:.1f} {self.height - y:.1f} Td ({_esc_text(s)}) Tj ET"
        )

    def rect(
        self, x: float, y: float, w: float, h: float,
        fill: tuple[float, float, float],
    ) -> None:
        r, g, b = fill
        self.ops.append(
            f"{r:.3f} {g:.3f} {b:.3f} rg {x:.1f} {self.height - y - h:.1f} "
            f"{w:.1f} {h:.1f} re f"
        )

    def line(self, x0, y0, x1, y1, width=0.5):
        self.ops.append(
            f"{width:.2f} w 0 0 0 RG {x0:.1f} {self.height - y0:.1f} m "
            f"{x1:.1f} {self.height - y1:.1f} l S"
        )

    def content(self) -> bytes:
        return ("\n".join(self.ops)).encode("latin-1", errors="replace")


class PDFDocument:
    def __init__(self):
        self.pages: list[Page] = []

    def add_page(self, width: float = A4[0], height: float = A4[1]) -> Page:
        page = Page(width, height)
        self.pages.append(page)
        return page

    def to_bytes(self) -> bytes:
        # object numbering: 1 catalog, 2 pages tree, 3 F1, 4 F2,
        # then per page: page obj + content obj
        objs: list[bytes] = []

        def obj(body: bytes) -> int:
            objs.append(body)
            return len(objs)

        font1 = obj(
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>"
        )
        font2 = obj(
            b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica-Bold >>"
        )
        page_ids: list[int] = []
        pages_tree_id = len(objs) + 1 + 2 * len(self.pages)  # reserved last
        for page in self.pages:
            raw = page.content()
            compressed = zlib.compress(raw)
            cid = obj(
                b"<< /Length %d /Filter /FlateDecode >>\nstream\n" % len(compressed)
                + compressed
                + b"\nendstream"
            )
            pid = obj(
                (
                    f"<< /Type /Page /Parent {pages_tree_id} 0 R "
                    f"/MediaBox [0 0 {page.width:.0f} {page.height:.0f}] "
                    f"/Resources << /Font << /F1 {font1} 0 R /F2 {font2} 0 R >> >> "
                    f"/Contents {cid} 0 R >>"
                ).encode()
            )
            page_ids.append(pid)
        kids = " ".join(f"{pid} 0 R" for pid in page_ids)
        ptid = obj(
            f"<< /Type /Pages /Kids [{kids}] /Count {len(page_ids)} >>".encode()
        )
        assert ptid == pages_tree_id
        catalog = obj(f"<< /Type /Catalog /Pages {ptid} 0 R >>".encode())

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0] * (len(objs) + 1)
        for i, body in enumerate(objs, 1):
            offsets[i] = len(out)
            out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
        xref_pos = len(out)
        out += b"xref\n0 %d\n" % (len(objs) + 1)
        out += b"0000000000 65535 f \n"
        for i in range(1, len(objs) + 1):
            out += b"%010d 00000 n \n" % offsets[i]
        out += (
            b"trailer\n<< /Size %d /Root %d 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objs) + 1, catalog, xref_pos)
        )
        return bytes(out)
