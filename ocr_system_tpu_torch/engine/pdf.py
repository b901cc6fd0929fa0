"""First-party PDF rasterizer: text/vector page rendering without poppler.

Port of ``ocr_system_tpu/engine/pdf.py``: the same code. The parser, the
stream decoders and the content-stream interpreter are zlib and numpy; the
page canvas, image decoding and text drawing are PIL, imported inside
``_PageRenderer`` as in the JAX module, so ``render_pdf`` raises
ImportError where PIL is missing and ``engine/preprocess.rasterize_pdf``
falls through to its embedded-image tier.

The reference shells out to pdf2image/poppler at 300 DPI
(backend/utils/image_preprocessing.py:248-295). This deployment image has no
poppler and no pypdfium2, so the framework ships its own rasterizer for the
document classes OCR actually meets:

  - text PDFs (generated invoices/forms): content-stream text operators
    rendered with DejaVu at the correct positions/sizes, vector rules/tables
    as lines, so the downstream det+rec pipeline sees a faithful page,
  - scanned PDFs: embedded image XObjects placed through the CTM,
  - hybrid pages: both.

It is an interpreter for the pragmatic PDF subset forms use — classic and
compressed (ObjStm) object storage, Flate/LZW/A85/AHx/RunLength filters with
PNG predictors, simple + Type0 fonts with /Widths//W metrics, ToUnicode
CMaps, and the text/path/image operators. Glyph OUTLINES in embedded fonts
are not executed; text draws in DejaVu at the metric positions, which is the
right trade for OCR ingestion (the pixels only feed detection/recognition).

`pdf2image` is still preferred when installed (deploy/Dockerfile installs
poppler-utils); this module is the always-available fallback and the test
target.
"""

from __future__ import annotations

import collections
import io
import os
import re
import sysconfig
import threading
import zlib
from dataclasses import dataclass, field

import numpy as np

__all__ = ["render_pdf", "PdfError"]

# Upper bound on any rendered dimension (page canvas or image paste target).
# 20k px ≈ 67 inches at 300 DPI — beyond any legitimate document, and it
# caps a single allocation at ~400 MB even for a hostile MediaBox/CTM.
MAX_PAGE_PX = 20_000
# where the text renderer looks for DejaVu, in order: the package's fonts
# (assets/fonts), then the system's and matplotlib's copies
FONT_DIRS = (
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets", "fonts"),
    "/usr/share/fonts/truetype/dejavu",
    os.path.join(sysconfig.get_paths()["purelib"], "matplotlib", "mpl-data", "fonts", "ttf"),
)
# font files the text renderer loaded in this process, by path ("PIL
# default" for the bitmap fallback), one count per size and weight
FONTS_SERVED: collections.Counter = collections.Counter()
_FONTS_LOCK = threading.Lock()


class PdfError(ValueError):
    pass


# --------------------------------------------------------------- object model


class Ref(tuple):
    """Indirect reference (num, gen)."""

    __slots__ = ()


class Name(str):
    """PDF name (/Foo) — distinct from byte strings."""

    __slots__ = ()


_WS = b"\x00\t\n\x0c\r "
_DELIM = b"()<>[]{}/%"


def _skip_ws(data: bytes, i: int) -> int:
    n = len(data)
    while i < n:
        c = data[i : i + 1]
        if c in (b"%",):  # comment to EOL
            while i < n and data[i] not in b"\r\n":
                i += 1
        elif c in b"\x00\t\n\x0c\r ":
            i += 1
        else:
            break
    return i


def _parse_string(data: bytes, i: int) -> tuple[bytes, int]:
    """Literal string starting at '(' — returns (bytes, next_pos)."""
    assert data[i : i + 1] == b"("
    i += 1
    out = bytearray()
    depth = 1
    n = len(data)
    while i < n and depth:
        c = data[i]
        if c == 0x5C:  # backslash
            i += 1
            if i >= n:
                break
            e = data[i]
            if e in b"nrtbf":
                out.append({0x6E: 10, 0x72: 13, 0x74: 9, 0x62: 8, 0x66: 12}[e])
                i += 1
            elif e in b"()\\":
                out.append(e)
                i += 1
            elif 0x30 <= e <= 0x37:  # octal, up to 3 digits
                oct_digits = bytearray()
                while i < n and len(oct_digits) < 3 and 0x30 <= data[i] <= 0x37:
                    oct_digits.append(data[i])
                    i += 1
                out.append(int(oct_digits, 8) & 0xFF)
            elif e in b"\r\n":  # line continuation
                i += 1
                if e == 0x0D and i < n and data[i] == 0x0A:
                    i += 1
            else:
                out.append(e)
                i += 1
        elif c == 0x28:
            depth += 1
            out.append(c)
            i += 1
        elif c == 0x29:
            depth -= 1
            if depth:
                out.append(c)
            i += 1
        else:
            out.append(c)
            i += 1
    return bytes(out), i


def _parse_hex_string(data: bytes, i: int) -> tuple[bytes, int]:
    assert data[i : i + 1] == b"<"
    j = data.find(b">", i + 1)
    if j < 0:
        j = len(data)
    hexs = re.sub(rb"[^0-9A-Fa-f]", b"", data[i + 1 : j])
    if len(hexs) % 2:
        hexs += b"0"
    return bytes.fromhex(hexs.decode("ascii")), j + 1


_NUM_RE = re.compile(rb"[+-]?(?:\d+\.?\d*|\.\d+)")


def parse_object(data: bytes, i: int):
    """Parse one PDF object at offset i. Returns (value, next_pos)."""
    i = _skip_ws(data, i)
    if i >= len(data):
        raise PdfError("unexpected EOF")
    c = data[i : i + 1]
    if c == b"<":
        if data[i : i + 2] == b"<<":
            d: dict[str, object] = {}
            i += 2
            while True:
                i = _skip_ws(data, i)
                if data[i : i + 2] == b">>":
                    return d, i + 2
                if data[i : i + 1] != b"/":
                    raise PdfError(f"bad dict key at {i}")
                key, i = parse_object(data, i)
                val, i = parse_object(data, i)
                d[str(key)] = val
        return _parse_hex_string(data, i)
    if c == b"(":
        return _parse_string(data, i)
    if c == b"[":
        arr: list[object] = []
        i += 1
        while True:
            i = _skip_ws(data, i)
            if data[i : i + 1] == b"]":
                return arr, i + 1
            v, i = parse_object(data, i)
            arr.append(v)
    if c == b"/":
        j = i + 1
        n = len(data)
        out = bytearray()
        while j < n and data[j] not in _WS and data[j] not in _DELIM:
            if data[j] == 0x23 and j + 2 < n:  # #XX escape
                try:
                    out.append(int(data[j + 1 : j + 3], 16))
                    j += 3
                    continue
                except ValueError:
                    pass
            out.append(data[j])
            j += 1
        return Name(out.decode("latin-1")), j
    m = _NUM_RE.match(data, i)
    if m:
        # maybe an indirect reference: "num gen R"
        j = _skip_ws(data, m.end())
        m2 = _NUM_RE.match(data, j)
        if m2 and b"." not in m.group():
            k = _skip_ws(data, m2.end())
            if data[k : k + 1] == b"R" and (
                k + 1 >= len(data)
                or data[k + 1] in _WS
                or data[k + 1] in _DELIM
            ):
                return Ref((int(m.group()), int(m2.group()))), k + 1
        t = m.group()
        return (float(t) if b"." in t else int(t)), m.end()
    for kw, val in ((b"true", True), (b"false", False), (b"null", None)):
        if data[i : i + len(kw)] == kw:
            return val, i + len(kw)
    raise PdfError(f"unparseable object at {i}: {data[i:i + 20]!r}")


# ------------------------------------------------------------------ filters


def _png_predictor(raw: bytes, colors: int, bpc: int, columns: int) -> bytes:
    bpp = max((colors * bpc + 7) // 8, 1)
    rowlen = (columns * colors * bpc + 7) // 8
    out = bytearray()
    prev = bytearray(rowlen)
    i = 0
    while i + 1 <= len(raw):
        ft = raw[i]
        row = bytearray(raw[i + 1 : i + 1 + rowlen])
        i += 1 + rowlen
        if ft == 1:  # Sub
            for x in range(bpp, len(row)):
                row[x] = (row[x] + row[x - bpp]) & 0xFF
        elif ft == 2:  # Up
            for x in range(len(row)):
                row[x] = (row[x] + prev[x]) & 0xFF
        elif ft == 3:  # Average
            for x in range(len(row)):
                left = row[x - bpp] if x >= bpp else 0
                row[x] = (row[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for x in range(len(row)):
                a = row[x - bpp] if x >= bpp else 0
                b = prev[x]
                cc = prev[x - bpp] if x >= bpp else 0
                p = a + b - cc
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
                row[x] = (row[x] + pred) & 0xFF
        out += row
        prev = row
    return bytes(out)


def _lzw_decode(data: bytes) -> bytes:
    out = bytearray()
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    bitpos = 0
    width = 9
    prev: bytes | None = None
    total_bits = len(data) * 8
    while bitpos + width <= total_bits:
        byte_i, off = divmod(bitpos, 8)
        chunk = int.from_bytes(data[byte_i : byte_i + 3].ljust(3, b"\0"), "big")
        code = (chunk >> (24 - off - width)) & ((1 << width) - 1)
        bitpos += width
        if code == 256:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width = 9
            prev = None
            continue
        if code == 257:
            break
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << width) and width < 12:
            width += 1
    return bytes(out)


def _a85_decode(data: bytes) -> bytes:
    data = re.sub(rb"\s", b"", data).rstrip(b"~>")
    out = bytearray()
    i = 0
    while i < len(data):
        if data[i : i + 1] == b"z":
            out += b"\0\0\0\0"
            i += 1
            continue
        group = data[i : i + 5]
        i += 5
        pad = 5 - len(group)
        group += b"u" * pad
        v = 0
        for ch in group:
            v = v * 85 + (ch - 33)
        out += v.to_bytes(4, "big")[: 4 - pad]
    return bytes(out)


def _rl_decode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(data):
        l = data[i]
        if l == 128:
            break
        if l < 128:
            out += data[i + 1 : i + 2 + l]
            i += 2 + l
        else:
            out += data[i + 1 : i + 2] * (257 - l)
            i += 2
    return bytes(out)


def decode_stream(sdict: dict, raw: bytes, resolve) -> bytes:
    """Apply the /Filter chain. DCTDecode streams return raw JPEG bytes
    (image path decodes them with PIL)."""
    filters = resolve(sdict.get("Filter"))
    if filters is None:
        return raw
    if not isinstance(filters, list):
        filters = [filters]
    parms = resolve(sdict.get("DecodeParms")) or resolve(sdict.get("DP"))
    if not isinstance(parms, list):
        parms = [parms] * len(filters)
    elif len(parms) < len(filters):  # malformed-but-seen: pad, don't zip-drop
        parms = parms + [None] * (len(filters) - len(parms))
    data = raw
    for f, parm in zip(filters, parms):
        f = str(f)
        parm = resolve(parm) or {}
        if f in ("FlateDecode", "Fl"):
            data = zlib.decompress(data)
        elif f in ("LZWDecode", "LZW"):
            data = _lzw_decode(data)
        elif f in ("ASCII85Decode", "A85"):
            data = _a85_decode(data)
        elif f in ("ASCIIHexDecode", "AHx"):
            hexs = re.sub(rb"[^0-9A-Fa-f]", b"", data.rstrip(b">"))
            if len(hexs) % 2:
                hexs += b"0"
            data = bytes.fromhex(hexs.decode("ascii"))
        elif f in ("RunLengthDecode", "RL"):
            data = _rl_decode(data)
        elif f in ("DCTDecode", "DCT", "JPXDecode"):
            return data  # compressed image passthrough
        else:
            raise PdfError(f"unsupported filter {f}")
        pred = resolve(parm.get("Predictor")) if isinstance(parm, dict) else None
        if pred and pred >= 10:
            data = _png_predictor(
                data,
                int(resolve(parm.get("Colors")) or 1),
                int(resolve(parm.get("BitsPerComponent")) or 8),
                int(resolve(parm.get("Columns")) or 1),
            )
    return data


# ------------------------------------------------------------------ document


class PdfDocument:
    """Offset-scan object map (tolerant of broken xref tables) + ObjStm
    expansion + page tree walk."""

    def __init__(self, data: bytes):
        self.data = data
        self.objects: dict[int, object] = {}  # num -> parsed value (lazy)
        # CANDIDATE offsets per object number: the regex scan can also match
        # "N G obj" byte patterns inside compressed stream bodies, so every
        # match is kept and get() tries them in file order until one parses
        self._offsets: dict[int, list[int]] = {}
        self._streams: dict[int, tuple[dict, bytes]] = {}
        for m in re.finditer(rb"(?m)(\d+)\s+(\d+)\s+obj\b", data):
            self._offsets.setdefault(int(m.group(1)), []).append(m.end())
        self._expand_object_streams()

    # -- object access --

    def get(self, num: int):
        if num in self.objects:
            return self.objects[num]
        for off in self._offsets.get(num, ()):
            try:
                val, pos = parse_object(self.data, off)
            except PdfError:
                continue
            if isinstance(val, dict):
                pos = _skip_ws(self.data, pos)
                if self.data[pos : pos + 6] == b"stream":
                    body = self._read_stream_body(val, pos + 6)
                    self._streams[num] = (val, body)
            self.objects[num] = val
            return val
        self.objects[num] = None
        return None

    def _read_stream_body(self, sdict: dict, pos: int) -> bytes:
        if self.data[pos : pos + 2] == b"\r\n":
            pos += 2
        elif self.data[pos : pos + 1] in (b"\n", b"\r"):
            pos += 1
        length = self.resolve(sdict.get("Length"))
        if isinstance(length, int) and length >= 0:
            body = self.data[pos : pos + length]
            # trust but verify — broken Length falls back to endstream scan
            tail = _skip_ws(self.data, pos + length)
            if self.data[tail : tail + 9] == b"endstream":
                return body
        end = self.data.find(b"endstream", pos)
        return self.data[pos : end if end >= 0 else len(self.data)]

    def stream_of(self, num: int) -> tuple[dict, bytes] | None:
        self.get(num)
        return self._streams.get(num)

    def resolve(self, v, depth: int = 0):
        while isinstance(v, Ref) and depth < 32:
            v = self.get(v[0])
            depth += 1
        return v

    def decoded_stream(self, num: int) -> bytes | None:
        sv = self.stream_of(num)
        if sv is None:
            return None
        sdict, raw = sv
        try:
            return decode_stream(sdict, raw, self.resolve)
        except Exception:
            return None

    def _expand_object_streams(self) -> None:
        for num in list(self._offsets):
            try:
                val = self.get(num)
            except Exception:
                continue
            if not (isinstance(val, dict) and str(val.get("Type")) == "ObjStm"):
                continue
            payload = self.decoded_stream(num)
            if payload is None:
                continue
            n = self.resolve(val.get("N")) or 0
            first = self.resolve(val.get("First")) or 0
            header = payload[:first].split()
            try:
                pairs = [
                    (int(header[2 * i]), int(header[2 * i + 1]))
                    for i in range(int(n))
                ]
            except (ValueError, IndexError):
                continue
            for onum, ooff in pairs:
                if onum in self.objects or onum in self._offsets:
                    continue
                try:
                    oval, _ = parse_object(payload, first + ooff)
                    self.objects[onum] = oval
                except PdfError:
                    continue

    # -- page tree --

    def pages(self) -> list[dict]:
        root = None
        for num in {**self._offsets, **self.objects}:
            v = self.get(num)
            if isinstance(v, dict) and str(v.get("Type")) == "Catalog":
                root = v
                break
        page_dicts: list[dict] = []

        def walk(node, inherited: dict, depth: int):
            node = self.resolve(node)
            if not isinstance(node, dict) or depth > 64:
                return
            merged = dict(inherited)
            for k in ("Resources", "MediaBox", "Rotate", "CropBox"):
                if k in node:
                    merged[k] = node[k]
            if str(node.get("Type")) == "Page":
                d = dict(node)
                for k, v in merged.items():
                    d.setdefault(k, v)
                page_dicts.append(d)
            else:
                for kid in self.resolve(node.get("Kids")) or []:
                    walk(kid, merged, depth + 1)

        if root is not None:
            walk(root.get("Pages"), {}, 0)
        if not page_dicts:  # no catalog (damaged file): scan for Page objects
            for num in {**self._offsets, **self.objects}:
                v = self.get(num)
                if isinstance(v, dict) and str(v.get("Type")) == "Page":
                    page_dicts.append(v)
        return page_dicts


# ------------------------------------------------------------------- fonts

# WinAnsi/Standard differ from latin-1 only in 0x80-0x9F (typography chars);
# map the ones that matter for text recovery.
_WINANSI_HIGH = {
    0x80: "€", 0x82: "‚", 0x83: "ƒ", 0x84: "„",
    0x85: "…", 0x86: "†", 0x87: "‡", 0x88: "ˆ",
    0x89: "‰", 0x8A: "Š", 0x8B: "‹", 0x8C: "Œ",
    0x8E: "Ž", 0x91: "‘", 0x92: "’", 0x93: "“",
    0x94: "”", 0x95: "•", 0x96: "–", 0x97: "—",
    0x98: "˜", 0x99: "™", 0x9A: "š", 0x9B: "›",
    0x9C: "œ", 0x9E: "ž", 0x9F: "Ÿ",
}

# /Differences names -> unicode for the glyph names forms actually use
_GLYPH_NAMES = {
    "space": " ", "exclam": "!", "quotedbl": '"', "numbersign": "#",
    "dollar": "$", "percent": "%", "ampersand": "&", "quotesingle": "'",
    "parenleft": "(", "parenright": ")", "asterisk": "*", "plus": "+",
    "comma": ",", "hyphen": "-", "period": ".", "slash": "/",
    "zero": "0", "one": "1", "two": "2", "three": "3", "four": "4",
    "five": "5", "six": "6", "seven": "7", "eight": "8", "nine": "9",
    "colon": ":", "semicolon": ";", "less": "<", "equal": "=",
    "greater": ">", "question": "?", "at": "@", "bracketleft": "[",
    "backslash": "\\", "bracketright": "]", "asciicircum": "^",
    "underscore": "_", "grave": "`", "braceleft": "{", "bar": "|",
    "braceright": "}", "asciitilde": "~", "quoteright": "’",
    "quoteleft": "‘", "quotedblleft": "“",
    "quotedblright": "”", "endash": "–", "emdash": "—",
    "bullet": "•", "Euro": "€", "sterling": "£",
}


def _parse_tounicode(cmap: bytes) -> dict[int, str]:
    """bfchar/bfrange sections of a ToUnicode CMap -> {code: unicode}."""
    out: dict[int, str] = {}

    def u16s(hexs: bytes) -> str:
        try:
            b = bytes.fromhex(hexs.decode("ascii"))
            return b.decode("utf-16-be", "ignore")
        except ValueError:
            return ""

    for m in re.finditer(rb"beginbfchar(.*?)endbfchar", cmap, re.S):
        for src, dst in re.findall(
            rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>", m.group(1)
        ):
            out[int(src, 16)] = u16s(dst)
    for m in re.finditer(rb"beginbfrange(.*?)endbfrange", cmap, re.S):
        body = m.group(1)
        for lo, hi, dst in re.findall(
            rb"<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>\s*<([0-9A-Fa-f]+)>", body
        ):
            lo_i, hi_i = int(lo, 16), int(hi, 16)
            base = int(dst, 16)
            for k in range(min(hi_i - lo_i + 1, 65536)):
                out[lo_i + k] = chr(base + k) if base + k < 0x110000 else ""
        for lo, arr in re.findall(
            rb"<([0-9A-Fa-f]+)>\s*<[0-9A-Fa-f]+>\s*\[(.*?)\]", body, re.S
        ):
            lo_i = int(lo, 16)
            for k, d in enumerate(re.findall(rb"<([0-9A-Fa-f]+)>", arr)):
                out[lo_i + k] = u16s(d)
    return out


@dataclass
class FontInfo:
    two_byte: bool = False
    widths: dict[int, float] = field(default_factory=dict)  # code -> /1000
    default_width: float = 500.0
    to_unicode: dict[int, str] = field(default_factory=dict)
    differences: dict[int, str] = field(default_factory=dict)
    bold: bool = False

    def decode(self, s: bytes) -> list[tuple[int, str]]:
        """string bytes -> [(code, unicode_char)]."""
        out: list[tuple[int, str]] = []
        if self.two_byte:
            for i in range(0, len(s) - 1, 2):
                code = (s[i] << 8) | s[i + 1]
                out.append((code, self._uni(code)))
        else:
            for b in s:
                out.append((b, self._uni(b)))
        return out

    def _uni(self, code: int) -> str:
        if code in self.to_unicode:
            return self.to_unicode[code] or ""
        if code in self.differences:
            return self.differences[code]
        if self.two_byte:
            return chr(code) if 0x20 <= code < 0x3000 else ""
        if 0x20 <= code <= 0x7E:
            return chr(code)
        if code in _WINANSI_HIGH:
            return _WINANSI_HIGH[code]
        if 0xA0 <= code <= 0xFF:
            return bytes([code]).decode("latin-1")
        return ""

    def width(self, code: int) -> float:
        return self.widths.get(code, self.default_width)


def load_font(doc: PdfDocument, fdict: dict) -> FontInfo:
    fdict = doc.resolve(fdict) or {}
    info = FontInfo()
    subtype = str(fdict.get("Subtype", ""))
    base = str(doc.resolve(fdict.get("BaseFont")) or "")
    info.bold = "Bold" in base or "bold" in base
    tu = fdict.get("ToUnicode")
    if tu is not None and isinstance(doc.resolve(tu), dict):
        payload = doc.decoded_stream(tu[0]) if isinstance(tu, Ref) else None
        if payload:
            info.to_unicode = _parse_tounicode(payload)
    if subtype == "Type0":
        info.two_byte = True  # Identity-H is the overwhelmingly common CMap
        desc = doc.resolve(fdict.get("DescendantFonts"))
        d0 = doc.resolve(desc[0]) if isinstance(desc, list) and desc else {}
        if isinstance(d0, dict):
            info.default_width = float(doc.resolve(d0.get("DW")) or 1000.0)
            w = doc.resolve(d0.get("W")) or []
            i = 0
            while i < len(w):
                first = doc.resolve(w[i])
                nxt = doc.resolve(w[i + 1]) if i + 1 < len(w) else None
                if isinstance(nxt, list):
                    for k, wv in enumerate(nxt):
                        info.widths[int(first) + k] = float(doc.resolve(wv))
                    i += 2
                elif nxt is not None and i + 2 < len(w):
                    wv = float(doc.resolve(w[i + 2]))
                    for c in range(int(first), int(nxt) + 1):
                        info.widths[c] = wv
                    i += 3
                else:
                    break
        return info
    # simple font
    first_char = doc.resolve(fdict.get("FirstChar"))
    widths = doc.resolve(fdict.get("Widths"))
    if isinstance(widths, list) and first_char is not None:
        for k, wv in enumerate(widths):
            wv = doc.resolve(wv)
            if isinstance(wv, (int, float)) and wv > 0:
                info.widths[int(first_char) + k] = float(wv)
    enc = doc.resolve(fdict.get("Encoding"))
    if isinstance(enc, dict):
        diffs = doc.resolve(enc.get("Differences")) or []
        code = 0
        for item in diffs:
            item = doc.resolve(item)
            if isinstance(item, (int, float)):
                code = int(item)
            elif isinstance(item, Name):
                nm = str(item)
                if nm in _GLYPH_NAMES:
                    info.differences[code] = _GLYPH_NAMES[nm]
                elif len(nm) == 1:
                    info.differences[code] = nm
                elif nm.startswith("uni") and len(nm) == 7:
                    try:
                        info.differences[code] = chr(int(nm[3:], 16))
                    except ValueError:
                        pass
                code += 1
    return info


# ---------------------------------------------------------------- rendering


def _mat_mul(a, b):
    """2D affine (a0 a1 a2 a3 a4 a5) as row-vector convention: a then b."""
    return (
        a[0] * b[0] + a[1] * b[2],
        a[0] * b[1] + a[1] * b[3],
        a[2] * b[0] + a[3] * b[2],
        a[2] * b[1] + a[3] * b[3],
        a[4] * b[0] + a[5] * b[2] + b[4],
        a[4] * b[1] + a[5] * b[3] + b[5],
    )


def _apply(m, x, y):
    return (m[0] * x + m[2] * y + m[4], m[1] * x + m[3] * y + m[5])


_IDENT = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)


@dataclass
class _GState:
    ctm: tuple = _IDENT
    gray: float = 0.0  # current fill/stroke luminance
    line_width: float = 1.0


_OP_RE = re.compile(
    rb"""(?:
      (?P<num>[+-]?(?:\d+\.?\d*|\.\d+))
    | (?P<name>/[^\s()<>\[\]{}/%]*)
    | (?P<str>\()
    | (?P<hex><(?![<]))
    | (?P<arr>\[)
    | (?P<dict><<)
    | (?P<op>[A-Za-z'"][A-Za-z0-9*'"]*)
    | (?P<close>[\]>])
    )""",
    re.X,
)


class _PageRenderer:
    """Interprets one content stream onto a PIL canvas."""

    MAX_FORM_DEPTH = 6

    def __init__(self, doc: PdfDocument, page: dict, dpi: int):
        from PIL import Image, ImageDraw

        self.doc = doc
        self.dpi = dpi
        media = [
            float(doc.resolve(v))
            for v in (doc.resolve(page.get("MediaBox")) or [0, 0, 612, 792])
        ]
        x0, y0, x1, y1 = media
        self.scale = dpi / 72.0
        w = max(int(round((x1 - x0) * self.scale)), 1)
        h = max(int(round((y1 - y0) * self.scale)), 1)
        # MediaBox extents are untrusted input: a hostile PDF could declare
        # a kilometer-wide page and force a multi-GB allocation in the API
        # process. Clamp to MAX_PAGE_PX per side, scaling proportionally.
        shrink = MAX_PAGE_PX / max(w, h)
        if shrink < 1.0:
            self.scale *= shrink
            w = max(int(round(w * shrink)), 1)
            h = max(int(round(h * shrink)), 1)
        self.rotate = int(doc.resolve(page.get("Rotate")) or 0) % 360
        self.img = Image.new("L", (w, h), 255)
        self.draw = ImageDraw.Draw(self.img)
        # PDF user space (y up, origin at mediabox corner) -> raster (y down)
        self.base = _mat_mul(
            (1, 0, 0, 1, -x0, -y0),
            (self.scale, 0.0, 0.0, -self.scale, 0.0, h / 1.0),
        )
        self._font_cache: dict[tuple[bool, int], object] = {}
        self._fontinfo_cache: dict[int, FontInfo] = {}
        self.drew_anything = False

    # -- fonts --

    def _pil_font(self, bold: bool, px: int):
        """DejaVu Sans (bold) at ``px`` from the first of ``FONT_DIRS`` that
        holds it (the package's copy first, so that a machine without system
        fonts draws the same glyphs); PIL's bitmap default only for a font in
        none of them. ``FONTS_SERVED`` counts each file that served."""
        from PIL import ImageFont

        px = max(min(px, 512), 4)
        key = (bold, px)
        if key not in self._font_cache:
            name = "DejaVuSans-Bold.ttf" if bold else "DejaVuSans.ttf"
            for root in FONT_DIRS:
                try:
                    font = ImageFont.truetype(os.path.join(root, name), px)
                except OSError:
                    continue
                # PIL looks a missing file up by name in the system's font
                # directories: its path is the file that served
                path = font.path
                break
            else:
                font, path = ImageFont.load_default(), "PIL default"
            self._font_cache[key] = font
            with _FONTS_LOCK:
                FONTS_SERVED[path] += 1
        return self._font_cache[key]

    def _font_info(self, res: dict, name: str) -> FontInfo:
        fonts = self.doc.resolve(res.get("Font")) or {}
        fref = fonts.get(name)
        cache_key = fref[0] if isinstance(fref, Ref) else id(fref)
        if cache_key not in self._fontinfo_cache:
            self._fontinfo_cache[cache_key] = (
                load_font(self.doc, fref) if fref is not None else FontInfo()
            )
        return self._fontinfo_cache[cache_key]

    # -- interpreter --

    def run(self, content: bytes, resources: dict, depth: int = 0) -> None:
        gs = _GState(ctm=self.base)
        stack: list[_GState] = []
        operands: list[object] = []
        arr_depth = 0
        arr_stack: list[list] = []

        # text state
        tm = tlm = _IDENT
        font = FontInfo()
        pil_bold = False
        tfs = 12.0
        tc = tw = 0.0
        tl = 0.0
        th = 1.0
        path: list[tuple[str, tuple]] = []

        pos = 0
        n = len(content)
        while pos < n:
            m = _OP_RE.search(content, pos)
            if not m:
                break
            pos = m.end()
            if m.group("num"):
                val = float(m.group("num"))
                (arr_stack[-1] if arr_depth else operands).append(val)
                continue
            if m.group("name"):
                nm = Name(m.group("name")[1:].decode("latin-1"))
                (arr_stack[-1] if arr_depth else operands).append(nm)
                continue
            if m.group("str"):
                s, pos = _parse_string(content, m.start())
                (arr_stack[-1] if arr_depth else operands).append(s)
                continue
            if m.group("hex"):
                s, pos = _parse_hex_string(content, m.start())
                (arr_stack[-1] if arr_depth else operands).append(s)
                continue
            if m.group("dict"):
                try:
                    d, pos = parse_object(content, m.start())
                except PdfError:
                    d = {}
                operands.append(d)
                continue
            if m.group("arr"):
                arr_depth += 1
                arr_stack.append([])
                continue
            if m.group("close"):
                if m.group("close") == b"]" and arr_depth:
                    arr_depth -= 1
                    a = arr_stack.pop()
                    (arr_stack[-1] if arr_depth else operands).append(a)
                continue

            op = m.group("op").decode("latin-1")
            o = operands
            try:
                if op == "q":
                    stack.append(_GState(gs.ctm, gs.gray, gs.line_width))
                elif op == "Q":
                    if stack:
                        gs = stack.pop()
                elif op == "cm" and len(o) >= 6:
                    gs.ctm = _mat_mul(tuple(o[-6:]), gs.ctm)
                elif op == "BT":
                    tm = tlm = _IDENT
                elif op == "ET":
                    pass
                elif op == "Tf" and len(o) >= 2:
                    font = self._font_info(resources, str(o[-2]))
                    pil_bold = font.bold
                    tfs = float(o[-1])
                elif op == "Td" and len(o) >= 2:
                    tlm = _mat_mul((1, 0, 0, 1, float(o[-2]), float(o[-1])), tlm)
                    tm = tlm
                elif op == "TD" and len(o) >= 2:
                    tl = -float(o[-1])
                    tlm = _mat_mul((1, 0, 0, 1, float(o[-2]), float(o[-1])), tlm)
                    tm = tlm
                elif op == "Tm" and len(o) >= 6:
                    tm = tlm = tuple(float(v) for v in o[-6:])
                elif op == "T*":
                    tlm = _mat_mul((1, 0, 0, 1, 0.0, -tl), tlm)
                    tm = tlm
                elif op == "TL":
                    tl = float(o[-1])
                elif op == "Tc":
                    tc = float(o[-1])
                elif op == "Tw":
                    tw = float(o[-1])
                elif op == "Tz":
                    th = float(o[-1]) / 100.0
                elif op in ("Tj", "'", '"'):
                    if op != "Tj":
                        tlm = _mat_mul((1, 0, 0, 1, 0.0, -tl), tlm)
                        tm = tlm
                        if op == '"' and len(o) >= 3:
                            tw, tc = float(o[-3]), float(o[-2])
                    s = o[-1] if o and isinstance(o[-1], bytes) else b""
                    tm = self._show_text(s, font, tfs, tc, tw, th, tm, gs, pil_bold)
                elif op == "TJ" and o and isinstance(o[-1], list):
                    for item in o[-1]:
                        if isinstance(item, bytes):
                            tm = self._show_text(
                                item, font, tfs, tc, tw, th, tm, gs, pil_bold
                            )
                        elif isinstance(item, (int, float)):
                            tm = _mat_mul(
                                (1, 0, 0, 1, -item / 1000.0 * tfs * th, 0.0), tm
                            )
                # -- colors (anything -> luminance approximation) --
                elif op in ("g", "G"):
                    gs.gray = float(o[-1])
                elif op in ("rg", "RG") and len(o) >= 3:
                    r, gg, b = (float(v) for v in o[-3:])
                    gs.gray = 0.299 * r + 0.587 * gg + 0.114 * b
                elif op in ("k", "K") and len(o) >= 4:
                    c, mm, y, k = (float(v) for v in o[-4:])
                    gs.gray = (1 - min(c + k, 1.0)) * 0.7 + (
                        1 - min(mm + k, 1.0)
                    ) * 0.3
                elif op in ("sc", "scn", "SC", "SCN") and o:
                    nums = [v for v in o if isinstance(v, float)]
                    if nums:
                        gs.gray = sum(nums) / len(nums)
                elif op == "w":
                    gs.line_width = float(o[-1])
                # -- paths --
                elif op == "m" and len(o) >= 2:
                    path.append(("m", (float(o[-2]), float(o[-1]))))
                elif op == "l" and len(o) >= 2:
                    path.append(("l", (float(o[-2]), float(o[-1]))))
                elif op == "c" and len(o) >= 6:
                    path.append(("l", (float(o[-2]), float(o[-1]))))
                elif op == "v" and len(o) >= 4:
                    path.append(("l", (float(o[-2]), float(o[-1]))))
                elif op == "y" and len(o) >= 4:
                    path.append(("l", (float(o[-2]), float(o[-1]))))
                elif op == "re" and len(o) >= 4:
                    x, y, rw, rh = (float(v) for v in o[-4:])
                    path.append(("re", (x, y, rw, rh)))
                elif op == "h":
                    path.append(("h", ()))
                elif op in ("S", "s"):
                    self._paint_path(path, gs, fill=False)
                    path = []
                elif op in ("f", "F", "f*", "b", "b*", "B", "B*"):
                    self._paint_path(path, gs, fill=True)
                    path = []
                elif op == "n":
                    path = []
                elif op in ("W", "W*"):
                    pass  # clipping unsupported (rare in form content)
                # -- XObjects & inline images --
                elif op == "Do" and o:
                    self._do_xobject(str(o[-1]), resources, gs, depth)
                elif op == "BI":
                    pos = self._inline_image(content, pos, gs)
            except Exception:
                pass  # tolerant interpreter: skip malformed op
            if not arr_depth:
                operands = []

    # -- text drawing --

    def _show_text(
        self, s: bytes, font: FontInfo, tfs, tc, tw, th, tm, gs, bold
    ):
        if not s:
            return tm
        trm = _mat_mul(tm, gs.ctm)
        # effective glyph pixel size from the matrix's y-column magnitude
        px = (trm[2] ** 2 + trm[3] ** 2) ** 0.5 * tfs
        chars = font.decode(s)
        text = "".join(c for _, c in chars)
        if text.strip() and px >= 2:
            x0, y0 = _apply(trm, 0.0, 0.0)
            pf = self._pil_font(bold, int(round(px)))
            shade = int(max(min(gs.gray * 255, 255), 0))
            if shade < 250:  # skip white-on-white
                self.draw.text(
                    (x0, y0 - px), text, fill=shade, font=pf
                )
                self.drew_anything = True
        # advance: sum of glyph widths in text space
        adv = 0.0
        for code, c in chars:
            adv += font.width(code) / 1000.0 * tfs
            adv += tc
            if c == " ":
                adv += tw
        return _mat_mul((1, 0, 0, 1, adv * th, 0.0), tm)

    # -- path drawing --

    def _paint_path(self, path, gs: _GState, fill: bool) -> None:
        shade = int(max(min(gs.gray * 255, 255), 0))
        if shade > 250 and fill:
            return
        width_px = max(
            int(round(gs.line_width * (gs.ctm[0] ** 2 + gs.ctm[1] ** 2) ** 0.5)),
            1,
        )
        cur = None
        start = None
        pts: list[tuple] = []

        def flush_poly():
            nonlocal pts
            if len(pts) >= 2:
                if fill and len(pts) >= 3:
                    self.draw.polygon(pts, fill=shade)
                else:
                    self.draw.line(pts, fill=shade, width=width_px)
                self.drew_anything = True
            pts = []

        for kind, args in path:
            if kind == "m":
                flush_poly()
                cur = _apply(gs.ctm, *args)
                start = cur
                pts = [cur]
            elif kind == "l" and cur is not None:
                cur = _apply(gs.ctm, *args)
                pts.append(cur)
            elif kind == "h" and start is not None:
                pts.append(start)
            elif kind == "re":
                flush_poly()
                x, y, rw, rh = args
                corners = [
                    _apply(gs.ctm, x, y),
                    _apply(gs.ctm, x + rw, y),
                    _apply(gs.ctm, x + rw, y + rh),
                    _apply(gs.ctm, x, y + rh),
                ]
                if fill:
                    self.draw.polygon(corners, fill=shade)
                else:
                    self.draw.line(
                        corners + [corners[0]], fill=shade, width=width_px
                    )
                self.drew_anything = True
        flush_poly()

    # -- images & forms --

    def _do_xobject(self, name: str, resources: dict, gs: _GState, depth: int):
        xo = self.doc.resolve(resources.get("XObject")) or {}
        ref = xo.get(name)
        if not isinstance(ref, Ref):
            return
        sv = self.doc.stream_of(ref[0])
        if sv is None:
            return
        sdict, _raw = sv
        subtype = str(self.doc.resolve(sdict.get("Subtype")))
        if subtype == "Form":
            if depth >= self.MAX_FORM_DEPTH:
                return
            content = self.doc.decoded_stream(ref[0])
            if content is None:
                return
            inner_res = self.doc.resolve(sdict.get("Resources")) or resources
            saved = gs.ctm
            mtx = self.doc.resolve(sdict.get("Matrix"))
            if isinstance(mtx, list) and len(mtx) == 6:
                gs.ctm = _mat_mul(tuple(float(v) for v in mtx), gs.ctm)
            self.run_form(content, inner_res, gs, depth + 1)
            gs.ctm = saved
            return
        if subtype != "Image":
            return
        arr = self._decode_image_xobject(ref[0], sdict)
        if arr is None:
            return
        self._paste_image(arr, gs)

    def run_form(self, content: bytes, resources: dict, gs: _GState, depth: int):
        """Run a form XObject's content under the CURRENT ctm: reuse run()
        but seed its initial graphics state."""
        saved_base = self.base
        self.base = gs.ctm
        try:
            self.run(content, resources, depth)
        finally:
            self.base = saved_base

    def _decode_image_xobject(self, num: int, sdict: dict) -> np.ndarray | None:
        from PIL import Image

        doc = self.doc
        filters = doc.resolve(sdict.get("Filter"))
        if not isinstance(filters, list):
            filters = [filters] if filters else []
        fnames = {str(f) for f in filters}
        payload = doc.decoded_stream(num)
        if payload is None:
            return None
        w = int(doc.resolve(sdict.get("Width")) or 0)
        h = int(doc.resolve(sdict.get("Height")) or 0)
        if fnames & {"DCTDecode", "DCT", "JPXDecode"}:
            try:
                img = Image.open(io.BytesIO(payload)).convert("L")
                return np.asarray(img, np.uint8)
            except Exception:
                return None
        bpc = int(doc.resolve(sdict.get("BitsPerComponent")) or 8)
        if not w or not h:
            return None
        if doc.resolve(sdict.get("ImageMask")):
            bits = np.unpackbits(
                np.frombuffer(payload, np.uint8).reshape(h, -1), axis=1
            )[:, :w]
            return (bits * 255).astype(np.uint8)  # 1 = skip (white)
        cs = str(doc.resolve(sdict.get("ColorSpace")) or "DeviceGray")
        if bpc == 8 and len(payload) >= w * h * 3 and "RGB" in cs:
            rgb = np.frombuffer(payload[: w * h * 3], np.uint8).reshape(h, w, 3)
            return (
                0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
            ).astype(np.uint8)
        if bpc == 8 and len(payload) >= w * h:
            return np.frombuffer(payload[: w * h], np.uint8).reshape(h, w).copy()
        if bpc == 1 and len(payload) >= h * ((w + 7) // 8):
            bits = np.unpackbits(
                np.frombuffer(payload, np.uint8)[: h * ((w + 7) // 8)].reshape(
                    h, -1
                ),
                axis=1,
            )[:, :w]
            return (bits * 255).astype(np.uint8)
        return None

    def _paste_image(self, arr: np.ndarray, gs: _GState) -> None:
        from PIL import Image

        # image space is the unit square; map its corners through the CTM
        corners = [
            _apply(gs.ctm, 0, 0),
            _apply(gs.ctm, 1, 0),
            _apply(gs.ctm, 1, 1),
            _apply(gs.ctm, 0, 1),
        ]
        xs = [c[0] for c in corners]
        ys = [c[1] for c in corners]
        x0, x1 = int(min(xs)), int(max(xs))
        y0, y1 = int(min(ys)), int(max(ys))
        # CTM scale is untrusted: clamp the resize target (a hostile PDF can
        # place a unit-square image under a gigapixel transform)
        wpx = min(max(x1 - x0, 1), MAX_PAGE_PX)
        hpx = min(max(y1 - y0, 1), MAX_PAGE_PX)
        img = Image.fromarray(arr).resize((wpx, hpx), Image.BILINEAR)
        # source row 0 maps to unit y=1; flip only if the transform leaves
        # unit y=1 BELOW unit y=0 in raster space (mirrored placements)
        if _apply(gs.ctm, 0, 1)[1] > _apply(gs.ctm, 0, 0)[1]:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
        if _apply(gs.ctm, 1, 0)[0] < _apply(gs.ctm, 0, 0)[0]:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        self.img.paste(img, (x0, y0))
        self.drew_anything = True

    def _inline_image(self, content: bytes, pos: int, gs: _GState) -> int:
        """BI ... ID <data> EI — skip past (rendering inline images is rare
        in form documents; position recovery is what matters)."""
        idp = content.find(b"ID", pos)
        if idp < 0:
            return len(content)
        eip = content.find(b"EI", idp)
        return (eip + 2) if eip >= 0 else len(content)

    def finish(self) -> np.ndarray:
        from PIL import Image

        img = self.img
        if self.rotate:
            img = img.rotate(-self.rotate, expand=True)
        return np.asarray(img.convert("RGB"), np.uint8)


# ------------------------------------------------------------------- public


def render_pdf(data: bytes, dpi: int = 300) -> list[np.ndarray]:
    """PDF bytes -> list of (H, W, 3) uint8 RGB page rasters.

    Raises PdfError when the document yields no pages; returns pages with
    whatever subset of content rendered (tolerant interpreter).
    """
    doc = PdfDocument(data)
    pages = doc.pages()
    if not pages:
        raise PdfError("no pages found")
    out: list[np.ndarray] = []
    for page in pages:
        renderer = _PageRenderer(doc, page, dpi)
        contents = page.get("Contents")
        chunks: list[bytes] = []
        items = (
            doc.resolve(contents)
            if isinstance(doc.resolve(contents), list)
            else [contents]
        )
        for item in items or []:
            if isinstance(item, Ref):
                payload = doc.decoded_stream(item[0])
                if payload:
                    chunks.append(payload)
        resources = doc.resolve(page.get("Resources")) or {}
        if chunks:
            renderer.run(b"\n".join(chunks), resources)
        out.append(renderer.finish())
    return out
