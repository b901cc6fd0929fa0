"""Synthetic training data: rendered text lines and form pages (a copy of
ocr_system_tpu/training/synth.py; its output equals the JAX package's byte
for byte at a seed, wherever the same PIL, with the same text layout, and
fonts are present: PIL without raqm lays text out glyph by glyph, which
moves Devanagari matras and Latin advances).

PIL is imported where a line or page is drawn, not with the module, so the
rest of the port imports on a machine without it. The fonts ship with the
package (``assets/fonts/``: the five DejaVu files under their license in
``copyright``, and the Devanagari font that training/devanagari_font.py
builds), so a machine without system fonts or fontTools renders the same
pages; a font's coverage is read from its cmap table here, without
fontTools.

The reference trains nothing (all models are Azure/Gemini/Paddle-hosted), but
the TPU rebuild owns its models, and this zero-egress environment has no
pretrained checkpoints — so the framework ships a synthetic data engine:
DejaVu-rendered text lines (fonts baked into the image) with augmentations
for the recognizer, and composed form pages with known word quads for the
detector. This is the same strategy PP-OCR uses for its synth pretraining
corpora (PAPERS.md PP-OCRv3 §data).

Everything returns numpy; batching/sharding happens in training/train.py.
"""

from __future__ import annotations

import random
import string
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ocr_system_tpu_torch.models.charsets import Charset

_FONT_DIR = Path("/usr/share/fonts/truetype/dejavu")
FONTS = [
    "DejaVuSans.ttf",
    "DejaVuSans-Bold.ttf",
    "DejaVuSerif.ttf",
    "DejaVuSerif-Bold.ttf",
    "DejaVuSansMono.ttf",
]


PACKAGE_FONTS = Path(__file__).resolve().parents[1] / "assets" / "fonts"
DEVANAGARI_FONT = PACKAGE_FONTS / "OCRSynthDevanagari.ttf"


def discover_fonts(extra_dir: str | None = None) -> list[Path]:
    """Font files for rendering: the five DejaVu files (each from the
    system's DejaVu directory where it is there, else the package's copy),
    the package's Devanagari font (training/devanagari_font.py), then every
    .ttf of SYNTH_FONT_DIR (e.g. a real NotoSansDevanagari). The JAX
    package lists the same fonts in the same order once its generated
    Devanagari font exists."""
    import os

    fonts = [_FONT_DIR / f if (_FONT_DIR / f).is_file() else PACKAGE_FONTS / f
             for f in FONTS]
    fonts.append(DEVANAGARI_FONT)
    extra = extra_dir or os.environ.get("SYNTH_FONT_DIR")
    if extra and Path(extra).is_dir():
        fonts += sorted(Path(extra).glob("*.ttf"))
    return fonts


_CMAP_CACHE: dict[str, frozenset[int]] = {}
# the cmap subtables fontTools' getBestCmap prefers, in its order
_CMAP_PREFERENCES = ((3, 10), (0, 6), (0, 4), (3, 1), (0, 3), (0, 2), (0, 1), (0, 0))


def font_codepoints(path: Path) -> frozenset[int]:
    """Codepoints a font's cmap covers (cached per path): the keys of
    fontTools' ``getBestCmap()``, read from the file's cmap table."""
    key = str(path)
    if key not in _CMAP_CACHE:
        try:
            _CMAP_CACHE[key] = cmap_codepoints(Path(key).read_bytes())
        except Exception:
            _CMAP_CACHE[key] = frozenset()
    return _CMAP_CACHE[key]


def cmap_codepoints(data: bytes) -> frozenset[int]:
    """The codepoints of a TrueType file's preferred cmap subtable
    (formats 0, 4, 6 and 12; any other yields none)."""
    import struct

    n_tables = struct.unpack_from(">H", data, 4)[0]
    for i in range(n_tables):
        tag, _, table, _ = struct.unpack_from(">4sIII", data, 12 + 16 * i)
        if tag == b"cmap":
            break
    else:
        return frozenset()
    subtables: dict[tuple[int, int], int] = {}
    for i in range(struct.unpack_from(">H", data, table + 2)[0]):
        pid, eid, off = struct.unpack_from(">HHI", data, table + 4 + 8 * i)
        subtables.setdefault((pid, eid), table + off)
    at = next((subtables[k] for k in _CMAP_PREFERENCES if k in subtables), None)
    if at is None:
        return frozenset()
    fmt = struct.unpack_from(">H", data, at)[0]
    if fmt == 0:
        return frozenset(range(256))
    if fmt == 6:
        first, count = struct.unpack_from(">HH", data, at + 6)
        return frozenset(range(first, first + count))
    if fmt == 4:
        seg = struct.unpack_from(">H", data, at + 6)[0] // 2
        ends = struct.unpack_from(f">{seg}H", data, at + 14)
        starts = struct.unpack_from(f">{seg}H", data, at + 16 + 2 * seg)
        # fontTools leaves out the closing 0xFFFF segment
        return frozenset(c for a, b in zip(starts[:-1], ends[:-1]) for c in range(a, b + 1))
    if fmt == 12:
        n = struct.unpack_from(">I", data, at + 12)[0]
        groups = struct.unpack_from(f">{3 * n}I", data, at + 16)
        return frozenset(c for g in range(n)
                         for c in range(groups[3 * g], groups[3 * g + 1] + 1))
    return frozenset()


def fonts_covering(charset: Charset, paths: list[Path]) -> list[Path]:
    """Fonts that cover >=90% of the FULL charset (a font missing a script
    renders .notdef boxes, which poisons recognition training/eval — the
    round-2 Devanagari asset font leaking into Latin lines cost 30 CER
    points before per-text selection existed). Adds the package's
    Devanagari font when the charset needs that script."""
    need = {ord(c) for c in charset.chars if c != " "}
    if any(0x0900 <= cp <= 0x097F for cp in need) and DEVANAGARI_FONT not in paths:
        paths = paths + [DEVANAGARI_FONT]
    good = [
        p for p in paths
        if len(need & font_codepoints(p)) >= 0.9 * len(need)
    ]
    return good or paths


_WORDS = (
    "invoice total amount name date address phone email city state zip "
    "order number quantity price tax paid due balance customer vendor "
    "description item subtotal payment method account reference signature "
    "john mary smith garcia chen patel acme global services limited inc"
).split()

# common Hindi form vocabulary (Devanagari script); used when the charset
# covers Devanagari so recognition trains on plausible word shapes
_WORDS_HI = (
    "नाम पता फोन तारीख राशि कुल चालान संख्या ग्राहक हस्ताक्षर "
    "भुगतान खाता शहर राज्य देश विवरण मात्रा मूल्य कर देय शेष "
    "आवेदन प्रपत्र जन्म ईमेल कंपनी सेवा वस्तु आदेश रसीद बिल"
).split()


@dataclass
class LineSample:
    image: np.ndarray  # (H, W, 3) float32 [0,1]
    text: str
    width: int  # valid pixel width before padding


@dataclass
class PageSample:
    image: np.ndarray  # (H, W, 3) float32 [0,1]
    quads: np.ndarray  # (N, 4, 2) word quads
    texts: list[str]
    shrink_map: np.ndarray  # (H, W) float32 DB shrink target
    shrink_mask: np.ndarray  # (H, W) float32
    thresh_map: np.ndarray  # (H, W) float32 DB border target
    thresh_mask: np.ndarray  # (H, W) float32


class TextRenderer:
    def __init__(
        self, charset: Charset, seed: int = 0, font_dir: str | None = None
    ):
        self.charset = charset
        self.rng = random.Random(seed)
        self._all_fonts = discover_fonts(font_dir)
        self.font_paths = fonts_covering(charset, self._all_fonts)
        # script-appropriate word pool (see _WORDS_HI)
        self._devanagari = any(
            0x0900 <= ord(c) <= 0x097F for c in charset.chars
        )
        self._fonts: dict[tuple[str, int], ImageFont.FreeTypeFont] = {}

    def _font(self, name, size: int) -> ImageFont.FreeTypeFont:
        path = name if isinstance(name, Path) else _FONT_DIR / name
        key = (str(path), size)
        if key not in self._fonts:
            from PIL import ImageFont

            self._fonts[key] = ImageFont.truetype(str(path), size)
        return self._fonts[key]

    def _random_font(
        self, size: int, text: str | None = None
    ) -> ImageFont.FreeTypeFont:
        """Random font among those that can actually DRAW `text` — mixed
        pools (DejaVu + Devanagari asset font) must never render a line's
        chars as .notdef boxes.

        Falls back to ALL discovered fonts when the charset pool can't
        cover the text: Devanagari pages carry pure-ASCII lines (emails,
        'Key: value' fragments — real Hindi invoices have them) and the
        Devanagari asset font has no Latin letter glyphs; those lines
        rendered as tofu blocks, poisoning det training AND making the
        Hindi e2e eval unrecoverable by any OCR ('Email: amount' drew as
        11 solid boxes + a colon)."""
        pool = self.font_paths
        if text:
            need = {ord(c) for c in text if c != " "}
            covering = [
                p for p in pool
                if len(need & font_codepoints(p)) == len(need)
            ] or [
                p for p in self._all_fonts
                if len(need & font_codepoints(p)) == len(need)
            ]
            pool = covering or pool
        return self._font(self.rng.choice(pool), size)

    def random_text(
        self, max_words: int = 4, charset_only: bool = False
    ) -> str:
        """charset_only=True restricts output to text the CHARSET can
        encode — recognizer training/eval lines (a 'Email: amount' label
        encoded with the devanagari charset collapses to ':' while the
        pixels show the words: label poison). Page rendering (det
        training, e2e eval) keeps the unrestricted mix: Hindi pages DO
        carry ASCII lines, and serving routes those crops to the Latin
        recognizer (engine/script.py crop_script)."""
        r = self.rng
        kind = r.random()
        if kind < 0.45:
            n = r.randint(1, max_words)
            if self._devanagari:
                if r.random() < 0.35:  # open-vocab Hindi pseudo-words
                    # (same OOD-key rationale as the Latin branch below;
                    # Hindi form keys are synth_forms._pseudo_word_deva)
                    from ocr_system_tpu_torch.training.synth_forms import (
                        _pseudo_word_deva,
                    )

                    return " ".join(_pseudo_word_deva(r) for _ in range(n))
                return " ".join(r.choice(_WORDS_HI) for _ in range(n))
            if r.random() < 0.35:
                # open-vocabulary pseudo-words, SAME generator as the form
                # synthesizer's field keys (synth_forms._pseudo_word): form
                # labels are 50% pseudo-words at serving, and a recognizer
                # trained only on the fixed _WORDS pool misreads them
                # ('Nelolu' -> 'Neioiu' — measured, the largest exact-F1
                # key-noise family on seeds 5251/6260)
                from ocr_system_tpu_torch.training.synth_forms import _pseudo_word

                words = [_pseudo_word(r, 2, 4) for _ in range(n)]
            else:
                words = [r.choice(_WORDS) for _ in range(n)]
            if r.random() < 0.3:
                words = [w.capitalize() for w in words]
            elif r.random() < 0.15:
                words = [w.upper() for w in words]
            return " ".join(words)
        if kind < 0.65:  # numbers / amounts / dates / form-value formats
            fmt = r.random()
            if fmt < 0.25:
                return f"{r.randint(0, 9999)}.{r.randint(0, 99):02d}"
            if fmt < 0.4:
                amt = f"{r.randint(1, 99999):,}"
                # '$' is outside the devanagari charset
                return amt if self._devanagari and charset_only else f"${amt}"
            if fmt < 0.55:
                return (
                    f"{r.randint(1, 28):02d}/{r.randint(1, 12):02d}/"
                    f"{r.randint(1990, 2030)}"
                )
            if fmt < 0.65:
                return str(r.randint(10000, 999999999))
            # form VALUE formats, drawn from the form generator's own
            # distribution (synth_forms._VALUE_GEN) so recognition training
            # covers what form pages actually contain. The gap was measured:
            # space-separated digit groups ('+1 217 559 9837'), currency
            # codes ('CAD 96,810.69'), month-name dates and dotted emails
            # all lost their separators at serving ('+12175599837',
            # 'CAD96,810.69', 'carlos rossi@mailorg') because no training
            # line had ever shown an internal space inside a numeric value.
            if not self._devanagari:
                from ocr_system_tpu_torch.training.synth_forms import _VALUE_GEN

                ftype = r.choice(
                    ("phone", "phone", "currency", "currency", "date",
                     "email", "number", "name", "address")
                )
                return _VALUE_GEN[ftype](r)
            # Devanagari charset: ASCII-digit/punct formats only (letters
            # are not representable; ASCII-letter crops route to the Latin
            # recognizer at serving — engine/script.py crop_script)
            if r.random() < 0.5:
                # '+' is outside the devanagari charset; keep the spaced
                # digit groups (the separator regime is what matters)
                plus = "" if charset_only else "+"
                return r.choice((
                    f"{plus}1 {r.randint(200, 999)} {r.randint(100, 999)} "
                    f"{r.randint(1000, 9999)}",
                    f"({r.randint(200, 999)}) {r.randint(100, 999)}-"
                    f"{r.randint(1000, 9999)}",
                ))
            return (
                f"{r.randint(1, 99)},{r.randint(100, 999)}.{r.randint(0, 99):02d}"
            )
        if kind < 0.8:  # key: value fragments
            if self._devanagari and charset_only:
                if r.random() < 0.35:
                    from ocr_system_tpu_torch.training.synth_forms import (
                        _pseudo_word_deva,
                    )

                    return f"{_pseudo_word_deva(r)}: {r.choice(_WORDS_HI)}"
                return f"{r.choice(_WORDS_HI)}: {r.choice(_WORDS_HI)}"
            if r.random() < 0.35:  # pseudo-word keys (see word branch note)
                from ocr_system_tpu_torch.training.synth_forms import _pseudo_word

                key = " ".join(
                    _pseudo_word(r, 2, 4).capitalize()
                    for _ in range(r.randint(1, 2))
                )
                return f"{key}: {r.choice(_WORDS)}"
            return f"{r.choice(_WORDS).capitalize()}: {r.choice(_WORDS)}"
        if kind < 0.9 and not self._devanagari:
            # dotted-leader fragments ("Key ...... value" form rows): crops
            # containing long dot runs hallucinated ('!!!!', 'IIII') when
            # the recognizer had never seen them (round-3 forms diagnosis —
            # leader rows were the largest post-routing CER contributor).
            # Runs go to 80 dots: a small-font leader row is ~2200 px at
            # 48 px crop height and squeezes 3.5x into the 640 bucket —
            # the squeeze regime must be in training, not just the dots.
            dots = "." * r.randint(4, 80)
            roll = r.random()
            if roll < 0.3:
                return dots
            left = r.choice(_WORDS).capitalize()
            right = (
                str(r.randint(1, 999999)) if r.random() < 0.5
                else r.choice(_WORDS)
            )
            if roll < 0.65:
                return f"{left} {dots} {right}"
            return f"{dots} {right}"
        # random char soup over the charset (covers punctuation etc.)
        if self._devanagari:
            # STRUCTURED soup: Devanagari combining marks (matras, candra-
            # bindu, virama) are only valid after a base consonant — bare
            # mark sequences ('्ॊःछ२फ') render as degenerate glyph stacks
            # no real document contains, and they dominated the worst
            # e2e_hindi rows (diag round 5: page CER 0.42 on a 5-row page
            # whose soup rows were mark-only). Consonant(+optional matra)
            # clusters keep the coverage (rare consonants, digits, danda)
            # without the impossible sequences.
            cons = [chr(c) for c in range(0x0915, 0x093A)]
            cons += [chr(c) for c in range(0x0958, 0x0960)]
            matras = [chr(c) for c in range(0x093E, 0x094D)]
            extras = [chr(c) for c in range(0x0966, 0x0970)] + ["।", "॥"]
            out = []
            for _ in range(r.randint(3, 9)):
                roll = r.random()
                if roll < 0.2:
                    out.append(r.choice(extras))
                else:
                    out.append(r.choice(cons))
                    if r.random() < 0.5:
                        out.append(r.choice(matras))
            return "".join(out)
        alphabet = self.charset.chars.replace(" ", "") or string.ascii_letters
        n = r.randint(3, 12)
        return "".join(r.choice(alphabet) for _ in range(n))

    # ---- line crops for the recognizer ----

    def render_line(
        self, text: str | None = None, height: int = 48, max_width: int = 640,
        augment: bool = True, font_range: tuple[int, int] = (12, 38),
    ) -> LineSample:
        from PIL import Image, ImageDraw

        r = self.rng
        if text is None:
            text = self.random_text(charset_only=True)
        # 12px lower bound matters: form body text renders at 12-18px on
        # ~96-dpi-equivalent pages, so serving upsamples ~3-4x into the
        # 48px crop — training must cover that blur regime. font_range
        # narrows the distribution for targeted fine-tunes (round-3 forms
        # error analysis: the residual CER is small-font recognition).
        font_size = r.randint(*font_range) if augment else 30
        font = self._random_font(font_size, text)
        pad = r.randint(2, 8) if augment else 4
        # det-geometry margins: serving crops are DET boxes padded
        # det_box_pad_ratio (0.65) x height on every side, so glyphs fill
        # ~43% of the 48px crop, not ~90% like the tight render below.
        # Normal words survived the mismatch; dot-leader rows did not —
        # measured rec-only leader CER 0.95% on tight crops vs 33% at
        # det-pad geometry (half-height glyphs shrink the dots to ~2px).
        # A third of training lines carry serving-like margins.
        det_margin = 0.0
        if augment and r.random() < 0.35:
            det_margin = r.uniform(0.3, 0.8)
        # measure
        tmp = Image.new("L", (4, 4))
        d = ImageDraw.Draw(tmp)
        bbox = d.textbbox((0, 0), text, font=font)
        tw = max(bbox[2] - bbox[0], 1)
        th = max(bbox[3] - bbox[1], 1)
        pad_m = pad + int(det_margin * th)
        w = tw + 2 * pad_m
        h = th + 2 * pad_m
        bg = r.randint(200, 255) if augment else 255
        fg = r.randint(0, 80) if augment else 0
        img = Image.new("L", (w, h), bg)
        d = ImageDraw.Draw(img)
        d.text((pad_m - bbox[0], pad_m - bbox[1]), text, fill=fg, font=font)
        # scale to target height
        scale = height / h
        new_w = min(max(int(w * scale), 8), max_width)
        img = img.resize((new_w, height), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
        if augment:
            arr = self._rule_artifacts(arr, new_w, fg / 255.0)
            arr = self._augment(arr)
        out = np.zeros((height, max_width), np.float32)
        out[:, :new_w] = arr
        out3 = np.stack([out] * 3, axis=-1)
        return LineSample(image=out3, text=text, width=new_w)

    def _rule_artifacts(
        self, arr: np.ndarray, text_w: int, fg: float
    ) -> np.ndarray:
        """Table-rule artifacts: det boxes on form table rows include cell
        borders — full-height vertical bars between cells and horizontal
        row rules clipped at the crop's top/bottom edge. A recognizer that
        has never seen them decodes rules as '|'/'l'/'I' garbage (round-3
        forms diagnosis: table rows were a top forms-CER contributor after
        leaders). Target text is unchanged — the model learns rules are
        not glyphs. Parity bar: Azure reads bordered cells transparently
        (reference backend/services/ocr_service.py layout tables)."""
        r = self.rng
        if r.random() >= 0.25:
            return arr
        h = arr.shape[0]
        ink = max(fg, 0.0)
        if r.random() < 0.7:  # vertical cell separators
            for _ in range(r.randint(1, 3)):
                # half the bars sit at the crop edges: serving crops of
                # bordered cells carry the rule exactly at x~0 / x~text_w,
                # and bars at random interior x alone left edge bars
                # decoding as '|' (round-3 residual diagnosis)
                if r.random() < 0.5:
                    x = r.choice([r.randint(0, 3),
                                  max(text_w - r.randint(1, 4), 0)])
                else:
                    x = r.randint(0, max(text_w - 1, 1))
                wpx = r.randint(1, 2)
                arr[:, x:x + wpx] = np.minimum(
                    arr[:, x:x + wpx], ink + r.uniform(0.0, 0.15)
                )
        if r.random() < 0.6:  # horizontal row rule near an edge
            for y in {0, h - 1} if r.random() < 0.3 else {
                r.choice([r.randint(0, max(h // 6, 1)),
                          r.randint(h - max(h // 6, 1) - 1, h - 1)])
            }:
                hpx = r.randint(1, 2)
                y0 = min(max(y, 0), h - hpx)
                arr[y0:y0 + hpx, :text_w] = np.minimum(
                    arr[y0:y0 + hpx, :text_w], ink + r.uniform(0.0, 0.15)
                )
        return arr

    def _augment(self, arr: np.ndarray) -> np.ndarray:
        r = self.rng
        if r.random() < 0.35:
            # wire-sim: serving rec crops come from the det canvas, which
            # at det_wire_bits=2 carries 4 gray levels (0, 1/3, 2/3, 1)
            arr = np.round(arr * 3.0) / 3.0
        if r.random() < 0.5:  # gaussian noise
            arr = arr + np.random.default_rng(r.randrange(1 << 30)).normal(
                0, r.uniform(0.01, 0.05), arr.shape
            ).astype(np.float32)
        if r.random() < 0.3:  # contrast jitter
            mean = arr.mean()
            arr = mean + (arr - mean) * r.uniform(0.7, 1.3)
        return np.clip(arr, 0.0, 1.0)

    # ---- full pages for the detector ----

    def render_page(
        self, size: int = 640, n_lines: int | None = None, augment: bool = True
    ) -> PageSample:
        from PIL import Image, ImageDraw

        r = self.rng
        n_lines = n_lines or r.randint(4, 14)
        img = Image.new("L", (size, size), r.randint(235, 255))
        d = ImageDraw.Draw(img)
        quads: list[np.ndarray] = []
        texts: list[str] = []
        y = r.randint(10, 40)
        while len(texts) < n_lines and y < size - 40:
            x = r.randint(8, size // 3)
            text = self.random_text(max_words=3)
            font = self._random_font(r.randint(14, 30), text)
            bbox = d.textbbox((x, y), text, font=font)
            if bbox[2] >= size - 4:
                text = text.split()[0]
                bbox = d.textbbox((x, y), text, font=font)
            if bbox[2] < size - 4 and bbox[3] < size - 4:
                d.text((x, y), text, fill=r.randint(0, 70), font=font)
                x0, y0, x1, y1 = bbox
                quads.append(
                    np.array(
                        [[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32
                    )
                )
                texts.append(text)
            y = bbox[3] + r.randint(6, 30)
        arr = np.asarray(img, np.float32) / 255.0
        if augment and r.random() < 0.5:
            arr = np.clip(
                arr + np.random.default_rng(r.randrange(1 << 30)).normal(
                    0, 0.02, arr.shape
                ).astype(np.float32),
                0, 1,
            )
        quads_arr = (
            np.stack(quads) if quads else np.zeros((0, 4, 2), np.float32)
        )
        shrink, smask, thresh, tmask = make_db_targets(size, quads_arr)
        return PageSample(
            image=np.stack([arr] * 3, axis=-1),
            quads=quads_arr,
            texts=texts,
            shrink_map=shrink,
            shrink_mask=smask,
            thresh_map=thresh,
            thresh_mask=tmask,
        )


def make_db_targets(
    size: int, quads: np.ndarray, shrink_ratio: float = 0.4
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """DB ground truth: shrunken positive region, border threshold band.

    Follows Liao et al.: each text quad is shrunk by offset
    d = area*(1-r^2)/perimeter for the probability target; the band between
    the shrunk and dilated quad forms the threshold target.
    """
    shrink = np.zeros((size, size), np.float32)
    smask = np.ones((size, size), np.float32)
    thresh = np.zeros((size, size), np.float32)
    tmask = np.zeros((size, size), np.float32)
    for quad in quads:
        x0, y0 = quad[:, 0].min(), quad[:, 1].min()
        x1, y1 = quad[:, 0].max(), quad[:, 1].max()
        w, h = x1 - x0, y1 - y0
        if w < 4 or h < 4:
            continue
        area = w * h
        peri = 2 * (w + h)
        d = area * (1 - shrink_ratio**2) / max(peri, 1e-6)
        d = min(d, min(w, h) / 2 - 1)
        # all effects live inside the dilated window — computing the grids
        # per-window instead of per-page makes target generation O(sum of
        # box areas), ~15x faster on dense pages (host render throughput
        # bounds the detector's data diversity on this 1-core machine)
        wx0 = max(int(np.floor(x0 - d)), 0)
        wy0 = max(int(np.floor(y0 - d)), 0)
        wx1 = min(int(np.ceil(x1 + d)) + 1, size)
        wy1 = min(int(np.ceil(y1 + d)) + 1, size)
        if wx1 <= wx0 or wy1 <= wy0:
            continue
        ys, xs = np.mgrid[wy0:wy1, wx0:wx1]
        win = (slice(wy0, wy1), slice(wx0, wx1))
        # shrunk rectangle -> positive
        sx0, sy0, sx1, sy1 = x0 + d, y0 + d, x1 - d, y1 - d
        inside = (xs >= sx0) & (xs <= sx1) & (ys >= sy0) & (ys <= sy1)
        shrink[win][inside] = 1.0
        # dilated band -> threshold target rises toward the text edge
        band = ~inside  # window = dilated rect; everything else is the band
        # distance to the original rect edge, normalized by d
        dist_x = np.maximum(np.maximum(x0 - xs, xs - x1), 0)
        dist_y = np.maximum(np.maximum(y0 - ys, ys - y1), 0)
        dist = np.sqrt(dist_x**2 + dist_y**2)
        inner_dist = np.minimum(
            np.minimum(xs - x0, x1 - xs), np.minimum(ys - y0, y1 - ys)
        )
        signed = np.where(dist > 0, dist, -np.clip(inner_dist, 0, d))
        tval = np.clip(1.0 - np.abs(signed) / max(d, 1e-6), 0, 1)
        t_win = thresh[win]
        t_win[band] = np.maximum(t_win[band], tval[band])
        thresh[win] = t_win
        m_win = tmask[win]
        m_win[band] = 1.0
        tmask[win] = m_win
    return shrink, smask, thresh, tmask


def layout_page_to_tokens(
    page: PageSample, charset: Charset, max_len: int, page_size: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Convert a rendered page into layout-extractor training tokens with
    BIO tags derived from the 'Key: value' structure of rendered lines.
    Returns (ids, boxes, mask, tags, types)."""
    from ocr_system_tpu_torch.extract.rules import infer_field_type
    from ocr_system_tpu_torch.models.layout_extractor import COORD_BUCKETS, FIELD_TYPES

    ids = np.zeros((max_len,), np.int32)
    boxes = np.zeros((max_len, 4), np.int32)
    mask = np.zeros((max_len,), np.int32)
    tags = np.zeros((max_len,), np.int32)
    types = np.zeros((max_len,), np.int32)
    type_index = {t: i for i, t in enumerate(FIELD_TYPES)}
    pos = 0
    for quad, text in zip(page.quads, page.texts):
        q = [
            int(quad[:, 0].min() / page_size * (COORD_BUCKETS - 1)),
            int(quad[:, 1].min() / page_size * (COORD_BUCKETS - 1)),
            int(quad[:, 0].max() / page_size * (COORD_BUCKETS - 1)),
            int(quad[:, 1].max() / page_size * (COORD_BUCKETS - 1)),
        ]
        if ":" in text:
            key, _, value = text.partition(":")
            value = value.strip()
            ftype = type_index.get(infer_field_type(key, value), 0)
            spans = [(key + ":", 1, 2, 0), (" ", 0, 0, 0), (value, 3, 4, ftype)]
        else:
            spans = [(text, 0, 0, 0)]
        for span_text, b_tag, i_tag, ftype in spans:
            for ci, ch in enumerate(span_text):
                if pos >= max_len:
                    break
                ids[pos] = charset.char_to_id(ch)
                boxes[pos] = q
                mask[pos] = 1
                tags[pos] = b_tag if ci == 0 else i_tag
                types[pos] = ftype
                pos += 1
        if pos < max_len:  # inter-line space
            mask[pos] = 1
            pos += 1
    return ids, boxes, mask, tags, types
