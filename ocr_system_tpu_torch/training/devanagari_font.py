"""Synthetic Devanagari TTF generator (a copy of
ocr_system_tpu/training/devanagari_font.py; fontTools is imported in
``build_font`` only, and ``ensure_font`` builds into the same gitignored
``assets/fonts/``). The port's renderers read the build committed in the
package, ``ocr_system_tpu_torch/assets/fonts/OCRSynthDevanagari.ttf``
(training/synth.DEVANAGARI_FONT), so they need no fontTools.

The deployment image ships only DejaVu (no Devanagari coverage) and the
build environment has no network egress, so the Hindi recognition pipeline
cannot rely on a vendored Noto font. This module builds a REAL TrueType font
programmatically (fontTools FontBuilder) whose glyphs are stroke-program
approximations of Devanagari letterforms: shirorekha headline, right-side
stems, and per-character bodies drawn as stroked polylines.

Fidelity statement (do not overclaim): shapes are hand-authored
approximations for the common letters and systematic-but-deterministic
constructions for rare codepoints — adequate for training/evaluating the
recognizer end-to-end (every codepoint maps to one stable, visually distinct
glyph, matching the char-level CTC charset 1:1), NOT for typography.
Pointing SYNTH_FONT_DIR at a directory with a real NotoSansDevanagari
swaps it in everywhere with zero code changes (synth.discover_fonts).

Matras/combining signs are emitted as SPACING glyphs because PIL renders
codepoint-per-glyph without complex shaping (no libraqm in the image); the
recognizer therefore sees exactly the codepoint sequence it must decode.
"""

from __future__ import annotations

import math
from pathlib import Path

# font metrics (units per em = 1000)
UPM = 1000
BASE = 0  # baseline
XH = 620  # body top (headline sits just above)
HEAD_Y = 660  # shirorekha center
DESC = -220
ADV = 640  # default advance width
W = 540  # body width inside the advance
STROKE = 72  # stroke thickness

_DEFAULT_DIR = Path(__file__).resolve().parents[2] / "assets" / "fonts"
FONT_NAME = "OCRSynthDevanagari"


# ---------------------------------------------------------------- strokes
#
# Each glyph program: list of polylines in a unit box (x in [0,1] across W,
# y in [0,1] from baseline to XH; y may exceed [0,1] for matras above the
# headline or below the baseline). "head": draw the shirorekha. "stem":
# right vertical bar (the ka-family spine).


def _c(cx, cy, r, a0, a1, n=10, rx=None, ry=None):
    """Arc polyline, angles in degrees, unit coords."""
    rx = r if rx is None else rx
    ry = r if ry is None else ry
    return [
        (cx + rx * math.cos(math.radians(a)), cy + ry * math.sin(math.radians(a)))
        for a in [a0 + (a1 - a0) * i / n for i in range(n + 1)]
    ]


_G: dict[int, dict] = {}


def _def(cp: int, *strokes, head=True, stem=False, adv=1.0):
    _G[cp] = {"strokes": list(strokes), "head": head, "stem": stem, "adv": adv}


# vowels --------------------------------------------------------------
_def(0x0905,  # अ
     _c(0.32, 0.62, 0.22, 40, 320), [(0.48, 0.0), (0.48, 0.45), (0.3, 0.45)],
     stem=True)
_def(0x0906,  # आ = अ + right hook
     _c(0.26, 0.62, 0.2, 40, 320), [(0.42, 0.0), (0.42, 0.45)],
     [(0.95, 1.0), (0.95, 0.0)], stem=True)
_def(0x0907,  # इ
     _c(0.45, 0.55, 0.3, -60, 200), [(0.45, 0.85), (0.45, 1.0)])
_def(0x0908,  # ई = इ + curl
     _c(0.4, 0.55, 0.28, -60, 200), _c(0.75, 1.15, 0.18, 180, 340))
_def(0x0909,  # उ
     _c(0.5, 0.5, 0.35, -90, 170), [(0.85, 0.5), (0.85, 0.95)])
_def(0x090A,  # ऊ
     _c(0.45, 0.55, 0.3, -90, 170), _c(0.78, 0.25, 0.16, -90, 120))
_def(0x090B,  # ऋ
     [(0.5, 1.0), (0.5, 0.35)], _c(0.5, 0.28, 0.22, 150, 390),
     _c(0.32, 0.7, 0.2, 90, 270))
_def(0x090F,  # ए
     [(0.75, 1.0), (0.3, 0.55), (0.75, 0.3)], _c(0.68, 0.18, 0.14, 30, 270))
_def(0x0910,  # ऐ
     [(0.7, 1.0), (0.3, 0.55), (0.7, 0.3)], _c(0.64, 0.18, 0.13, 30, 270),
     [(0.45, 1.0), (0.3, 1.25)])
_def(0x0913,  # ओ
     _c(0.35, 0.6, 0.22, 40, 320), [(0.52, 0.0), (0.52, 0.45)],
     [(0.95, 1.0), (0.95, 0.0)], [(0.7, 1.0), (0.82, 1.25)], stem=True)
_def(0x0914,  # औ
     _c(0.33, 0.6, 0.2, 40, 320), [(0.5, 0.0), (0.5, 0.45)],
     [(0.95, 1.0), (0.95, 0.0)], _c(0.75, 1.22, 0.16, 160, 380), stem=True)

# consonants ----------------------------------------------------------
_def(0x0915,  # क
     [(0.55, 0.0), (0.55, 1.0)], _c(0.3, 0.55, 0.22, -70, 160),
     [(0.62, 0.5), (0.85, 0.28)], stem=False)
_def(0x0916,  # ख
     _c(0.25, 0.6, 0.18, 0, 330), [(0.42, 0.15), (0.6, 0.0)],
     [(0.8, 0.0), (0.8, 1.0)], _c(0.6, 0.5, 0.17, 120, 300))
_def(0x0917,  # ग
     [(0.35, 1.0), (0.35, 0.3)], _c(0.5, 0.26, 0.17, 160, 380),
     [(0.78, 0.0), (0.78, 1.0)])
_def(0x0918,  # घ
     _c(0.32, 0.32, 0.2, 100, 380), [(0.52, 0.9), (0.52, 0.25)],
     [(0.8, 0.0), (0.8, 1.0)])
_def(0x0919,  # ङ
     _c(0.45, 0.45, 0.3, -30, 210), [(0.72, 0.3), (0.85, 0.12)],
     [(0.8, 0.55), (0.8, 0.62)])
_def(0x091A,  # च
     _c(0.4, 0.5, 0.24, -30, 260), [(0.6, 0.62), (0.78, 0.62)],
     [(0.78, 0.0), (0.78, 1.0)])
_def(0x091B,  # छ
     _c(0.35, 0.68, 0.15, 0, 360), _c(0.45, 0.3, 0.22, 120, 420),
     [(0.6, 0.5), (0.6, 0.0)])
_def(0x091C,  # ज
     [(0.25, 0.72), (0.55, 0.72)], _c(0.42, 0.45, 0.24, 60, 300),
     [(0.78, 0.0), (0.78, 1.0)])
_def(0x091D,  # झ
     _c(0.3, 0.6, 0.17, 0, 330), _c(0.3, 0.25, 0.17, 30, 360),
     [(0.55, 0.45), (0.78, 0.45)], [(0.78, 0.0), (0.78, 1.0)])
_def(0x091E,  # ञ
     [(0.25, 0.7), (0.7, 0.7)], _c(0.45, 0.35, 0.25, 150, 390),
     [(0.25, 0.0), (0.7, 0.0)])
_def(0x091F,  # ट
     _c(0.5, 0.55, 0.33, -90, 120))
_def(0x0920,  # ठ
     _c(0.5, 0.55, 0.33, -90, 120), _c(0.5, 0.5, 0.14, 0, 360))
_def(0x0921,  # ड
     _c(0.5, 0.55, 0.3, -90, 150), [(0.72, 0.2), (0.85, 0.05)])
_def(0x0922,  # ढ
     _c(0.5, 0.58, 0.28, -90, 150), _c(0.62, 0.16, 0.13, 90, 330))
_def(0x0923,  # ण
     [(0.2, 0.75), (0.75, 0.75)], _c(0.48, 0.45, 0.26, 30, 330),
     [(0.85, 0.0), (0.85, 1.0)])
_def(0x0924,  # त
     [(0.3, 1.0), (0.3, 0.45)], _c(0.42, 0.35, 0.2, 140, 360),
     [(0.75, 0.0), (0.75, 1.0)])
_def(0x0925,  # थ
     _c(0.33, 0.62, 0.18, -60, 240), _c(0.33, 0.25, 0.18, 60, 300),
     [(0.75, 0.0), (0.75, 1.0)])
_def(0x0926,  # द
     _c(0.5, 0.6, 0.26, -20, 230), [(0.35, 0.35), (0.6, 0.12), (0.4, 0.0)])
_def(0x0927,  # ध
     _c(0.45, 0.55, 0.26, -30, 240), [(0.4, 0.15), (0.62, 0.0)],
     [(0.8, 0.0), (0.8, 1.0)])
_def(0x0928,  # न
     [(0.25, 0.62), (0.6, 0.62)], [(0.42, 0.62), (0.42, 0.25)],
     [(0.25, 0.0), (0.78, 0.0)], [(0.78, 0.0), (0.78, 1.0)])
_def(0x092A,  # प
     [(0.3, 1.0), (0.3, 0.0), (0.6, 0.0)], [(0.78, 0.0), (0.78, 1.0)])
_def(0x092B,  # फ
     [(0.3, 1.0), (0.3, 0.0), (0.55, 0.0)], [(0.72, 0.0), (0.72, 1.0)],
     _c(0.86, 0.6, 0.13, -90, 90))
_def(0x092C,  # ब
     [(0.3, 0.85), (0.3, 0.15)], [(0.3, 0.5), (0.6, 0.5)],
     _c(0.45, 0.3, 0.2, 180, 360), [(0.78, 0.0), (0.78, 1.0)])
_def(0x092D,  # भ
     [(0.25, 0.75), (0.55, 0.75), (0.4, 0.3)], _c(0.5, 0.25, 0.18, 150, 390),
     [(0.78, 0.0), (0.78, 1.0)])
_def(0x092E,  # म
     [(0.3, 0.0), (0.3, 0.6)], _c(0.42, 0.62, 0.15, 100, 420),
     [(0.55, 0.35), (0.3, 0.2)], [(0.78, 0.0), (0.78, 1.0)])
_def(0x092F,  # य
     _c(0.35, 0.5, 0.2, 90, 330), [(0.5, 0.35), (0.5, 0.0), (0.72, 0.0)],
     [(0.78, 0.0), (0.78, 1.0)])
_def(0x0930,  # र
     [(0.5, 1.0), (0.5, 0.45)], [(0.5, 0.6), (0.3, 0.3), (0.62, 0.0)],
     stem=False)
_def(0x0932,  # ल
     _c(0.33, 0.55, 0.2, -60, 200), [(0.5, 0.7), (0.5, 0.25)],
     _c(0.62, 0.2, 0.15, 120, 380))
_def(0x0935,  # व
     _c(0.38, 0.35, 0.22, -60, 260), [(0.55, 0.55), (0.78, 0.55)],
     [(0.78, 0.0), (0.78, 1.0)])
_def(0x0936,  # श
     _c(0.35, 0.62, 0.18, -40, 260), [(0.45, 0.35), (0.3, 0.0)],
     [(0.78, 0.0), (0.78, 1.0)], [(0.5, 0.25), (0.65, 0.4)])
_def(0x0937,  # ष
     [(0.25, 0.8), (0.7, 0.8), (0.35, 0.3)], [(0.25, 0.45), (0.7, 0.45)],
     [(0.78, 0.0), (0.78, 1.0)])
_def(0x0938,  # स
     [(0.25, 0.7), (0.45, 0.7), (0.35, 0.35)], _c(0.45, 0.3, 0.17, 150, 390),
     [(0.62, 0.45), (0.78, 0.45)], [(0.78, 0.0), (0.78, 1.0)])
_def(0x0939,  # ह
     _c(0.4, 0.62, 0.18, -60, 230), _c(0.52, 0.25, 0.18, 100, 390),
     [(0.62, 0.5), (0.62, 0.15)])

# matras / signs (spacing forms; see module docstring) ---------------
_def(0x093E, [(0.5, 0.0), (0.5, 1.0)], adv=0.55)  # ा
_def(0x093F, [(0.6, 0.0), (0.6, 1.0)], _c(0.38, 1.12, 0.24, 0, 180),
     adv=0.6)  # ि
_def(0x0940, [(0.4, 0.0), (0.4, 1.0)], _c(0.62, 1.12, 0.24, 0, 180),
     adv=0.6)  # ी
_def(0x0941, _c(0.5, -0.28, 0.2, 20, 270), head=False, adv=0.55)  # ु
_def(0x0942, _c(0.5, -0.3, 0.2, -90, 160), head=False, adv=0.55)  # ू
_def(0x0943, _c(0.5, -0.28, 0.17, -60, 200), head=False, adv=0.5)  # ृ
_def(0x0947, [(0.3, 1.0), (0.62, 1.3), (0.62, 1.0)], adv=0.55)  # े
_def(0x0948, [(0.28, 1.0), (0.5, 1.3), (0.5, 1.0)],
     [(0.5, 1.0), (0.72, 1.3), (0.72, 1.0)], adv=0.6)  # ै
_def(0x094B, [(0.45, 0.0), (0.45, 1.0)], [(0.45, 1.0), (0.72, 1.3)],
     adv=0.6)  # ो
_def(0x094C, [(0.45, 0.0), (0.45, 1.0)], _c(0.6, 1.2, 0.15, 160, 380),
     adv=0.6)  # ौ
_def(0x094D, [(0.45, -0.05), (0.62, -0.25)], head=False, adv=0.45)  # ्
_def(0x0901, _c(0.5, 1.25, 0.2, 180, 360), [(0.5, 1.42), (0.5, 1.48)],
     head=False, adv=0.5)  # ँ
_def(0x0902, [(0.5, 1.25), (0.5, 1.31)], head=False, adv=0.45)  # ं
_def(0x0903, [(0.5, 0.62), (0.5, 0.68)], [(0.5, 0.12), (0.5, 0.18)],
     head=False, adv=0.45)  # ः
_def(0x093C, [(0.5, -0.3), (0.5, -0.36)], head=False, adv=0.45)  # ़

# punctuation / digits ------------------------------------------------
_def(0x0964, [(0.5, -0.1), (0.5, 1.05)], head=False, adv=0.5)  # ।
_def(0x0965, [(0.38, -0.1), (0.38, 1.05)], [(0.62, -0.1), (0.62, 1.05)],
     head=False, adv=0.7)  # ॥

# ASCII digits + the punctuation the devanagari charset carries
# (string.digits + ".,:/-() ") — needed so the font covers that charset
# FULLY and Hindi forms can show amounts/dates without switching fonts
_def(0x2E, _c(0.5, 0.06, 0.06, 0, 360), head=False, adv=0.4)  # .
_def(0x2C, [(0.52, 0.1), (0.44, -0.12)], head=False, adv=0.4)  # ,
_def(0x3A, _c(0.5, 0.15, 0.05, 0, 360), _c(0.5, 0.55, 0.05, 0, 360),
     head=False, adv=0.4)  # :
_def(0x2F, [(0.3, -0.05), (0.7, 0.95)], head=False, adv=0.55)  # /
_def(0x2D, [(0.3, 0.4), (0.7, 0.4)], head=False, adv=0.55)  # -
_def(0x28, _c(0.72, 0.45, 0.42, 110, 250, rx=0.3), head=False, adv=0.45)  # (
_def(0x29, _c(0.28, 0.45, 0.42, -70, 70, rx=0.3), head=False, adv=0.45)  # )

_ASCII_DIGITS = {
    0x30: [_c(0.5, 0.45, 0.33, 0, 360, rx=0.26)],  # 0
    0x31: [[(0.35, 0.72), (0.52, 0.9), (0.52, 0.0)],
           [(0.32, 0.0), (0.72, 0.0)]],  # 1
    0x32: [_c(0.5, 0.68, 0.2, 0, 180), [(0.7, 0.68), (0.3, 0.0)],
           [(0.3, 0.0), (0.72, 0.0)]],  # 2
    0x33: [_c(0.46, 0.66, 0.2, 140, -80), _c(0.46, 0.26, 0.23, 80, -140)],  # 3
    0x34: [[(0.62, 0.0), (0.62, 0.9), (0.28, 0.3), (0.78, 0.3)]],  # 4
    0x35: [[(0.7, 0.9), (0.34, 0.9), (0.32, 0.5)],
           _c(0.48, 0.27, 0.24, 90, 400)],  # 5
    0x36: [_c(0.5, 0.28, 0.24, 0, 360), [(0.36, 0.45), (0.58, 0.9)]],  # 6
    0x37: [[(0.28, 0.9), (0.74, 0.9), (0.44, 0.0)]],  # 7
    0x38: [_c(0.5, 0.65, 0.19, 0, 360), _c(0.5, 0.25, 0.23, 0, 360)],  # 8
    0x39: [_c(0.5, 0.62, 0.24, 0, 360), [(0.64, 0.45), (0.42, 0.0)]],  # 9
}
for _cp, _st in _ASCII_DIGITS.items():
    _def(_cp, *_st, head=False, adv=0.75)


_DEV_DIGITS = {  # ०१२३४५६७८९ — distinct, headline-free
    0x0966: [_c(0.5, 0.5, 0.3, 0, 360)],
    0x0967: [[(0.5, 0.9), (0.5, 0.15)], _c(0.42, 0.12, 0.1, 180, 330)],
    0x0968: [_c(0.45, 0.68, 0.2, -60, 180), [(0.48, 0.45), (0.35, 0.1),
             (0.68, 0.1)]],
    0x0969: [_c(0.45, 0.7, 0.18, -90, 180), _c(0.45, 0.32, 0.2, 90, 420)],
    0x096A: [[(0.3, 0.85), (0.68, 0.5), (0.3, 0.5)], [(0.55, 0.85),
             (0.55, 0.1)]],
    0x096B: [[(0.35, 0.9), (0.65, 0.9), (0.45, 0.55)],
             _c(0.52, 0.3, 0.24, 60, 330)],
    0x096C: [_c(0.52, 0.3, 0.24, 0, 300), [(0.6, 0.5), (0.4, 0.9)]],
    0x096D: [[(0.3, 0.9), (0.68, 0.9), (0.42, 0.1)]],
    0x096E: [_c(0.5, 0.65, 0.18, 0, 360), _c(0.5, 0.27, 0.2, 0, 360)],
    0x096F: [_c(0.5, 0.65, 0.2, 0, 360), [(0.68, 0.62), (0.55, 0.1)]],
}
for cp, strokes in _DEV_DIGITS.items():
    _def(cp, *strokes, head=False, adv=0.8)


def _systematic(cp: int) -> dict:
    """Deterministic distinct shape for codepoints without a hand-authored
    program: stem + 2 arcs + 1 chord whose parameters derive from the
    codepoint, so every glyph is stable and visually distinct."""
    h = cp * 2654435761 & 0xFFFFFFFF

    def pick(lo, hi, shift):
        return lo + ((h >> shift) & 0xFF) / 255 * (hi - lo)

    strokes = [
        _c(pick(0.28, 0.45, 0), pick(0.3, 0.6, 8), pick(0.14, 0.26, 16),
           pick(-90, 90, 4), pick(180, 350, 12)),
        [(pick(0.2, 0.4, 20), pick(0.1, 0.5, 24)),
         (pick(0.5, 0.7, 2), pick(0.5, 0.95, 6))],
    ]
    if (h >> 9) & 1:
        strokes.append(_c(0.5, pick(0.15, 0.4, 10), 0.13, 0, 300))
    return {"strokes": strokes, "head": True, "stem": bool((h >> 3) & 1),
            "adv": 1.0}


# ----------------------------------------------------------------- builder


def _stroke_to_contours(pts: list[tuple], scale_x: float, pen, width=STROKE):
    """Stroke a polyline into a closed quadrilateral-per-segment outline
    plus square caps — simple, robust, renders solid at text sizes."""
    if len(pts) < 2:
        return
    hw = width / 2.0
    for (x1, y1), (x2, y2) in zip(pts, pts[1:]):
        X1, Y1 = x1 * W * scale_x + 50, BASE + y1 * XH
        X2, Y2 = x2 * W * scale_x + 50, BASE + y2 * XH
        dx, dy = X2 - X1, Y2 - Y1
        ln = math.hypot(dx, dy) or 1.0
        nx, ny = -dy / ln * hw, dx / ln * hw
        ex, ey = dx / ln * hw, dy / ln * hw  # cap extension
        pen.moveTo((round(X1 - nx - ex), round(Y1 - ny - ey)))
        pen.lineTo((round(X1 + nx - ex), round(Y1 + ny - ey)))
        pen.lineTo((round(X2 + nx + ex), round(Y2 + ny + ey)))
        pen.lineTo((round(X2 - nx + ex), round(Y2 - ny + ey)))
        pen.closePath()


def build_font(out_path: str | Path | None = None) -> Path:
    """Build the TTF. Returns the written path."""
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen

    out = Path(out_path) if out_path else _DEFAULT_DIR / f"{FONT_NAME}.ttf"
    out.parent.mkdir(parents=True, exist_ok=True)

    # full coverage: every codepoint the devanagari charset can emit,
    # including its ASCII digits/punctuation tail (models/charsets.py)
    cps = sorted(
        set(range(0x0901, 0x0964)) | {0x0964, 0x0965}
        | set(range(0x0966, 0x0970))
        | set(range(0x30, 0x3A))  # 0-9
        | {0x2E, 0x2C, 0x3A, 0x2F, 0x2D, 0x28, 0x29}
    )
    glyph_order = [".notdef", "space"] + [f"uni{cp:04X}" for cp in cps]
    cmap = {0x20: "space", 0xA0: "space"}
    glyphs = {}
    advances = {}

    pen = TTGlyphPen(None)
    pen.moveTo((100, 0)); pen.lineTo((100, 700))
    pen.lineTo((500, 700)); pen.lineTo((500, 0)); pen.closePath()
    glyphs[".notdef"] = pen.glyph()
    advances[".notdef"] = (600, 100)

    pen = TTGlyphPen(None)
    glyphs["space"] = pen.glyph()
    advances["space"] = (320, 0)

    for cp in cps:
        prog = _G.get(cp) or _systematic(cp)
        name = f"uni{cp:04X}"
        cmap[cp] = name
        scale_x = prog["adv"]
        pen = TTGlyphPen(None)
        for stroke in prog["strokes"]:
            _stroke_to_contours(stroke, scale_x, pen)
        adv = int(ADV * scale_x)
        if prog["head"]:
            # shirorekha spans the full advance so adjacent letters join
            _stroke_to_contours(
                [(-0.05 / scale_x, (HEAD_Y - BASE) / XH),
                 ((adv - 50) / (W * scale_x), (HEAD_Y - BASE) / XH)],
                scale_x, pen, width=56,
            )
        if prog["stem"]:
            _stroke_to_contours(
                [(0.92, 0.0), (0.92, (HEAD_Y - BASE) / XH)], scale_x, pen
            )
        glyphs[name] = pen.glyph()
        advances[name] = (adv, 0)

    fb = FontBuilder(UPM, isTTF=True)
    fb.setupGlyphOrder(glyph_order)
    fb.setupCharacterMap(cmap)
    fb.setupGlyf(glyphs)
    fb.setupHorizontalMetrics(advances)
    fb.setupHorizontalHeader(ascent=900, descent=DESC)
    fb.setupOS2(sTypoAscender=900, sTypoDescender=DESC, usWinAscent=1000,
                usWinDescent=-DESC)
    fb.setupNameTable({"familyName": FONT_NAME, "styleName": "Regular",
                       "fullName": FONT_NAME,
                       "psName": f"{FONT_NAME}-Regular"})
    fb.setupPost()
    fb.save(str(out))
    return out


def ensure_font(out_path: str | Path | None = None) -> Path:
    """Build the font if it doesn't exist yet; return its path."""
    out = Path(out_path) if out_path else _DEFAULT_DIR / f"{FONT_NAME}.ttf"
    if not out.is_file():
        build_font(out)
    return out
