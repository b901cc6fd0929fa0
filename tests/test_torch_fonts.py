"""The fonts the port's renderers read, which ship with the package
(``ocr_system_tpu_torch/assets/fonts/``): the same list, in the same
order and of the same bytes, as the JAX package's once its generated
Devanagari font exists; the package's copies taken where the system has
none; the cmap reader against fontTools; the committed Devanagari font
against a fresh build (every table but the head's time stamps); and the
DejaVu license beside the copies."""

import hashlib
from pathlib import Path

import pytest
import torch
from fontTools.ttLib import TTFont

from ocr_system_tpu.training import synth as JS
from ocr_system_tpu.training.devanagari_font import ensure_font
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.training import devanagari_font as DF
from ocr_system_tpu_torch.training import synth as S

torch.set_num_threads(1)

STAMPS = ("created", "modified", "checkSumAdjustment")


def _sha(path: Path) -> str:
    return hashlib.sha256(Path(path).read_bytes()).hexdigest()


def _tables(path: Path) -> dict[str, bytes]:
    """Every table's compiled bytes, the head's with its time stamps and
    checksum zeroed."""
    font = TTFont(str(path))
    out = {}
    for tag in sorted(font.keys()):
        if tag == "GlyphOrder":
            continue
        if tag == "head":
            for k in STAMPS:
                setattr(font["head"], k, 0)
        out[tag] = font.getTableData(tag) if tag != "head" else font["head"].compile(font)
    return out


def test_font_list_equals_jax():
    """The five DejaVu files, then the Devanagari font, as the JAX package
    lists them once its font exists: the same names in the same order, the
    DejaVu bytes equal, the Devanagari tables equal (time stamps aside)."""
    jax_font = ensure_font()
    want, got = JS.discover_fonts(), S.discover_fonts()
    assert [p.name for p in got] == [p.name for p in want]
    assert [p.name for p in got] == [*S.FONTS, "OCRSynthDevanagari.ttf"]
    for a, b in zip(got[:5], want[:5]):
        assert _sha(a) == _sha(b), a.name
    assert got[5] == S.DEVANAGARI_FONT and want[5] == jax_font
    assert _tables(got[5]) == _tables(want[5])


def test_package_fonts_serve_without_system_fonts(tmp_path, monkeypatch):
    """Without the system's DejaVu directory every file comes from the
    package, with the same bytes; a Latin and a Devanagari renderer draw
    the same lines from them."""
    lines = {cs: S.TextRenderer(get_charset(cs), seed=4).render_line(max_width=320)
             for cs in ("latin", "devanagari")}
    monkeypatch.setattr(S, "_FONT_DIR", tmp_path / "none")
    fonts = S.discover_fonts()
    assert all(p.parent == S.PACKAGE_FONTS for p in fonts)
    for name in S.FONTS:
        system = Path("/usr/share/fonts/truetype/dejavu") / name
        if system.is_file():
            assert _sha(S.PACKAGE_FONTS / name) == _sha(system), name
    for cs, want in lines.items():
        got = S.TextRenderer(get_charset(cs), seed=4).render_line(max_width=320)
        assert got.text == want.text and (got.image == want.image).all(), cs


def test_synth_font_dir_is_listed_last(tmp_path):
    extra = tmp_path / "extra"
    extra.mkdir()
    (extra / "b.ttf").write_bytes(S.DEVANAGARI_FONT.read_bytes())
    (extra / "a.ttf").write_bytes(S.DEVANAGARI_FONT.read_bytes())
    fonts = S.discover_fonts(str(extra))
    assert [p.name for p in fonts[-2:]] == ["a.ttf", "b.ttf"] and len(fonts) == 8


@pytest.mark.parametrize("index", range(6))
def test_cmap_reader_matches_fonttools(index):
    path = S.discover_fonts()[index]
    want = frozenset(TTFont(str(path), lazy=True).getBestCmap())
    assert S.cmap_codepoints(path.read_bytes()) == want
    assert S.font_codepoints(path) == want


def test_committed_devanagari_font_equals_a_fresh_build(tmp_path):
    fresh = DF.build_font(tmp_path / "fresh.ttf")
    assert _tables(S.DEVANAGARI_FONT) == _tables(fresh)
    assert S.DEVANAGARI_FONT.stat().st_size == fresh.stat().st_size


def test_fonts_covering_uses_the_committed_devanagari_font():
    deva = S.fonts_covering(get_charset("devanagari"), S.discover_fonts()[:5])
    assert deva == [S.DEVANAGARI_FONT]
    latin = S.fonts_covering(get_charset("latin"), S.discover_fonts())
    assert S.DEVANAGARI_FONT not in latin and len(latin) == 5


def test_the_license_ships_beside_the_fonts():
    text = (S.PACKAGE_FONTS / "copyright").read_text()
    assert "DejaVu" in text and "Bitstream Vera" in text
    assert sorted(p.name for p in S.PACKAGE_FONTS.glob("*.ttf")) == sorted(
        [*S.FONTS, "OCRSynthDevanagari.ttf"])
