#!/usr/bin/env python3
"""Carry the trained weights and a set of real forms over to the PyTorch
port, for the card (which reads neither orbax nor PIL, and has no JAX).

    JAX_PLATFORMS=cpu python export_torch_weights.py

Writes, in ocr_system_tpu_torch/:

- weights/det.npz, weights/rec_latin.npz: checkpoints/det and
  checkpoints/rec_latin, loaded by the JAX package's own loader
  (core/checkpoint.init_or_load, through its engine) on the CPU, converted
  by the port's core/weights.dbnet_state_dict / svtr_state_dict, written
  by core/weights.save_npz (float32);
- assets/smoke_forms.npz: SMOKE_FORMS synthetic forms at 960 x 960
  (training/synth_forms.FormGenerator, seed SMOKE_SEED, Latin only), each
  with checkboxes drawn in blank places (utils/smoke.draw_checkboxes), as
  one compressed (N, 960, 960, 3) uint8 RGB array;
- assets/smoke_forms_expected.json: the JAX package's hybrid engine on
  those forms on the CPU (SMOKE_SETTINGS: the serving defaults with Latin
  recognition), at float32 and at bfloat16: per page its word, line,
  table, selection-mark and handwriting boxes and its markdown
  (utils/smoke.page_record);
- assets/glued_lines.npz, assets/glued_lines_expected.json: a page of
  printed lines whose value and the next column's label decode as one
  glued box, each line's quad and glued decode, and what the JAX
  package's glue split (JaxOCREngine._split_glued, Latin rec weights)
  makes of them at float32 and at bfloat16: the boxes and decodes after
  the pass.

chip_smoke.py loads all of them and holds the port against the JAX
package on the card. This tool imports JAX, so it stays outside the
package, and the package never imports it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PORT = REPO / "ocr_system_tpu_torch"
WEIGHTS = PORT / "weights"
ASSETS = PORT / "assets"
SMOKE_SEED = 6
SMOKE_FORMS = 8
SMOKE_SIDE = 960
CHECKBOXES_PER_FORM = 4
# what the expectations were computed with (at each compute dtype);
# chip_smoke.py builds the port's engines from the same values
SMOKE_SETTINGS = {"ocr_engine": "hybrid", "rec_charset": "latin"}
DTYPES = ("float32", "bfloat16")
# the det score and rec confidence the glued lines' boxes carry into the
# glue split
GLUED_SCORE, GLUED_CONF = 0.8, 0.9


def smoke_forms() -> np.ndarray:
    from ocr_system_tpu.training import synth_forms
    from ocr_system_tpu_torch.utils.smoke import draw_checkboxes

    gen = synth_forms.FormGenerator(seed=SMOKE_SEED, deva_fraction=0.0)
    rng = np.random.default_rng(SMOKE_SEED)
    pages = []
    for _ in range(SMOKE_FORMS):
        img = synth_forms.render_spec(gen.generate(SMOKE_SIDE)).image
        page = (np.asarray(img) * 255).round().astype(np.uint8)
        pages.append(draw_checkboxes(page, rng, CHECKBOXES_PER_FORM))
    return np.stack(pages)


def glued_lines_page() -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Printed lines whose value and the next column's label would decode
    as one glued box: the (140, 460, 3) uint8 page, each line's quad and a
    glued decode."""
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype("DejaVuSans.ttf", 18)
    img = Image.new("RGB", (460, 140), "white")
    d = ImageDraw.Draw(img)
    rows = [("mary novak", "Blood Type:"), ("john smith", "Physician:"),
            ("A12 99-3", "Insurance ID:")]
    quads, texts = [], []
    for r, (value, label) in enumerate(rows):
        y = 10 + 42 * r
        d.text((10, y), value, fill="black", font=font)
        d.text((230, y), label, fill="black", font=font)
        quads.append(np.array([[6, y - 3], [370, y - 3], [370, y + 25], [6, y + 25]],
                              np.float32))
        texts.append(value.replace(" ", "") + label)
    return np.asarray(img).copy(), np.stack(quads), texts


def export_glued() -> list[Path]:
    """The glued-lines page and the JAX package's glue split of it."""
    import jax

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.engine.detector import DetResult
    from ocr_system_tpu.engine.pipeline import JaxOCREngine
    from ocr_system_tpu.engine.recognizer import RecResult
    from ocr_system_tpu.ops.boxes import DetectedBox
    from ocr_system_tpu_torch.engine.host_image import rgb_to_gray

    page, quads, texts = glued_lines_page()
    expected = {"jax": jax.__version__, "score": GLUED_SCORE, "confidence": GLUED_CONF}
    for dt in DTYPES:
        engine = JaxOCREngine(JaxSettings(rec_charset="latin", compute_dtype=dt,
                                          rec_checkpoint=str(REPO / "checkpoints/rec_latin")))
        det = [DetResult(boxes=[DetectedBox(q.copy(), GLUED_SCORE) for q in quads],
                         skew_angle=0.0, page=page, gray=rgb_to_gray(page))]
        recs = [[RecResult(t, GLUED_CONF) for t in texts]]
        engine._split_glued([None], det, recs, [engine.recognizer])
        expected[dt] = {"quads": [b.quad.tolist() for b in det[0].boxes],
                        "texts": [r.text for r in recs[0]]}
    ASSETS.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(ASSETS / "glued_lines.npz", page=page, quads=quads,
                        texts=np.array(texts))
    (ASSETS / "glued_lines_expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    return [ASSETS / "glued_lines.npz", ASSETS / "glued_lines_expected.json"]


def main() -> int:
    import jax

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.core.mesh import build_mesh, mesh_context
    from ocr_system_tpu.engine.pipeline import _build_engine
    from ocr_system_tpu.engine.preprocess import PageImage
    from ocr_system_tpu_torch.core import weights
    from ocr_system_tpu_torch.utils.smoke import page_record

    ckpt = dict(det_checkpoint=str(REPO / "checkpoints/det"),
                rec_checkpoint=str(REPO / "checkpoints/rec_latin"))
    engines = {dt: _build_engine("hybrid", JaxSettings(**SMOKE_SETTINGS, **ckpt, compute_dtype=dt))
               for dt in DTYPES}
    tree = lambda v: jax.tree.map(np.asarray, v)  # noqa: E731
    f32 = engines["float32"]
    det = weights.save_npz(WEIGHTS / "det.npz",
                           weights.dbnet_state_dict(tree(f32.detector.neural.variables)))
    rec = weights.save_npz(WEIGHTS / "rec_latin.npz",
                           weights.svtr_state_dict(tree(f32.recognizer.variables)))

    forms = smoke_forms()
    ASSETS.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(ASSETS / "smoke_forms.npz", pages=forms)
    expected = {"settings": SMOKE_SETTINGS, "seed": SMOKE_SEED, "side": SMOKE_SIDE,
                "jax": jax.__version__, "pages": {}}
    for dt, engine in engines.items():
        # one device: the checkpoints restore onto one, so no dp mesh
        with mesh_context(build_mesh("dp=1")):
            outs = engine.process_pages([PageImage(p, i + 1) for i, p in enumerate(forms)])
        if not all(o.success for o in outs):
            raise SystemExit(f"the JAX engine failed a smoke form: {[o.error for o in outs]}")
        expected["pages"][dt] = [page_record(o) for o in outs]
    (ASSETS / "smoke_forms_expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    glued = export_glued()
    for path in (det, rec, ASSETS / "smoke_forms.npz", ASSETS / "smoke_forms_expected.json",
                 *glued):
        print(f"{path.relative_to(REPO)}: {path.stat().st_size / 1e6:.2f} MB")
    for dt in DTYPES:
        for r in expected["pages"][dt]:
            print(f"{dt} page {r['page_number']}: {len(r['word'])} words, "
                  f"{len(r['selection_mark'])} marks, {len(r['handwriting'])} handwriting")
    return 0


if __name__ == "__main__":
    sys.exit(main())
