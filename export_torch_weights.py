#!/usr/bin/env python3
"""Carry the trained weights and a set of real forms over to the PyTorch
port, for the card (which reads neither orbax nor PIL, and has no JAX).

    JAX_PLATFORMS=cpu python export_torch_weights.py

Writes, in ocr_system_tpu_torch/:

- weights/det.npz, weights/rec_latin.npz, weights/rec_devanagari.npz:
  checkpoints/det, checkpoints/rec_latin and checkpoints/rec_devanagari,
  loaded by the JAX package's own loader (core/checkpoint.init_or_load,
  through its engine) on the CPU, converted by the port's
  core/weights.dbnet_state_dict / svtr_state_dict, written by
  core/weights.save_npz (float32);
- assets/smoke_forms.npz: SMOKE_FORMS synthetic forms at 960 x 960
  (training/synth_forms.FormGenerator, seed SMOKE_SEED, Latin only), each
  with checkboxes drawn in blank places (utils/smoke.draw_checkboxes), as
  one compressed (N, 960, 960, 3) uint8 RGB array;
- assets/hindi_forms.npz: HINDI_FORMS Hindi forms drawn the same way
  (seed HINDI_SEED, deva_fraction 1; the Devanagari font comes from
  training/devanagari_font.ensure_font);
- assets/smoke_forms_expected.json: the JAX package's hybrid engine on the
  CPU at the serving defaults (SMOKE_SETTINGS: script routing included)
  with the three checkpoints, at float32 and at bfloat16, on the Latin
  forms (one wave) and on the mixed wave of the Hindi forms followed by
  Latin forms 1 to MIXED_LATIN: per page its word, line, table,
  selection-mark and handwriting boxes, each word's recognizer, the crops
  each rescue re-decoded and replaced, and its markdown
  (utils/smoke.page_record);
- assets/glued_lines.npz, assets/glued_lines_expected.json: a page of
  printed lines whose value and the next column's label decode as one
  glued box, each line's quad and glued decode, and what the JAX
  package's glue split (JaxOCREngine._split_glued, Latin rec weights)
  makes of them at float32 and at bfloat16: the boxes and decodes after
  the pass.
- weights/extract.npz: checkpoints/extract (the layout extractor) through
  core/weights.layout_state_dict, every tensor but LayerNorm's rounded to
  bf16 (core/weights.bf16_but_norms): what the serving dtype computes
  with, at half the bytes, zip-deflated (42.6 MB);
- assets/extract_expected.json: the JAX package's LayoutModelExtractor
  on the committed pages' float32 OCR words (utils/smoke.extract_documents:
  each page as a one-page document, and the Latin wave as one 8-page
  document), at float32 on the bf16-rounded parameters and at bfloat16,
  and how the float32 checkpoint's fields differ from the rounded ones
  (a report); and the JAX orchestrator's extract, save and validate
  stages (on a temporary sqlite database) on the JAX hybrid engine's own
  OCR of the Latin wave at each compute dtype: fields, field rows and
  validation report.

chip_smoke.py loads all of them and holds the port against the JAX
package on the card. This tool imports JAX, so it stays outside the
package, and the package never imports it.
"""

from __future__ import annotations

import contextlib
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
HINDI_SEED = 7
HINDI_FORMS = 4
MIXED_LATIN = 4  # Latin forms in the mixed wave, after the Hindi ones
# what the expectations were computed with (at each compute dtype):
# the serving defaults; chip_smoke.py builds the port's engines from them
SMOKE_SETTINGS = {"ocr_engine": "hybrid"}
DTYPES = ("float32", "bfloat16")
# the det score and rec confidence the glued lines' boxes carry into the
# glue split
GLUED_SCORE, GLUED_CONF = 0.8, 0.9


def draw_forms(seed: int, n: int, deva_fraction: float, side: int = SMOKE_SIDE,
               checkboxes: int = CHECKBOXES_PER_FORM) -> np.ndarray:
    """n synthetic forms, (n, side, side, 3) uint8, each with checkboxes
    drawn in blank places."""
    from ocr_system_tpu.training import synth_forms
    from ocr_system_tpu_torch.utils.smoke import draw_checkboxes

    gen = synth_forms.FormGenerator(seed=seed, deva_fraction=deva_fraction)
    rng = np.random.default_rng(seed)
    pages = []
    for _ in range(n):
        img = synth_forms.render_spec(gen.generate(side)).image
        page = (np.asarray(img) * 255).round().astype(np.uint8)
        pages.append(draw_checkboxes(page, rng, checkboxes))
    return np.stack(pages)


def smoke_forms() -> np.ndarray:
    return draw_forms(SMOKE_SEED, SMOKE_FORMS, 0.0)


def hindi_forms() -> np.ndarray:
    return draw_forms(HINDI_SEED, HINDI_FORMS, 1.0)


@contextlib.contextmanager
def jax_wave_probe(engine):
    """While open, a JaxOCREngine records what the port's engine records of
    a wave: its det stage's DetResults (``"dets"``), every recognition
    dispatch as (charset name, the quads per page) (``"calls"``), and per
    page the crops each rescue re-decoded and replaced (``"rescued"``;
    replaced: the results the rescue swapped)."""
    cls = type(engine)
    wave: dict = {"dets": None, "calls": [], "rescued": None}

    def det_stage(pages):
        wave["dets"] = cls.det_stage(engine, pages)
        return wave["dets"]

    def recognize_with(rec, pages, dets, quads_list):
        wave["calls"].append((rec.charset.name, [np.array(q) for q in quads_list]))
        return cls._recognize_with(engine, rec, pages, dets, quads_list)

    def counted(name: str, key: str):
        def rescue(pages, dets, quads_list, *rest):
            out = rest[-1]
            before = [list(row) for row in out]
            first = len(wave["calls"])
            getattr(cls, name)(engine, pages, dets, quads_list, *rest)
            if wave["rescued"] is None:
                wave["rescued"] = [{"confidence": [0, 0], "digit_glyph": [0, 0]} for _ in out]
            for i, row in enumerate(wave["rescued"]):
                row[key] = [sum(len(q[i]) for _, q in wave["calls"][first:]),
                            sum(a is not b for a, b in zip(before[i], out[i]))]
        return rescue

    engine.det_stage = det_stage
    engine._recognize_with = recognize_with
    engine._confidence_rescue = counted("_confidence_rescue", "confidence")
    engine._digit_glyph_rescue = counted("_digit_glyph_rescue", "digit_glyph")
    try:
        yield wave
    finally:
        for name in ("det_stage", "_recognize_with", "_confidence_rescue",
                     "_digit_glyph_rescue"):
            delattr(engine, name)


def run_jax_wave(engine, pages) -> tuple[list, list[dict], list[dict]]:
    """``engine.process_pages(pages)`` of a JaxOCREngine, with per page each
    det box's recognizer by its polygon (the port's ``box_recognizers`` on
    the JAX DetResults) and the crops each rescue re-decoded and
    replaced."""
    from ocr_system_tpu_torch.engine.pipeline import box_recognizers

    with jax_wave_probe(engine) as wave:
        outs = engine.process_pages(pages)
    rescued = wave["rescued"] or [
        {"confidence": [0, 0], "digit_glyph": [0, 0]} for _ in pages]
    return outs, [box_recognizers(d) for d in wave["dets"]], rescued


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
        engine = JaxOCREngine(JaxSettings(compute_dtype=dt,
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


def rounded_bf16(variables):
    """A flax tree with every parameter but LayerNorm's rounded to bf16 (and
    kept float32): the values that a module at ``dtype=bfloat16`` computes
    with, so float32 compute on these is what the port's float32 computes
    on weights/extract.npz."""
    import jax
    import jax.numpy as jnp

    def rnd(path, x):
        if any(str(getattr(k, "key", "")).startswith("LayerNorm") for k in path):
            return x
        return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)

    return jax.tree_util.tree_map_with_path(rnd, variables)


def jax_fields_for(settings, engine, extractor, doc, workdir: Path,
                   template: dict | None = None, custom_prompt: str | None = None) -> dict:
    """The JAX orchestrator's extract, save and validate stages on one
    DocumentOCRResult, on a fresh sqlite database in ``workdir``: the
    extraction result, the field rows as saved, and the validation report
    (utils/smoke records)."""
    from ocr_system_tpu.db.connection import Database
    from ocr_system_tpu.service.orchestrator import ExtractionOrchestrator, WorkflowState
    from ocr_system_tpu_torch.utils import smoke

    workdir.mkdir(parents=True, exist_ok=True)
    db = Database(workdir / "o.db")
    try:
        orch = ExtractionOrchestrator(
            settings=settings.model_copy(update={"storage_root": str(workdir / "storage")}),
            db=db, engine=engine, extractor=extractor)
        doc_row = orch.repos.documents.create(
            filename="doc.png", original_filename="doc.png", file_path=str(workdir / "doc.png"),
            file_size=0, file_type="png")
        ext = orch.repos.extractions.create_new_version(doc_row["id"], status="processing")
        state = WorkflowState(document_id=doc_row["id"], file_path=doc_row["file_path"],
                              filename="doc.png", extraction_id=ext["id"], ocr_result=doc,
                              template=template, custom_prompt=custom_prompt)
        reports = []
        validate = orch.validation.validate_fields
        orch.validation.validate_fields = lambda f: reports.append(validate(f)) or reports[-1]
        orch._stage_extract(state)
        orch._stage_save(state)
        orch._stage_validate(state)
        rows = orch.repos.fields.list_for_extraction(ext["id"])
    finally:
        db.close()
    return {"result": smoke.result_record(state.extract_result),
            "rows": smoke.rows_record(rows), "report": smoke.report_record(reports[0])}


def export_extract() -> list[Path]:
    """weights/extract.npz and assets/extract_expected.json (module doc)."""
    import tempfile

    import jax

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.core.mesh import build_mesh, mesh_context
    from ocr_system_tpu.engine.pipeline import DocumentOCRResult, _build_engine, combine_markdown
    from ocr_system_tpu.engine.preprocess import PageImage
    from ocr_system_tpu.extract.layout_model import LayoutModelExtractor
    from ocr_system_tpu_torch.core import weights
    from ocr_system_tpu_torch.utils import smoke

    tree = lambda v: jax.tree.map(np.asarray, v)  # noqa: E731
    ckpt = str(REPO / "checkpoints/extract")
    settings = {dt: JaxSettings(extract_checkpoint=ckpt, compute_dtype=dt,
                                det_checkpoint=str(REPO / "checkpoints/det"),
                                rec_checkpoint=str(REPO / "checkpoints/rec_latin"),
                                rec_checkpoint_devanagari=str(REPO / "checkpoints/rec_devanagari"),
                                **SMOKE_SETTINGS)
                for dt in DTYPES}
    full = LayoutModelExtractor(settings["float32"]).variables
    rounded = rounded_bf16(full)
    path = weights.save_npz(WEIGHTS / "extract.npz",
                            weights.bf16_but_norms(weights.layout_state_dict(tree(rounded))))
    extractors = {dt: LayoutModelExtractor(settings[dt], params=rounded) for dt in DTYPES}

    forms, expected = smoke.smoke_forms()
    docs = smoke.extract_documents(expected)
    record: dict = {"jax": jax.__version__, "checkpoint": "checkpoints/extract",
                    "input": "smoke_forms_expected.json float32 words (utils/smoke.extract_documents)",
                    "docs": {}, "e2e": {}}
    for dt, ex in extractors.items():
        record["docs"][dt] = {name: smoke.result_record(ex.extract_from_layout(*doc))
                              for name, doc in docs.items()}
    unrounded = LayoutModelExtractor(settings["float32"], params=full)
    record["float32_checkpoint_vs_rounded"] = {
        name: smoke.compare_fields(record["docs"]["float32"][name],
                                   smoke.result_record(unrounded.extract_from_layout(*doc)))
        for name, doc in docs.items()}
    pages = [PageImage(p, i + 1) for i, p in enumerate(forms)]
    with tempfile.TemporaryDirectory() as tmp:
        for dt in DTYPES:
            engine = _build_engine("hybrid", settings[dt])
            with mesh_context(build_mesh("dp=1")):
                outs = engine.process_pages(pages)
            doc = DocumentOCRResult(
                success=True, pages=outs, total_pages=len(outs),
                combined_markdown=combine_markdown([o.markdown for o in outs]),
                combined_html="\n<hr>\n".join(o.html for o in outs))
            record["e2e"][dt] = jax_fields_for(settings[dt], engine, extractors[dt], doc,
                                               Path(tmp) / dt)
    out = ASSETS / "extract_expected.json"
    out.write_text(json.dumps(record, indent=1, ensure_ascii=False) + "\n")
    return [path, out]


def main() -> int:
    import jax

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.core.mesh import build_mesh, mesh_context
    from ocr_system_tpu.engine.pipeline import _build_engine
    from ocr_system_tpu.engine.preprocess import PageImage
    from ocr_system_tpu_torch.core import weights
    from ocr_system_tpu_torch.utils.smoke import page_record

    ckpt = dict(det_checkpoint=str(REPO / "checkpoints/det"),
                rec_checkpoint=str(REPO / "checkpoints/rec_latin"),
                rec_checkpoint_devanagari=str(REPO / "checkpoints/rec_devanagari"))
    engines = {dt: _build_engine("hybrid", JaxSettings(**SMOKE_SETTINGS, **ckpt, compute_dtype=dt))
               for dt in DTYPES}
    tree = lambda v: jax.tree.map(np.asarray, v)  # noqa: E731
    f32 = engines["float32"]
    deva = f32._devanagari_recognizer()
    if deva is None or deva.charset.name != "devanagari":
        raise SystemExit("the JAX engine built no Devanagari recognizer")
    written = [
        weights.save_npz(WEIGHTS / "det.npz",
                         weights.dbnet_state_dict(tree(f32.detector.neural.variables))),
        weights.save_npz(WEIGHTS / "rec_latin.npz",
                         weights.svtr_state_dict(tree(f32.recognizer.variables))),
        weights.save_npz(WEIGHTS / "rec_devanagari.npz",
                         weights.svtr_state_dict(tree(deva.variables))),
    ]

    forms, hindi = smoke_forms(), hindi_forms()
    ASSETS.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(ASSETS / "smoke_forms.npz", pages=forms)
    np.savez_compressed(ASSETS / "hindi_forms.npz", pages=hindi)
    waves = {"pages": list(forms), "mixed": list(hindi) + list(forms[:MIXED_LATIN])}
    expected = {"settings": SMOKE_SETTINGS, "seed": SMOKE_SEED, "side": SMOKE_SIDE,
                "hindi_seed": HINDI_SEED, "mixed_latin": MIXED_LATIN,
                "jax": jax.__version__, **{k: {} for k in waves}}
    for dt, engine in engines.items():
        for key, arrays in waves.items():
            # one device: the checkpoints restore onto one, so no dp mesh
            with mesh_context(build_mesh("dp=1")):
                outs, routed, rescued = run_jax_wave(
                    engine, [PageImage(p, i + 1) for i, p in enumerate(arrays)])
            if not all(o.success for o in outs):
                raise SystemExit(f"the JAX engine failed a form: {[o.error for o in outs]}")
            expected[key][dt] = [page_record(o, r, c) for o, r, c in zip(outs, routed, rescued)]
    (ASSETS / "smoke_forms_expected.json").write_text(json.dumps(expected, indent=1) + "\n")
    glued = export_glued()
    extract = export_extract()
    for path in (*written, ASSETS / "smoke_forms.npz", ASSETS / "hindi_forms.npz",
                 ASSETS / "smoke_forms_expected.json", *glued, *extract):
        print(f"{path.relative_to(REPO)}: {path.stat().st_size / 1e6:.2f} MB")
    for key in waves:
        for dt in DTYPES:
            for r in expected[key][dt]:
                scripts = [w["recognizer"] for w in r["word"]]
                print(f"{key} {dt} page {r['page_number']}: {len(r['word'])} words "
                      f"({scripts.count('devanagari')} devanagari), "
                      f"{len(r['selection_mark'])} marks, {len(r['handwriting'])} handwriting, "
                      f"rescued {r['rescued']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
