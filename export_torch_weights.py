#!/usr/bin/env python3
"""Carry the trained weights and a set of real forms over to the PyTorch
port, for the card (which reads neither orbax nor PIL, and has no JAX).

    JAX_PLATFORMS=cpu python export_torch_weights.py [--only service|train|eval|text_pdf|skew]

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
  (utils/smoke.page_record); and under "skew", the served detector's
  skew angles on every committed form and on the turned copies of
  utils/smoke.SKEW_TURNS (utils/smoke.skew_pages; each page's digest, its
  forward's float32 estimate, the angle its DetResult applied, and the
  search's top two candidates with their scores). ``--only skew`` writes
  just that entry (~1 min);
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

- assets/service_upload.pdf: the Latin forms' gray as a scanned PDF, one
  FlateDecode DeviceGray image per page (utils/smoke.scanned_pdf), which
  a renderer at utils/smoke.SERVICE_DPI pastes 1:1;
- assets/service_expected.json: the JAX application
  (ocr_system_tpu.api.app.create_app with the hybrid JaxOCREngine on the
  three checkpoints and the LayoutModelExtractor on the bf16-rounded
  parameters, on a temporary storage root and database) on that upload,
  at float32 and at bfloat16: the current extraction's markdown, form
  type, page dimensions, layout box count, fields with their boxes and
  validation, and its JSON and CSV exports, masked
  (utils/smoke.service_record). ``--only service`` writes just these two.

- weights/det_thresh.npz: the training threshold head of checkpoints/det
  (core/weights.dbnet_state_dict(..., thresh_head=True)), which det.npz,
  the serving model, leaves out;
- assets/train_batches.npz: one batch of each trainer, drawn by the JAX
  package's own iterators (training/train.py) at fixed seeds at the
  train_models CLI's defaults: rec 64 lines at width 320 (Latin), det 8
  pages at 640 in the wire format, layout 32 sequences at max_len 768
  (multilingual); compressed, each array under ``<trainer>/<key>``;
- assets/train_expected.json: the JAX package's record of 3 train steps
  on those batches at float32 and at bfloat16 compute, each trainer from
  the trained weights (rec: checkpoints/rec_latin; det: checkpoints/det
  with its threshold head, without augmentation; layout: the bf16-rounded
  checkpoints/extract the port serves): per step the loss (and the layout
  tag accuracy), the global gradient norm before the clip, and after step
  3 the norm of each top-level parameter group and, for rec and det, the
  running statistics of the first and last BatchNorm (jax_train_record).
  ``--only train`` writes just these three.

- assets/eval_expected.json: the JAX package's quality evaluation
  (ocr_system_tpu/training/evaluate.py) at float32 and at bfloat16 on the
  checkpoints (the extractor's bf16-rounded, as above), run through
  utils/smoke.run_eval for every phase of utils/smoke.EVAL_PHASES at
  utils/smoke.EVAL_SIZES (the engines as training/sweep_quality.py builds
  them): each run's result, every item's output (a line's text, a page's
  markdown and handwriting boxes, a document's form type and fields) and a
  digest of every rendered line and page; and the JAX hybrid engine's words
  and boxes at float32 at each detector setting of
  utils/smoke.DET_SETTINGS on the first DET_SETTINGS_FORMS Latin forms;
  and every line and page the JAX renderers drew for those evaluations,
  with the texts, quads and element boxes measured from them
  (utils/smoke.RenderLog), which chip_smoke.py replays on the card:
  the events in eval_expected.json, the images and quads in
  assets/eval_renders.npz. ``--only eval`` writes just these two
  (~10 min).

- assets/text_pdf_render.npz: the gray plane of the JAX package's
  render_pdf of utils/smoke.text_pdf() at TEXT_PDF_DPI, on this host's
  DejaVu and PIL (with raqm); chip_smoke.py reports the card's share of
  equal pixels. ``--only text_pdf`` writes just this (~1 s).

chip_smoke.py loads all of them and holds the port against the JAX
package on the card. This tool imports JAX, so it stays outside the
package, and the package never imports it.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
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


def jax_service_record(settings, engine, extractor, data: bytes, filename: str,
                       workdir: Path) -> dict:
    """The JAX application (``create_app`` on an ``ApiContext`` with this
    engine and extractor, on a fresh storage root and database in
    ``workdir``) on one upload: utils/smoke.app_upload's record. The engine
    runs in the scheduler's worker threads, each of which builds its mesh
    from MESH_SHAPE: one device, as the checkpoints restore."""
    from ocr_system_tpu.api.app import ApiContext, create_app
    from ocr_system_tpu.api.http import Request
    from ocr_system_tpu.db.connection import Database
    from ocr_system_tpu.service.orchestrator import ExtractionOrchestrator
    from ocr_system_tpu_torch.utils import smoke

    workdir.mkdir(parents=True, exist_ok=True)
    s = settings.model_copy(update={"storage_root": str(workdir / "storage"),
                                    "database_path": str(workdir / "app.db"),
                                    "warmup_on_start": False})
    db = Database(s.database_path)
    previous = os.environ.get("MESH_SHAPE")
    os.environ["MESH_SHAPE"] = "dp=1"
    try:
        orch = ExtractionOrchestrator(settings=s, db=db, engine=engine, extractor=extractor)
        app = create_app(ApiContext(settings=s, db=db, orchestrator=orch))
        return smoke.app_upload(app, Request, data, filename)
    finally:
        if previous is None:
            os.environ.pop("MESH_SHAPE", None)
        else:
            os.environ["MESH_SHAPE"] = previous
        db.close()


def export_service() -> list[Path]:
    """assets/service_upload.pdf and assets/service_expected.json (module
    doc)."""
    import jax

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.engine.pipeline import _build_engine
    from ocr_system_tpu.extract.layout_model import LayoutModelExtractor
    from ocr_system_tpu_torch.utils import smoke

    forms, _ = smoke.smoke_forms()
    data = smoke.scanned_pdf([f[..., 0] for f in forms])
    smoke.SERVICE_UPLOAD.write_bytes(data)
    ckpt = dict(det_checkpoint=str(REPO / "checkpoints/det"),
                rec_checkpoint=str(REPO / "checkpoints/rec_latin"),
                rec_checkpoint_devanagari=str(REPO / "checkpoints/rec_devanagari"),
                extract_checkpoint=str(REPO / "checkpoints/extract"))
    record: dict = {"jax": jax.__version__, "upload": smoke.SERVICE_UPLOAD.name,
                    "pdf_raster_dpi": smoke.SERVICE_DPI, "settings": SMOKE_SETTINGS}
    rounded = None
    with tempfile.TemporaryDirectory() as tmp:
        for dt in DTYPES:
            s = JaxSettings(**SMOKE_SETTINGS, **ckpt, compute_dtype=dt,
                            pdf_raster_dpi=smoke.SERVICE_DPI)
            if rounded is None:
                rounded = rounded_bf16(LayoutModelExtractor(s).variables)
            record[dt] = jax_service_record(
                s, _build_engine("hybrid", s), LayoutModelExtractor(s, params=rounded), data,
                smoke.SERVICE_UPLOAD.name, Path(tmp) / dt)
    smoke.SERVICE_EXPECTED.write_text(json.dumps(record, indent=1, ensure_ascii=False) + "\n")
    return [smoke.SERVICE_UPLOAD, smoke.SERVICE_EXPECTED]


# the train record: seeds of the committed batches, steps, the first and
# last BatchNorm whose running statistics are recorded
TRAIN_SEEDS = {"rec": 11, "det": 12, "layout": 13}
TRAIN_STEPS = 3
TRAIN_LR = {"rec": 1e-3, "det": 1e-3, "layout": 3e-4}
TRAIN_BN = {"rec": ("stem.0.bn", "stem.2.bn"), "det": ("backbone.stem.bn", "thresh_head.bn")}


def train_batches() -> dict[str, dict[str, np.ndarray]]:
    """One batch of each trainer from the JAX package's iterators at the CLI
    defaults (the det iterator's pool races two workers, so its batch is
    whatever this run drew)."""
    from ocr_system_tpu.models.charsets import get_charset
    from ocr_system_tpu.training import train as T

    rec = next(T.rec_batch_iterator(get_charset("latin"), 64, width=320,
                                    seed=TRAIN_SEEDS["rec"]))
    det_it = T.det_batch_iterator(8, size=640, seed=TRAIN_SEEDS["det"])
    det = next(det_it)
    det_it.close()
    layout = next(T.layout_batch_iterator(get_charset("multilingual"), 32, max_len=768,
                                          seed=TRAIN_SEEDS["layout"], pos_span=2048))
    return {"rec": rec, "det": det, "layout": layout}


def save_train_batches(batches: dict) -> Path:
    from ocr_system_tpu_torch.utils.smoke import TRAIN_BATCHES

    np.savez_compressed(TRAIN_BATCHES, **{f"{name}/{k}": v for name, batch in batches.items()
                                          for k, v in batch.items()})
    return TRAIN_BATCHES


def _record_grad_norm():
    """An optax transformation that passes the gradients on and keeps their
    global norm in its state: the norm before the clip, read after a step."""
    import jax.numpy as jnp
    import optax

    return optax.GradientTransformation(
        lambda params: jnp.zeros((), jnp.float32),
        lambda updates, state, params=None: (updates, optax.global_norm(updates)))


def _jax_det_step(model, optimizer):
    """The JAX det step without its augmentation (which draws from the JAX
    PRNG, which the port cannot match): the wire decode as
    make_det_train_step writes it, normalize_for_model, DBNet.apply and
    db_loss, and the same update."""
    import jax
    import jax.numpy as jnp
    import optax

    from ocr_system_tpu.models.dbnet import db_loss
    from ocr_system_tpu.ops.image_ops import normalize_for_model
    from ocr_system_tpu.training.train import TrainState

    def unpack(packed, width):  # np.packbits order
        bits = (packed[..., None] >> jnp.arange(7, -1, -1, dtype=jnp.uint8)) & 1
        return bits.reshape(*packed.shape[:-1], -1)[..., :width].astype(jnp.float32)

    def loss_fn(params, batch_stats, batch):
        packed = batch["images"]
        b, s = packed.shape[0], packed.shape[1]
        hi = (packed >> 4).astype(jnp.float32)
        lo = (packed & 15).astype(jnp.float32)
        f = jnp.stack([hi, lo], axis=-1).reshape(b, s, s) / 15.0
        out, mutated = model.apply({"params": params, "batch_stats": batch_stats},
                                   jax.vmap(normalize_for_model)(f), train=True,
                                   mutable=["batch_stats"])
        thresh = jax.image.resize(batch["thresh_map"].astype(jnp.float32) / 255.0,
                                  (b, s, s), method="bilinear")
        loss = db_loss(out, unpack(batch["shrink_bits"], s), unpack(batch["smask_bits"], s),
                       thresh, unpack(batch["tmask_bits"], s))
        return loss, mutated["batch_stats"]

    def step(state, batch):
        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats, batch)
        updates, new_opt = optimizer.update(grads, state.opt_state, state.params)
        return (TrainState(optax.apply_updates(state.params, updates), new_bs, new_opt,
                           state.step + 1), {"loss": loss})

    return jax.jit(step)


def jax_train_record(batches: dict, dtypes=DTYPES, trainers=("rec", "det", "layout"),
                     ulp_seed: int | None = None) -> dict:
    """TRAIN_STEPS steps of each JAX trainer on its committed batch from the
    trained weights, at each compute dtype (module doc). With ``ulp_seed``,
    every start value is first moved one float32 ulp up or down at random
    (train_spread_probe.py: the same weights rounded otherwise)."""
    import jax
    import jax.numpy as jnp
    import optax

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.core.dtypes import DTypePolicy
    from ocr_system_tpu.core.mesh import build_mesh
    from ocr_system_tpu.engine.detector import Detector as JaxDetector
    from ocr_system_tpu.engine.recognizer import Recognizer as JaxRecognizer
    from ocr_system_tpu.extract.layout_model import LayoutModelExtractor
    from ocr_system_tpu.models.charsets import get_charset
    from ocr_system_tpu.models.dbnet import DBNet
    from ocr_system_tpu.models.layout_extractor import LayoutExtractor
    from ocr_system_tpu.models.recognizer import SVTRRecognizer
    from ocr_system_tpu.training import train as T
    from ocr_system_tpu_torch.core import weights
    from ocr_system_tpu_torch.training.train import group_norms
    from ocr_system_tpu_torch.utils.smoke import digest

    tree = lambda v: jax.tree.map(np.asarray, v)  # noqa: E731
    mesh = build_mesh("dp=1")
    s = JaxSettings(det_checkpoint=str(REPO / "checkpoints/det"),
                    rec_checkpoint=str(REPO / "checkpoints/rec_latin"), rec_charset="latin",
                    extract_checkpoint=str(REPO / "checkpoints/extract"))
    start = {}
    if "rec" in trainers:
        start["rec"] = tree(JaxRecognizer(s).variables)
    if "det" in trainers:
        start["det"] = tree(JaxDetector(s).variables)
    if "layout" in trainers:
        start["layout"] = {"params": tree(rounded_bf16(LayoutModelExtractor(s).variables))["params"]}
    if ulp_seed is not None:
        rng = np.random.default_rng(ulp_seed)

        def nudge(a):
            a = np.asarray(a, np.float32)
            return np.where(rng.random(a.shape) < 0.5, np.nextafter(a, np.float32(np.inf)),
                            np.nextafter(a, np.float32(-np.inf))).astype(np.float32)

        start = {name: jax.tree.map(nudge, v) for name, v in start.items()}
    to_torch = {"rec": weights.svtr_state_dict,
                "det": lambda v: weights.dbnet_state_dict(v, thresh_head=True),
                "layout": weights.layout_state_dict}
    # what the record was computed from, for the staleness test and the
    # card's check that it starts from the same weights and batches
    inputs = {name: {"batch": digest(batches[name]), "start": digest(to_torch[name](start[name]))}
              for name in trainers}
    record: dict = {"jax": jax.__version__, "steps": TRAIN_STEPS, "lr": TRAIN_LR,
                    "seeds": TRAIN_SEEDS, "bn": TRAIN_BN, "inputs": inputs}
    for dt in dtypes:
        policy = DTypePolicy(compute_dtype=getattr(jnp, dt))
        record[dt] = {}
        for name in trainers:
            optimizer = optax.chain(_record_grad_norm(), T.make_optimizer(TRAIN_LR[name]))
            if name == "rec":
                model = SVTRRecognizer(vocab_size=get_charset("latin").size, policy=policy)
                step = T.make_rec_train_step(model, optimizer, mesh)
            elif name == "det":
                model = DBNet(policy=policy)
                step = _jax_det_step(model, optimizer)
            else:
                model = LayoutExtractor(vocab_size=get_charset("multilingual").size,
                                        dim=512, depth=8, policy=policy)
                step = T.make_layout_train_step(model, optimizer, mesh)
            params = jax.tree.map(jnp.asarray, start[name]["params"])
            stats = jax.tree.map(jnp.asarray, start[name].get("batch_stats", {}))
            state = T.TrainState(params, stats, optimizer.init(params), 0)
            batch = {k: jnp.asarray(v) for k, v in batches[name].items()}
            rows: dict = {"loss": [], "grad_norm": []}
            for _ in range(TRAIN_STEPS):
                state, metrics = step(state, batch)
                rows["loss"].append(float(metrics["loss"]))
                rows["grad_norm"].append(float(state.opt_state[0]))
                if "tag_acc" in metrics:
                    rows.setdefault("tag_acc", []).append(float(metrics["tag_acc"]))
            after = to_torch[name]({"params": tree(state.params),
                                    "batch_stats": tree(state.batch_stats)})
            rows["group_norms"] = group_norms(after)
            if name in TRAIN_BN:
                rows["bn"] = {m: {"running_mean": after[f"{m}.running_mean"].tolist(),
                                  "running_var": after[f"{m}.running_var"].tolist()}
                              for m in TRAIN_BN[name]}
            record[dt][name] = rows
            print(f"train record {dt} {name}: loss {rows['loss']}", flush=True)
    return record


def export_train() -> list[Path]:
    """weights/det_thresh.npz, assets/train_batches.npz and
    assets/train_expected.json (module doc)."""
    import jax

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.engine.detector import Detector as JaxDetector
    from ocr_system_tpu_torch.core import weights

    det = jax.tree.map(np.asarray, JaxDetector(JaxSettings(
        det_checkpoint=str(REPO / "checkpoints/det"))).variables)
    thresh = weights.save_npz(WEIGHTS / "det_thresh.npz", {
        k: v for k, v in weights.dbnet_state_dict(det, thresh_head=True).items()
        if k.startswith("thresh_head.")})
    from ocr_system_tpu_torch.utils.smoke import TRAIN_EXPECTED

    batches = train_batches()
    record = jax_train_record(batches)
    TRAIN_EXPECTED.write_text(json.dumps(record, indent=1) + "\n")
    return [thresh, save_train_batches(batches), TRAIN_EXPECTED]


def jax_eval_kit(dtype: str) -> dict:
    """The JAX package's side of utils/smoke.run_eval at ``dtype``: its
    evaluation module, charsets, recognizers, the hybrid and classical
    engines as its scripts/sweep_quality.py builds them, the layout
    extractor on the bf16-rounded checkpoint and the rule extractor."""
    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.engine.classical_detector import ClassicalDetector
    from ocr_system_tpu.engine.hybrid_detector import HybridDetector
    from ocr_system_tpu.engine.pipeline import JaxOCREngine
    from ocr_system_tpu.engine.recognizer import Recognizer
    from ocr_system_tpu.extract.layout_model import LayoutModelExtractor
    from ocr_system_tpu.extract.rules import RuleExtractor
    from ocr_system_tpu.models.charsets import get_charset
    from ocr_system_tpu.training import evaluate
    from ocr_system_tpu.training.synth_forms_heldout import HeldoutFormGenerator
    from ocr_system_tpu_torch.utils.smoke import EVAL_ENGINE

    ck = lambda name: str(REPO / "checkpoints" / name)  # noqa: E731
    charsets = {cs: get_charset(cs) for cs in ("latin", "devanagari")}
    rec = {cs: Recognizer(JaxSettings(rec_checkpoint=ck(f"rec_{cs}"), storage_root="storage",
                                      compute_dtype=dtype), charset=charsets[cs])
           for cs in charsets}
    st = JaxSettings(rec_checkpoint=ck("rec_latin"), rec_checkpoint_devanagari=ck("rec_devanagari"),
                     det_checkpoint=ck("det"), storage_root="storage", compute_dtype=dtype,
                     **EVAL_ENGINE)
    engines = {name: JaxOCREngine(st, detector=det(st),
                                  recognizer=Recognizer(st, charset=charsets["latin"]))
               for name, det in (("hybrid", HybridDetector), ("classical", ClassicalDetector))}
    ex_settings = JaxSettings(extract_checkpoint=ck("extract"), compute_dtype=dtype)
    extractor = LayoutModelExtractor(ex_settings)
    extractor.variables = rounded_bf16(extractor.variables)
    return {"E": evaluate, "heldout": HeldoutFormGenerator, "charsets": charsets, "rec": rec,
            "engines": engines, "extractor": extractor, "rules": RuleExtractor()}


def export_eval() -> list[Path]:
    """assets/eval_expected.json (module doc)."""
    import time

    import jax

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.core.mesh import build_mesh, mesh_context
    from ocr_system_tpu.engine.pipeline import _build_engine
    from ocr_system_tpu.engine.preprocess import PageImage
    from ocr_system_tpu.training import synth as JS
    from ocr_system_tpu.training import synth_forms as JSF
    from ocr_system_tpu.training.devanagari_font import ensure_font
    from ocr_system_tpu_torch.utils import smoke

    # the JAX renderer lists its Devanagari font only once it exists, as
    # the port always lists its own
    ensure_font()
    record: dict = {"jax": jax.__version__, "sizes": smoke.EVAL_SIZES,
                    "engine": {k: list(v) if isinstance(v, tuple) else v
                               for k, v in smoke.EVAL_ENGINE.items()},
                    "phases": {name: {} for name in smoke.EVAL_PHASES}, "det_settings": {}}
    ckpt = dict(det_checkpoint=str(REPO / "checkpoints/det"),
                rec_checkpoint=str(REPO / "checkpoints/rec_latin"),
                rec_checkpoint_devanagari=str(REPO / "checkpoints/rec_devanagari"))
    forms, _ = smoke.smoke_forms()
    pages = [PageImage(p, i + 1) for i, p in enumerate(forms[:smoke.DET_SETTINGS_FORMS])]
    with mesh_context(build_mesh("dp=1")):
        for name, update in smoke.DET_SETTINGS.items():
            t = time.perf_counter()
            engine = _build_engine("hybrid", JaxSettings(**SMOKE_SETTINGS, **ckpt,
                                                         compute_dtype="float32", **update))
            record["det_settings"][name] = [smoke.det_settings_record(o)
                                            for o in engine.process_pages(pages)]
            print(f"det_settings {name}: {time.perf_counter() - t:.1f} s", flush=True)
        logs: dict[str, list[dict]] = {}
        for dt in DTYPES:
            kit = jax_eval_kit(dt)
            for name in smoke.EVAL_PHASES:
                t = time.perf_counter()
                with smoke.RenderLog(JS, JSF) as log:
                    runs = smoke.run_eval(name, kit)
                # both dtypes draw the same lines and pages
                digests = [smoke.pixels_digest(ev["image"]) for ev in log.events]
                if name in logs and digests != [smoke.pixels_digest(ev["image"])
                                                for ev in logs[name]]:
                    raise SystemExit(f"{name}: the JAX renders differ between dtypes")
                logs.setdefault(name, log.events)
                record["phases"][name][dt] = runs
                print(f"{name} {dt}: {time.perf_counter() - t:.1f} s",
                      {run: r["result"] for run, r in runs.items()}, flush=True)
    record["renders"], arrays = smoke.save_renders(logs)
    np.savez_compressed(smoke.EVAL_RENDERS, **arrays)
    smoke.EVAL_EXPECTED.write_text(json.dumps(record, ensure_ascii=False) + "\n")
    return [smoke.EVAL_EXPECTED, smoke.EVAL_RENDERS]


def export_text_pdf() -> list[Path]:
    """assets/text_pdf_render.npz (module doc)."""
    from ocr_system_tpu.engine.pdf import render_pdf
    from ocr_system_tpu_torch.utils import smoke

    page = render_pdf(smoke.text_pdf(), dpi=smoke.TEXT_PDF_DPI)[0]
    np.savez_compressed(smoke.TEXT_PDF_RENDER, gray=np.ascontiguousarray(page[..., 0]))
    return [smoke.TEXT_PDF_RENDER]


def jax_skew_scores(f):
    """The JAX module's skew search scores, (A,), of one float32 [0, 1] gray
    page: ocr_system_tpu/ops/image_ops.estimate_skew_angle's body up to its
    argmax, which does not return them."""
    import jax.numpy as jnp

    from ocr_system_tpu.ops.image_ops import resize_bilinear

    n = 256
    small = resize_bilinear(f, (n, n))
    ink = (small < jnp.mean(small)).astype(jnp.float32)
    tans = jnp.tan(jnp.deg2rad(jnp.linspace(-15.0, 15.0, 31)))
    k = jnp.fft.fftfreq(n) * n
    x = jnp.arange(n, dtype=jnp.float32) - (n - 1) / 2.0
    phi = (-2.0 * jnp.pi / n) * (tans[:, None, None] * k[None, :, None] * x[None, None, :])
    g = jnp.sum(jnp.fft.fft(ink, axis=0)[None] * (jnp.cos(phi) + 1j * jnp.sin(phi)), axis=-1)
    return jnp.sum(jnp.abs(g) ** 2 * (jnp.abs(k) >= 8.0), axis=-1)


def export_skew() -> list[Path]:
    """The "skew" entry of assets/smoke_forms_expected.json (module doc),
    the rest of the file as it is."""
    import jax
    import jax.numpy as jnp

    from ocr_system_tpu.core.config import Settings as JaxSettings
    from ocr_system_tpu.core.mesh import build_mesh, mesh_context
    from ocr_system_tpu.engine import detector as jax_detector
    from ocr_system_tpu.engine.pipeline import _build_engine
    from ocr_system_tpu_torch.utils import smoke

    names, pages = smoke.skew_pages()
    engine = _build_engine("hybrid", JaxSettings(
        **SMOKE_SETTINGS, det_checkpoint=str(REPO / "checkpoints/det"),
        rec_checkpoint=str(REPO / "checkpoints/rec_latin"),
        rec_checkpoint_devanagari=str(REPO / "checkpoints/rec_devanagari")))
    neural = engine.detector.neural
    with mesh_context(build_mesh("dp=1")):
        dets = engine.detector.detect_batch(pages)
    bucket = jax_detector._det_bucket(pages[0].shape, neural.settings.det_image_buckets)
    canvases = np.stack([jax_detector._letterbox_host(p, bucket)[0] for p in pages])
    out = neural._forward(bucket, len(pages))(jnp.asarray(neural._pack_wire(canvases)),
                                               neural.variables)
    estimates, gray = np.asarray(out[-2]), np.asarray(out[-1])
    angles = np.asarray(jnp.linspace(-15.0, 15.0, 31))
    score = jax.jit(jax.vmap(jax_skew_scores))
    rows = []
    for name, page, det, est, g in zip(names, pages, dets, estimates, gray):
        sc = np.asarray(score(jnp.asarray(g[None], jnp.float32) / 255.0))[0]
        top = np.argsort(-sc, kind="stable")[:2]
        rows.append({"name": name, "digest": smoke.digest({"page": page}),
                     "estimate": float(est), "applied": float(det.skew_angle),
                     "top2": [[float(angles[i]), float(sc[i])] for i in top]})
        print(f"skew {name}: estimate {float(est)!r}, applied {float(det.skew_angle)!r}")
    path = ASSETS / "smoke_forms_expected.json"
    expected = json.loads(path.read_text())
    expected["skew"] = {"bucket": bucket, "pages": rows}
    path.write_text(json.dumps(expected, indent=1) + "\n")
    return [path]


def main() -> int:
    only = {"service": export_service, "train": export_train, "eval": export_eval,
            "text_pdf": export_text_pdf, "skew": export_skew}
    if sys.argv[1:2] == ["--only"] and sys.argv[2:3] and sys.argv[2] in only:
        for path in only[sys.argv[2]]():
            print(f"{path.relative_to(REPO)}: {path.stat().st_size / 1e6:.2f} MB")
        return 0
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
    export_skew()
    glued = export_glued()
    extract = export_extract()
    service = export_service()
    train = export_train()
    evaluation = export_eval()
    for path in (*written, ASSETS / "smoke_forms.npz", ASSETS / "hindi_forms.npz",
                 ASSETS / "smoke_forms_expected.json", *glued, *extract, *service, *train,
                 *evaluation):
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
