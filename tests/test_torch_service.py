"""The port's database, exports and workflow against the JAX package's:
each scenario of tests/test_db.py, tests/test_export.py and
tests/test_orchestrator.py runs in both packages on the same inputs (the
fake OCR engine and the rule extractor), each on its own temporary
storage root and database, and must leave the same rows, the same
exported content and the same processing-log steps, with ids, timestamps,
run directories and wall-clock times masked (``utils/smoke.masked``). A
database file that either package writes is read by the other."""

import io
import json
import threading
import zipfile
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import ocr_system_tpu.core.config as jax_config
import ocr_system_tpu.db.connection as jax_conn
import ocr_system_tpu.db.crud as jax_crud
import ocr_system_tpu.db.migrations as jax_migrations
import ocr_system_tpu.engine.pipeline as jax_pipeline
import ocr_system_tpu.extract.rules as jax_rules
import ocr_system_tpu.service.export as jax_export
import ocr_system_tpu.service.orchestrator as jax_orch
import ocr_system_tpu_torch.core.config as port_config
import ocr_system_tpu_torch.db.connection as port_conn
import ocr_system_tpu_torch.db.crud as port_crud
import ocr_system_tpu_torch.db.migrations as port_migrations
import ocr_system_tpu_torch.engine.pipeline as port_pipeline
import ocr_system_tpu_torch.extract.rules as port_rules
import ocr_system_tpu_torch.service.export as port_export
import ocr_system_tpu_torch.service.orchestrator as port_orch
from ocr_system_tpu_torch.utils.smoke import masked

torch.set_num_threads(1)


@dataclass(frozen=True)
class Side:
    """One package's service modules."""

    name: str
    config: object
    conn: object
    crud: object
    migrations: object
    pipeline: object
    rules: object
    export: object
    orch: object


JAX = Side("jax", jax_config, jax_conn, jax_crud, jax_migrations, jax_pipeline, jax_rules,
           jax_export, jax_orch)
PORT = Side("port", port_config, port_conn, port_crud, port_migrations, port_pipeline,
            port_rules, port_export, port_orch)


def settings_for(side: Side, root: Path):
    """tests/conftest.py's service settings, on ``root``."""
    return side.config.Settings(
        storage_root=str(root / "storage"), database_path=str(root / "test.db"),
        det_image_buckets=(256,), rec_width_buckets=(80, 160), rec_batch_size=8,
        ocr_engine="fake", extraction_method="rules", enable_deskew=False)


def form_png() -> bytes:
    """tests/conftest.py's form image as PNG bytes."""
    rng = np.random.default_rng(0)
    img = np.full((400, 600, 3), 255, np.uint8)
    for y in range(40, 360, 40):
        img[y: y + 14, 30: 30 + int(rng.integers(150, 500))] = 20
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return buf.getvalue()


def outcome(fn, *args, **kw):
    """("ok", result) or ("raises", the exception's class name)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # both packages must fail alike
        return ("raises", type(e).__name__)


def both(scenario, tmp_path) -> None:
    """Run ``scenario(side, root)`` for each package on its own directory;
    the records must be equal once masked, and not empty."""
    out = {}
    for side in (JAX, PORT):
        root = tmp_path / side.name
        root.mkdir()
        out[side.name] = masked(scenario(side, root), paths=(str(root),))
    assert out["port"] == out["jax"]
    assert out["port"]


# ---- the database (tests/test_db.py) ----


def _doc(repos, name="a.png", **kw):
    return repos.documents.create(filename=f"doc_x_{name}", original_filename=name,
                                  file_path=f"/tmp/{name}", file_size=100, file_type="png", **kw)


def _repos(side, root):
    return side.crud.Repositories(side.conn.Database(root / "t.db"))


def db_create_and_get(side, root):
    r = _repos(side, root)
    d = _doc(r)
    return [d, r.documents.get(d["id"])]


def db_soft_delete_hides(side, root):
    r = _repos(side, root)
    d = _doc(r)
    return [r.documents.soft_delete(d["id"]), r.documents.get_active(d["id"]),
            r.documents.get(d["id"])]


def db_list_pagination_and_search(side, root):
    r = _repos(side, root)
    for i in range(5):
        _doc(r, f"invoice_{i}.png")
    _doc(r, "receipt.pdf")
    return [[len(rows), total] for rows, total in (
        r.documents.list(page=1, page_size=3), r.documents.list(search="invoice"),
        r.documents.list(status="completed"))] + [r.documents.list(page=2, page_size=4)[0]]


def db_update_status(side, root):
    r = _repos(side, root)
    d = _doc(r)
    return r.documents.update_status(d["id"], "completed")


def db_status_counts(side, root):
    r = _repos(side, root)
    _doc(r)
    d = _doc(r, "b.png")
    r.documents.update_status(d["id"], "failed", "boom")
    return r.documents.status_counts()


def db_versioning(side, root):
    r = _repos(side, root)
    d = _doc(r)
    e1 = r.extractions.create_new_version(d["id"], status="completed")
    e2 = r.extractions.create_new_version(d["id"], status="processing")
    return [e1, e2, r.extractions.get(e1["id"]), r.extractions.get_current_for_document(d["id"]),
            r.extractions.list_for_document(d["id"])]


def db_unique_document_version(side, root):
    r = _repos(side, root)
    d = _doc(r)
    r.extractions.create_new_version(d["id"])
    return outcome(r.extractions.create, document_id=d["id"], version=1)


def db_finalize(side, root):
    r = _repos(side, root)
    e = r.extractions.create_new_version(_doc(r)["id"])
    return r.extractions.finalize(e["id"])


def db_update_stats(side, root):
    r = _repos(side, root)
    e = r.extractions.create_new_version(_doc(r)["id"])
    r.fields.bulk_create(e["id"], [
        {"field_key": "A", "field_value": "1", "confidence": 0.95},
        {"field_key": "B", "field_value": "2", "confidence": 0.7},
        {"field_key": "C", "field_value": "3", "confidence": 0.3}])
    return r.extractions.update_stats(e["id"], settings_for(side, root))


def db_layout_json_roundtrip(side, root):
    r = _repos(side, root)
    layout = [{"type": "word", "content": "hi", "polygon": [1, 2, 3, 4, 5, 6, 7, 8]}]
    e = r.extractions.create_new_version(_doc(r)["id"], layout_data=layout,
                                         page_dimensions={"1": {"width": 100}})
    return r.extractions.get(e["id"])


def db_bulk_create_sort_order(side, root):
    r = _repos(side, root)
    e = r.extractions.create_new_version(_doc(r)["id"])
    r.fields.bulk_create(e["id"], [{"field_key": k, "field_value": k, "confidence": 0.9}
                                   for k in "abc"])
    return r.fields.list_for_extraction(e["id"])


def db_update_value_audit(side, root):
    r = _repos(side, root)
    e = r.extractions.create_new_version(_doc(r)["id"])
    (f,) = r.fields.bulk_create(e["id"], [{"field_key": "k", "field_value": "v0",
                                           "confidence": 0.9}])
    r.fields.update_value(f["id"], "v1")
    r.fields.update_value(f["id"], "v2", edit_type="correction", edited_by="rev")
    return [r.fields.get(f["id"]), r.edits.list_for_field(f["id"]),
            r.edits.count_for_extraction(e["id"])]


def db_confidence_check_constraint(side, root):
    r = _repos(side, root)
    e = r.extractions.create_new_version(_doc(r)["id"])
    return outcome(r.fields.create, extraction_id=e["id"], field_key="x", confidence=1.5)


def db_low_confidence_query(side, root):
    r = _repos(side, root)
    e = r.extractions.create_new_version(_doc(r)["id"])
    r.fields.bulk_create(e["id"], [{"field_key": "hi", "field_value": "", "confidence": 0.9},
                                   {"field_key": "lo", "field_value": "", "confidence": 0.2}])
    return r.fields.low_confidence(e["id"], 0.6)


def db_seed_templates(side, root):
    r = _repos(side, root)
    return [side.crud.seed_templates(r), side.crud.seed_templates(r),
            r.templates.get_by_name("Invoice"), r.templates.list_active()]


def db_increment_usage(side, root):
    r = _repos(side, root)
    side.crud.seed_templates(r)
    t = r.templates.get_by_name("Invoice")
    r.templates.increment_usage(t["id"])
    return r.templates.get(t["id"])


def db_log_step_and_stats(side, root):
    r = _repos(side, root)
    d = _doc(r)
    r.logs.log_step(d["id"], "ocr", "completed", duration_ms=120)
    r.logs.log_step(d["id"], "ocr", "failed", message="x", duration_ms=80,
                    details={"pages": 2})
    return [r.logs.list_for_document(d["id"]), r.logs.failed_steps(),
            [dict(s) for s in r.logs.step_stats()]]


def db_concurrent_uploads(side, root):
    r = _repos(side, root)
    errors = []

    def worker(t):
        try:
            for i in range(12):
                d = _doc(r, name=f"t{t}_{i}.png")
                e = r.extractions.create_new_version(d["id"], status="processing")
                r.logs.log_step(d["id"], "ocr", "completed", duration_ms=5)
                r.extractions.update(e["id"], status="completed")
        except Exception as exc:  # noqa: BLE001
            errors.append(type(exc).__name__)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return [errors, r.documents.list()[1], r.documents.status_counts()]


def db_concurrent_connections(side, root):
    path = root / "multi.db"
    side.conn.Database(path).close()
    errors = []

    def worker(w):
        try:
            r = side.crud.Repositories(side.conn.Database(path))
            for i in range(10):
                _doc(r, name=f"w{w}_{i}.png")
        except Exception as exc:  # noqa: BLE001
            errors.append(type(exc).__name__)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return [errors, side.crud.Repositories(side.conn.Database(path)).documents.list()[1]]


def db_migrations(side, root):
    db = side.conn.Database(root / "m.db")
    return [side.migrations.get_version(db), side.migrations.migrate(db),
            side.migrations.get_version(db), side.migrations.migrate(db),
            side.migrations.CURRENT_VERSION, db.check_connection()]


DB_SCENARIOS = [db_create_and_get, db_soft_delete_hides, db_list_pagination_and_search,
                db_update_status, db_status_counts, db_versioning, db_unique_document_version,
                db_finalize, db_update_stats, db_layout_json_roundtrip,
                db_bulk_create_sort_order, db_update_value_audit,
                db_confidence_check_constraint, db_low_confidence_query, db_seed_templates,
                db_increment_usage, db_log_step_and_stats, db_concurrent_uploads,
                db_concurrent_connections, db_migrations]


@pytest.mark.parametrize("scenario", DB_SCENARIOS, ids=lambda f: f.__name__)
def test_database_matches_jax(scenario, tmp_path):
    both(scenario, tmp_path)


def _fill(side, path: Path) -> None:
    """Documents, versioned extractions with layout, fields, edits and logs."""
    r = side.crud.Repositories(side.conn.Database(path))
    side.crud.seed_templates(r)
    d = _doc(r, "written.png")
    r.extractions.create_new_version(d["id"], status="completed")
    e = r.extractions.create_new_version(
        d["id"], status="completed", layout_data=[{"type": "word", "content": "Ä",
                                                   "polygon": [0.5, 1, 2, 1, 2, 3, 0.5, 3]}],
        page_dimensions={"1": {"width": 960.0, "height": 960.0}}, form_type="Invoice")
    (f, _) = r.fields.bulk_create(e["id"], [
        {"field_key": "Total", "field_value": "$9", "confidence": 0.8,
         "value_bbox": {"polygon": [1, 2, 3, 4, 5, 6, 7, 8], "page": 1}},
        {"field_key": "Name", "field_value": "Jane", "confidence": 0.4}])
    r.fields.update_value(f["id"], "$10")
    r.fields.bulk_update_validation({f["id"]: (True, "ok", False)})
    r.extractions.update_stats(e["id"], settings_for(side, path.parent))
    r.logs.log_step(d["id"], "ocr", "completed", extraction_id=e["id"], duration_ms=3,
                    details={"pages": 1})


def _read(side, path: Path) -> list:
    r = side.crud.Repositories(side.conn.Database(path))
    docs, _ = r.documents.list()
    out = [docs, r.templates.list_active()]
    for d in docs:
        exts = r.extractions.list_for_document(d["id"])
        out += [exts, r.logs.list_for_document(d["id"])]
        for e in exts:
            fields = r.fields.list_for_extraction(e["id"])
            out += [fields, [r.edits.list_for_field(f["id"]) for f in fields]]
    return out


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)], ids=["jax_to_port",
                                                                          "port_to_jax"])
def test_database_file_is_shared(writer, reader, tmp_path):
    """A database file written by one package reads the same in the
    other, row for row (decoded JSON columns and booleans included)."""
    path = tmp_path / "shared.db"
    _fill(writer, path)
    got, want = _read(reader, path), _read(writer, path)
    assert got == want and len(got) > 4


# ---- exports (tests/test_export.py) ----


def _export_fixture(side, root):
    s = settings_for(side, root)
    db = side.conn.Database(root / "e.db")
    repos = side.crud.Repositories(db)
    doc = repos.documents.create(filename="doc.png", original_filename="invoice.png",
                                 file_path="/tmp/x.png", file_size=10, file_type="png",
                                 status="completed")
    ext = repos.extractions.create_new_version(doc["id"], status="completed",
                                               form_type="Invoice", language="en")
    repos.fields.bulk_create(ext["id"], [
        {"field_key": "Invoice Number", "field_value": "12345", "field_type": "text",
         "confidence": 0.95},
        {"field_key": "Total", "field_value": "$99.00", "field_type": "currency",
         "confidence": 0.7},
        {"field_key": "Notes", "field_value": "smudged", "field_type": "text",
         "confidence": 0.2}])
    repos.extractions.update_stats(ext["id"], s)
    return side.export.ExportService(s, db), repos, ext


def file_record(path) -> object:
    """An exported file's content: JSON parsed, CSV and PDF as text, XLSX as
    its members' text."""
    data = Path(path).read_bytes()
    suffix = Path(path).suffix
    if suffix == ".json":
        return json.loads(data)
    if suffix == ".xlsx":
        z = zipfile.ZipFile(io.BytesIO(data))
        return {n: z.read(n).decode("utf-8") for n in sorted(z.namelist())}
    return data.decode("latin-1")


def _result(res) -> dict:
    # a deflated workbook's size moves with the timestamps it holds; its
    # members are compared instead
    size = "<deflated>" if res.format == "excel" else res.size_bytes
    return {"success": res.success, "filename": res.filename, "format": res.format,
            "size_bytes": size, "error": res.error,
            "content": file_record(res.file_path) if res.success else None}


def export_each_format(side, root):
    s, _, ext = _export_fixture(side, root)
    return [_result(s.export_extraction(ext["id"], fmt))
            for fmt in ("json", side.export.ExportFormat.CSV, "excel", "pdf")]


def export_unknown_extraction(side, root):
    s, _, _ = _export_fixture(side, root)
    return _result(s.export_extraction("missing", "json"))


def export_gate_blocks_invalid(side, root):
    s, repos, ext = _export_fixture(side, root)
    repos.fields.bulk_create(ext["id"], [{"field_key": "Email", "field_value": "not-an-email",
                                          "field_type": "email", "confidence": 0.9}])
    return _result(s.export_extraction(ext["id"], "json", validate_first=True))


def export_gate_passes_valid(side, root):
    s, _, ext = _export_fixture(side, root)
    return _result(s.export_extraction(ext["id"], "csv", validate_first=True))


def export_bulk(side, root):
    s, repos, ext = _export_fixture(side, root)
    doc2 = repos.documents.create(filename="d2.png", original_filename="receipt.png",
                                  file_path="/tmp/y.png", file_size=5, file_type="png")
    ext2 = repos.extractions.create_new_version(doc2["id"], status="completed")
    repos.fields.bulk_create(ext2["id"], [{"field_key": "A", "field_value": "1",
                                           "confidence": 0.9}])
    return [_result(s.bulk_export([ext["id"], ext2["id"]], "excel")),
            _result(s.bulk_export([ext["id"], ext["id"]], "csv")),
            _result(s.bulk_export([ext["id"]], "json")),
            _result(s.bulk_export([ext["id"]], "pdf")),
            _result(s.bulk_export([ext["id"], "missing"], "json"))]


def export_logs_steps(side, root):
    s, repos, ext = _export_fixture(side, root)
    s.export_extraction(ext["id"], "json")
    return repos.logs.list_for_document(ext["document_id"])


EXPORT_SCENARIOS = [export_each_format, export_unknown_extraction, export_gate_blocks_invalid,
                    export_gate_passes_valid, export_bulk, export_logs_steps]


@pytest.mark.parametrize("scenario", EXPORT_SCENARIOS, ids=lambda f: f.__name__)
def test_exports_match_jax(scenario, tmp_path):
    both(scenario, tmp_path)


def test_pdf_and_xlsx_writers_match_jax():
    """The stdlib PDF and XLSX writers give the same bytes (the XLSX
    members; zip entries carry the clock)."""
    from ocr_system_tpu.utils import pdf as jax_updf
    from ocr_system_tpu.utils import xlsx as jax_xlsx
    from ocr_system_tpu_torch.utils import pdf as port_updf
    from ocr_system_tpu_torch.utils import xlsx as port_xlsx

    docs = []
    for mod in (jax_updf, port_updf):
        d = mod.PDFDocument()
        p = d.add_page()
        p.text(40, 50, "Report (ü) \\ done", size=12, bold=True, color=(0.2, 0.3, 0.4))
        p.rect(40, 60, 100, 20, (1, 0.5, 0))
        d.add_page().text(10, 10, "second")
        docs.append(d.to_bytes())
    assert docs[0] == docs[1]
    books = []
    for mod in (jax_xlsx, port_xlsx):
        wb = mod.Workbook()
        sh = wb.add_sheet("Fields & <more>")
        sh.col_widths = {0: 20}
        sh.add_row(["a", 1, 2.5, None, "x<y"], [mod.Workbook.STYLE_HEADER, 0, 0, 0, 0])
        z = zipfile.ZipFile(io.BytesIO(wb.to_bytes()))
        books.append({n: z.read(n) for n in z.namelist()})
    assert books[0] == books[1]


# ---- the workflow (tests/test_orchestrator.py) ----


def _orch(side, root, text="Name: John Smith"):
    s = settings_for(side, root)
    db = side.conn.Database(root / "o.db")
    o = side.orch.ExtractionOrchestrator(settings=s, db=db,
                                         engine=side.pipeline.FakeOCREngine(s, text=text),
                                         extractor=side.rules.RuleExtractor())
    path = root / "form.png"
    path.write_bytes(form_png())
    doc = o.repos.documents.create(filename="doc_1.png", original_filename="form.png",
                                   file_path=str(path), file_size=path.stat().st_size,
                                   file_type="png")
    o.ocr_retry.initial_interval = 0.01
    return o, doc


def snapshot(o, doc_id) -> dict:
    """The document's rows after a workflow: the document, its extractions
    with their fields, its processing log, and the saved page images."""
    r = o.repos
    exts = r.extractions.list_for_document(doc_id)
    return {"document": r.documents.get(doc_id), "extractions": exts,
            "fields": [r.fields.list_for_extraction(e["id"]) for e in exts],
            "logs": r.logs.list_for_document(doc_id),
            "images": sorted(p.name for p in o.settings.processed_path.iterdir())}


def wf_full_workflow(side, root):
    o, doc = _orch(side, root)
    return [o.extract_document(doc["id"]), snapshot(o, doc["id"])]


def wf_processed_image_bytes(side, root):
    """The saved page JPEG: the port's own encoder writes PIL's bytes."""
    o, doc = _orch(side, root)
    o.extract_document(doc["id"])
    return [p.read_bytes().hex() for p in sorted(o.settings.processed_path.iterdir())]


def wf_reextraction_bumps_version(side, root):
    o, doc = _orch(side, root)
    e1 = o.extract_document(doc["id"])
    e2 = o.extract_document(doc["id"])
    return [e1, e2, snapshot(o, doc["id"])]


def wf_template_and_prompt(side, root):
    o, doc = _orch(side, root, text="Name: Jane Roe Date: 2024-01-31 Total: $12.50")
    e = o.extract_document(doc["id"], template={"expected_fields": ["Name", "Phone"]},
                           custom_prompt="Extract only: Name, Total")
    return [e, snapshot(o, doc["id"])]


def _flaky(side, settings, fail_times):
    class Flaky(side.pipeline.FakeOCREngine):
        def __init__(self):
            super().__init__(settings, text="Key: Val")
            self.calls = 0

        def process_document(self, data, filename):
            self.calls += 1
            if self.calls <= fail_times:
                raise RuntimeError("transient OCR failure")
            return super().process_document(data, filename)

    return Flaky()


def wf_retry_recovers(side, root):
    o, doc = _orch(side, root)
    o.engine = _flaky(side, o.settings, 1)
    return [o.extract_document(doc["id"]), o.engine.calls, snapshot(o, doc["id"])]


def wf_persistent_failure(side, root):
    o, doc = _orch(side, root)
    o.engine = _flaky(side, o.settings, 99)
    return [outcome(o.extract_document, doc["id"]), snapshot(o, doc["id"]),
            o.repos.logs.failed_steps()]


def _boom(side, fail_calls=1):
    class Boom(side.rules.RuleExtractor):
        def __init__(self):
            self.calls = 0

        def extract(self, *a, **k):
            self.calls += 1
            if self.calls <= fail_calls:
                raise RuntimeError("extract boom")
            return super().extract(*a, **k)

    return Boom()


def wf_checkpoint_resume(side, root):
    o, doc = _orch(side, root)
    o.extractor = _boom(side)
    o.extract_retry.max_attempts = 1
    first = outcome(o.extract_document, doc["id"])
    state = o.checkpointer.load(doc["id"])
    calls = {"n": 0}
    orig = o.engine.process_document

    def counting(data, filename):
        calls["n"] += 1
        return orig(data, filename)

    o.engine.process_document = counting
    return [first, state.completed_stages, o.extract_document(doc["id"]), calls["n"],
            o.checkpointer.load(doc["id"]), snapshot(o, doc["id"])]


def wf_missing_document(side, root):
    o, _ = _orch(side, root)
    return outcome(o.extract_document, "nope")


def wf_timeout_marks_failed(side, root):
    o, doc = _orch(side, root)
    o.settings = o.settings.model_copy(update={"extraction_timeout_s": 0.0})
    return [outcome(o.extract_document, doc["id"]), snapshot(o, doc["id"])]


def wf_new_request_discards_checkpoint(side, root):
    o, doc = _orch(side, root)
    o.extractor = _boom(side)
    o.extract_retry.max_attempts = 1
    first = outcome(o.extract_document, doc["id"])
    new_row = o.repos.extractions.create_new_version(doc["id"], status="processing")
    return [first, o.extract_document(doc["id"], extraction_id=new_row["id"]),
            o.repos.extractions.get_current_for_document(doc["id"]), snapshot(o, doc["id"])]


def wf_changed_template_discards_checkpoint(side, root):
    o, doc = _orch(side, root)
    o.extractor = _boom(side)
    o.extract_retry.max_attempts = 1
    first = outcome(o.extract_document, doc["id"])
    stale = o.checkpointer.load(doc["id"]).extraction_id
    ext = o.extract_document(doc["id"], template={"expected_fields": ["Name"]})
    return [first, ext["id"] != stale, ext, snapshot(o, doc["id"])]


def wf_extract_retry_then_fail(side, root):
    o, doc = _orch(side, root)
    o.extractor = _boom(side, fail_calls=5)
    o.extract_retry.initial_interval = 0.01
    return [outcome(o.extract_document, doc["id"]), o.extractor.calls, snapshot(o, doc["id"])]


def wf_pdf_upload(side, root):
    """A two-page scanned PDF through the fake engine: one saved image and
    one page dimension per page."""
    from ocr_system_tpu_torch.utils.smoke import scanned_pdf

    o, doc = _orch(side, root)
    pdf_path = root / "scan.pdf"
    pdf_path.write_bytes(scanned_pdf([np.full((40, 60), 200, np.uint8),
                                      np.full((30, 50), 90, np.uint8)]))
    pdf_doc = o.repos.documents.create(filename="doc_2.pdf", original_filename="scan.pdf",
                                       file_path=str(pdf_path), file_size=10, file_type="pdf")
    return [o.extract_document(pdf_doc["id"]), snapshot(o, pdf_doc["id"])]


WORKFLOW_SCENARIOS = [wf_full_workflow, wf_processed_image_bytes, wf_reextraction_bumps_version,
                      wf_template_and_prompt, wf_retry_recovers, wf_persistent_failure,
                      wf_checkpoint_resume, wf_missing_document, wf_timeout_marks_failed,
                      wf_new_request_discards_checkpoint,
                      wf_changed_template_discards_checkpoint, wf_extract_retry_then_fail,
                      wf_pdf_upload]


@pytest.mark.parametrize("scenario", WORKFLOW_SCENARIOS, ids=lambda f: f.__name__)
def test_workflow_matches_jax(scenario, tmp_path):
    both(scenario, tmp_path)


def test_process_orchestrator_singleton():
    """get_orchestrator builds one orchestrator; set_orchestrator swaps it."""
    marker = object()
    port_orch.set_orchestrator(marker)
    try:
        assert port_orch.get_orchestrator() is marker
    finally:
        port_orch.set_orchestrator(None)


def test_fields_for_needs_no_database(tmp_path, monkeypatch):
    """``fields_for`` (the stage logic without the workflow) opens no
    database: the orchestrator's repositories are built at their first
    use."""
    monkeypatch.chdir(tmp_path)
    s = settings_for(PORT, tmp_path)
    o = port_orch.ExtractionOrchestrator(s, engine=port_pipeline.FakeOCREngine(s),
                                         extractor=port_rules.RuleExtractor())
    doc = o.engine.process_document(form_png(), "form.png")
    result, rows, report = o.fields_for(doc)
    assert rows and report.total_fields == len(rows) == len(result.fields)
    assert o._repos is None and not any(tmp_path.rglob("*.db"))


def test_engine_warmup_and_status():
    """``TorchOCREngine.warmup`` runs each det bucket once (the largest at
    ``wave`` pages) and returns its seconds per bucket; ``get_status``
    names the engine's devices and buckets; the fake engine has the
    JAX one's status."""
    from ocr_system_tpu_torch.utils import smoke

    eng = smoke.build_engine("cpu", det_image_buckets=(96, 128), rec_width_buckets=(80,),
                             det_batch_size=2)
    seen = []
    process = eng.process_pages
    eng.process_pages = lambda pages: seen.append([p.pixels.shape for p in pages]) or \
        process(pages)
    out = eng.warmup()
    assert sorted(out) == [96, 128] and all(isinstance(v, float) for v in out.values()), out
    assert sorted(seen) == [[(96, 96, 3)], [(128, 128, 3)] * 2]
    assert eng.get_status() == {"engine": "torch", "available": True, "devices": ["cpu"],
                                "det_buckets": [96, 128], "rec_buckets": [80]}
    eng.process_pages = lambda pages: 1 / 0
    assert all(str(v).startswith("failed:") for v in eng.warmup().values())
    s = settings_for(PORT, Path("."))
    assert port_pipeline.FakeOCREngine(s).get_status() == \
        jax_pipeline.FakeOCREngine(settings_for(JAX, Path("."))).get_status()


def test_app_starts_the_engine_warmup(tmp_path):
    """With ``warmup_on_start`` and a real engine, ``ApiContext`` runs the
    engine's warm-up in a background thread."""
    from ocr_system_tpu_torch.api.app import ApiContext

    called = threading.Event()

    class Engine(port_pipeline.FakeOCREngine):
        def warmup(self):
            called.set()
            return {}

    s = settings_for(PORT, tmp_path).model_copy(update={"ocr_engine": "hybrid",
                                                         "warmup_on_start": True})
    db = port_conn.Database(tmp_path / "w.db")
    orch = port_orch.ExtractionOrchestrator(s, engine=Engine(s),
                                            extractor=port_rules.RuleExtractor(), db=db)
    ApiContext(settings=s, db=db, orchestrator=orch)
    assert called.wait(10)
    db.close()
