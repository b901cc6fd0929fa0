"""The REST API: reference-compatible route tree (port of
ocr_system_tpu/api/app.py).

    python -m ocr_system_tpu_torch.api.app

serves it on ``Settings.host``/``port`` with the engine of
``Settings.ocr_engine`` on the card (``core/dtypes.resolve_device``: it
raises without one). Against the JAX module: no persistent compile cache
(eager PyTorch compiles nothing ahead; the CUDA kernels build once per
checkout, ``kernels/_build.py``), the warm-up calls ``engine.warmup()``
(every engine of the port has one), and ``/api/stats/devices`` reads
``torch.cuda``'s memory counters.

Route parity (reference backend/api/router.py:29-119 + sub-modules):
  GET  /                                    app info        (main.py:239-247)
  GET  /health                              deep component check (main.py:251-316)
  GET  /api/                                API info        (router.py:126-164)
  POST /api/documents/upload                upload + optional auto-extract
                                                            (documents.py:159-299)
  GET  /api/documents                       paginated list  (documents.py:316-394)
  GET  /api/documents/{id}                  detail          (documents.py:411-461)
  DELETE /api/documents/{id}                soft delete     (documents.py:479-514)
  GET  /api/documents/{id}/processed-image/{page}           (documents.py:531-578)
  POST /api/extractions/{document_id}       start (202/409) (extraction.py:281-345)
  GET  /api/extractions/{id}                detail+layout   (extraction.py:362-372)
  GET  /api/extractions/{id}/status         light poll      (extraction.py:389-408)
  PATCH /api/extractions/{id}/fields/{fid}  edit field      (extraction.py:426-507)
  POST /api/extractions/{id}/validate       run validation  (extraction.py:524-554)
  POST /api/extractions/{id}/finalize       lock (confirm)  (extraction.py:576-632)
  DELETE /api/extractions/{id}              delete          (extraction.py:649-683)
  POST /api/exports                         create          (exports.py:171-235)
  GET  /api/exports/{id}                    info            (exports.py:251-274)
  GET  /api/exports/{id}/download           file            (exports.py:291-340)
  GET  /api/exports/extraction/{id}/{fmt}   quick export    (exports.py:356-441)
  GET  /api/templates                       form templates
  GET  /api/stats/dashboard|documents|extractions|processing|overview
                                                            (stats.py:112-603)
"""

from __future__ import annotations

import logging
import time
from datetime import datetime, timedelta, timezone

from ocr_system_tpu_torch.api.http import App, BackgroundTasks, HTTPError, Request, Response
from ocr_system_tpu_torch.api.middleware import (
    RateLimitConfig,
    RateLimiter,
    cors_middleware,
    endpoint_rate_limit,
    rate_limit_middleware,
    timing_middleware,
)
from ocr_system_tpu_torch.api.serializers import (
    serialize_document,
    serialize_extraction,
    serialize_extraction_summary,
    serialize_field,
)
from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.db.connection import Database, get_database
from ocr_system_tpu_torch.db.crud import Repositories, seed_templates
from ocr_system_tpu_torch.service.export import CONTENT_TYPES, ExportFormat, ExportService
from ocr_system_tpu_torch.service.orchestrator import ExtractionOrchestrator
from ocr_system_tpu_torch.service.validation import ValidationService
from ocr_system_tpu_torch.utils.file_manager import FileManager, FileValidationError
from ocr_system_tpu_torch.version import __version__

logger = logging.getLogger(__name__)


class ApiContext:
    """Wires settings + db + services for one app instance (the DI the
    reference does with FastAPI Depends)."""

    def __init__(
        self,
        settings: Settings | None = None,
        db: Database | None = None,
        orchestrator: ExtractionOrchestrator | None = None,
    ):
        self.settings = settings or get_settings()
        self.db = db or get_database()
        self.repos = Repositories(self.db)
        self.files = FileManager(self.settings)
        self.orchestrator = orchestrator or ExtractionOrchestrator(
            settings=self.settings, db=self.db
        )
        self.exports = ExportService(self.settings, self.db)
        self.validation = ValidationService(self.settings)
        self.export_records: dict[str, dict] = {}  # reference _export_cache
        self.started_at = time.time()
        seed_templates(self.repos)
        if self.settings.warmup_on_start and self.settings.ocr_engine != "fake":
            self._start_warmup()

    def _start_warmup(self) -> None:
        """Run the engine's warm-up (``TorchOCREngine.warmup``: each det
        bucket once, the largest at ``det_batch_size``, which builds the
        CUDA library and sets up cuDNN and cuBLAS for the serving shapes) in
        a background thread, so that the first upload does not pay for it."""
        import threading

        def _warm():
            try:
                logger.info("engine warmup: %s", self.orchestrator.engine.warmup())
            except Exception:
                logger.exception("engine warmup failed (non-fatal)")

        threading.Thread(target=_warm, daemon=True, name="warmup").start()


def create_app(ctx: ApiContext | None = None) -> App:
    ctx = ctx or ApiContext()
    app = App()
    s = ctx.settings
    app.trusted_proxies = {
        ip.strip() for ip in s.trusted_proxies.split(",") if ip.strip()
    }
    app.use(cors_middleware)
    app.use(
        rate_limit_middleware(
            RateLimiter(
                RateLimitConfig(
                    requests_per_minute=s.rate_limit_per_minute,
                    requests_per_hour=s.rate_limit_per_hour,
                )
            )
        )
    )
    app.use(timing_middleware)
    r = app.router

    # ---- helpers ----

    def get_document_or_404(document_id: str) -> dict:
        doc = ctx.repos.documents.get_active(document_id)
        if doc is None:
            raise HTTPError(404, f"Document {document_id} not found")
        return doc

    def get_extraction_or_404(extraction_id: str) -> dict:
        ext = ctx.repos.extractions.get(extraction_id)
        if ext is None:
            raise HTTPError(404, f"Extraction {extraction_id} not found")
        return ext

    def check_not_finalized(ext: dict) -> None:
        if ext.get("is_finalized"):
            raise HTTPError(409, "Extraction is finalized and cannot be modified")

    def run_extraction(document_id: str, template=None, custom_prompt=None,
                       extraction_id=None):
        try:
            ctx.orchestrator.extract_document(
                document_id, template=template, custom_prompt=custom_prompt,
                extraction_id=extraction_id,
            )
        except Exception:
            logger.exception("background extraction failed for %s", document_id)

    # ---- root / health / ui ----

    @r.get("/")
    async def root(req: Request, bg: BackgroundTasks) -> Response:
        return Response.json(
            {
                "name": s.app_name,
                "version": __version__,
                "status": "running",
                "docs": "/api/",
                "ui": "/ui",
            }
        )

    _UI_TYPES = {
        "html": "text/html", "js": "application/javascript", "css": "text/css",
        "svg": "image/svg+xml", "png": "image/png", "ico": "image/x-icon",
    }

    @r.get("/ui")
    async def ui_index(req: Request, bg: BackgroundTasks) -> Response:
        from ocr_system_tpu_torch.frontend import STATIC_DIR

        return Response.file(STATIC_DIR / "index.html", "text/html; charset=utf-8")

    @r.get("/ui/{asset}")
    async def ui_asset(req: Request, bg: BackgroundTasks) -> Response:
        from ocr_system_tpu_torch.frontend import STATIC_DIR

        name = req.path_params["asset"]
        if "/" in name or ".." in name or name.startswith("."):
            raise HTTPError(404, "Not found")
        path = STATIC_DIR / name
        if not path.is_file():
            raise HTTPError(404, "Not found")
        ext = name.rsplit(".", 1)[-1]
        return Response.file(path, _UI_TYPES.get(ext, "application/octet-stream"))

    @r.get("/health")
    async def health(req: Request, bg: BackgroundTasks) -> Response:
        checks = {}
        checks["database"] = "ok" if ctx.db.check_connection() else "error"
        checks["storage"] = (
            "ok" if s.upload_path.is_dir() and s.export_path.is_dir() else "error"
        )
        try:
            status = ctx.orchestrator.engine.get_status()
            checks["ocr_engine"] = "ok" if status.get("available") else "error"
        except Exception:
            checks["ocr_engine"] = "error"
        healthy = all(v == "ok" for v in checks.values())
        return Response.json(
            {
                "status": "healthy" if healthy else "degraded",
                "version": __version__,
                "uptime_s": round(time.time() - ctx.started_at, 1),
                "components": checks,
            },
            status=200 if healthy else 503,
        )

    @r.get("/api")
    async def api_info(req: Request, bg: BackgroundTasks) -> Response:
        return Response.json(
            {
                "name": f"{s.app_name} API",
                "version": __version__,
                "endpoints": {
                    "documents": "/api/documents",
                    "extractions": "/api/extractions",
                    "exports": "/api/exports",
                    "stats": "/api/stats",
                    "templates": "/api/templates",
                },
            }
        )

    # ---- documents ----

    @r.post("/api/documents/upload")
    async def upload_document(req: Request, bg: BackgroundTasks) -> Response:
        fields, files = req.form()
        if "file" not in files:
            raise HTTPError(422, "Missing 'file' part")
        up = files["file"]
        try:
            ctx.files.validate_file(up.filename, len(up.data))
        except FileValidationError as e:
            raise HTTPError(400, str(e))
        auto = fields.get("auto_extract", "true").lower() in ("1", "true", "yes")
        # optional template selection at upload (reference upload_zone.py:30-77).
        # Resolved BEFORE anything persists: a 404 here must not leave an
        # orphaned file + pending document row behind.
        template = None
        if fields.get("template_name"):
            template = ctx.repos.templates.get_by_name(fields["template_name"])
            if template is None:
                raise HTTPError(404, f"Template {fields['template_name']} not found")
        path, stored_name = ctx.files.save_upload(up.data, up.filename)
        doc = ctx.repos.documents.create(
            filename=stored_name,
            original_filename=up.filename,
            file_path=str(path),
            file_size=len(up.data),
            file_type=FileManager.get_extension(up.filename),
            status="pending",
        )
        if auto:
            if template is not None:
                # usage counts reflect templates that actually drove an
                # extraction, so the increment lives in the auto branch
                ctx.repos.templates.increment_usage(template["id"])
            bg.add_task(run_extraction, doc["id"], template)
        return Response.json(
            {**serialize_document(doc), "auto_extract": auto}, status=201
        )

    @r.get("/api/documents")
    async def list_documents(req: Request, bg: BackgroundTasks) -> Response:
        page = max(int(req.query.get("page", "1") or 1), 1)
        page_size = min(max(int(req.query.get("page_size", "20") or 20), 1), 100)
        docs, total = ctx.repos.documents.list(
            page=page,
            page_size=page_size,
            status=req.query.get("status") or None,
            search=req.query.get("search") or None,
        )
        return Response.json(
            {
                "items": [serialize_document(d) for d in docs],
                "total": total,
                "page": page,
                "page_size": page_size,
                "total_pages": (total + page_size - 1) // page_size,
            }
        )

    @r.get("/api/documents/{document_id}")
    async def get_document(req: Request, bg: BackgroundTasks) -> Response:
        doc = get_document_or_404(req.path_params["document_id"])
        extractions = ctx.repos.extractions.list_for_document(doc["id"])
        return Response.json(serialize_document(doc, extractions))

    @r.delete("/api/documents/{document_id}")
    async def delete_document(req: Request, bg: BackgroundTasks) -> Response:
        doc = get_document_or_404(req.path_params["document_id"])
        ctx.repos.documents.soft_delete(doc["id"])
        return Response.json({"detail": "Document deleted", "id": doc["id"]})

    @r.get("/api/documents/{document_id}/processed-image/{page}")
    async def processed_image(req: Request, bg: BackgroundTasks) -> Response:
        doc = get_document_or_404(req.path_params["document_id"])
        try:
            page = int(req.path_params["page"])
        except ValueError:
            raise HTTPError(422, "page must be an integer")
        path = ctx.files.processed_image_path(doc["id"], page)
        if not path.is_file():
            raise HTTPError(404, f"No processed image for page {page}")
        return Response.file(path, "image/jpeg")

    # ---- extractions ----

    # OCR-heavy endpoint gets its own budget (reference: 20 rpm OCR limiter,
    # rate_limit.py:244-253)
    ocr_limiter = RateLimiter(
        RateLimitConfig(
            requests_per_minute=s.ocr_rate_limit_per_minute,
            requests_per_hour=s.rate_limit_per_hour,
        )
    )

    @r.post("/api/extractions/{document_id}")
    @endpoint_rate_limit(ocr_limiter)
    async def start_extraction(req: Request, bg: BackgroundTasks) -> Response:
        doc = get_document_or_404(req.path_params["document_id"])
        if doc["status"] == "processing":
            raise HTTPError(409, "Document is already being processed")
        body = req.json() or {}
        template = None
        if body.get("template_name"):
            template = ctx.repos.templates.get_by_name(body["template_name"])
            if template is None:
                raise HTTPError(404, f"Template {body['template_name']} not found")
            ctx.repos.templates.increment_usage(template["id"])
        ext = ctx.repos.extractions.create_new_version(
            doc["id"], status="processing"
        )
        ctx.repos.documents.update_status(doc["id"], "processing")
        bg.add_task(
            run_extraction,
            doc["id"],
            template,
            body.get("custom_prompt"),
            ext["id"],
        )
        return Response.json(
            {
                "detail": "Extraction started",
                "extraction_id": ext["id"],
                "document_id": doc["id"],
                "version": ext["version"],
            },
            status=202,
        )

    @r.get("/api/extractions/{extraction_id}")
    async def get_extraction(req: Request, bg: BackgroundTasks) -> Response:
        ext = get_extraction_or_404(req.path_params["extraction_id"])
        fields = ctx.repos.fields.list_for_extraction(ext["id"])
        include_layout = req.query.get("include_layout", "true") != "false"
        return Response.json(
            serialize_extraction(ext, fields, s, include_layout=include_layout)
        )

    @r.get("/api/extractions/document/{document_id}")
    async def get_current_extraction(req: Request, bg: BackgroundTasks) -> Response:
        doc = get_document_or_404(req.path_params["document_id"])
        ext = ctx.repos.extractions.get_current_for_document(doc["id"])
        if ext is None:
            raise HTTPError(404, "No extraction for document")
        fields = ctx.repos.fields.list_for_extraction(ext["id"])
        return Response.json(serialize_extraction(ext, fields, s))

    @r.get("/api/extractions/{extraction_id}/status")
    async def extraction_status(req: Request, bg: BackgroundTasks) -> Response:
        ext = get_extraction_or_404(req.path_params["extraction_id"])
        return Response.json(
            {
                "extraction_id": ext["id"],
                "document_id": ext["document_id"],
                "status": ext["status"],
                "total_fields": ext.get("total_fields", 0),
                "error_message": ext.get("error_message"),
            }
        )

    @r.patch("/api/extractions/{extraction_id}/fields/{field_id}")
    async def update_field(req: Request, bg: BackgroundTasks) -> Response:
        ext = get_extraction_or_404(req.path_params["extraction_id"])
        check_not_finalized(ext)
        body = req.json() or {}
        if "field_value" not in body and "is_valid" not in body:
            raise HTTPError(422, "field_value or is_valid is required")
        field = ctx.repos.fields.get(req.path_params["field_id"])
        if field is None or field["extraction_id"] != ext["id"]:
            raise HTTPError(404, "Field not found")
        updated = field
        if "field_value" in body:
            updated = ctx.repos.fields.update_value(
                field["id"],
                body["field_value"],
                edit_type=body.get("edit_type", "manual"),
                edited_by=body.get("edited_by"),
            )
        if "is_valid" in body:
            # reviewer verdict checkbox (reference premium_fields.py valid
            # checkboxes): a human mark overrides the automatic validator
            ok = bool(body["is_valid"])
            ctx.repos.fields.bulk_update_validation(
                {field["id"]: (ok, "reviewer verified" if ok
                               else "reviewer rejected", not ok)}
            )
            updated = ctx.repos.fields.get(field["id"])
        ctx.repos.extractions.update_stats(ext["id"], s)
        return Response.json(serialize_field(updated, s))

    @r.post("/api/extractions/{extraction_id}/fields")
    async def add_field(req: Request, bg: BackgroundTasks) -> Response:
        """Manually add a field the extractor missed (reference frontend
        add-new-field form, dropdown_fields.py:181-231)."""
        ext = get_extraction_or_404(req.path_params["extraction_id"])
        check_not_finalized(ext)
        body = req.json() or {}
        key = (body.get("field_key") or "").strip()
        if not key:
            raise HTTPError(422, "field_key is required")
        field = ctx.repos.fields.create(
            extraction_id=ext["id"],
            sort_order=ctx.repos.fields.count(
                "extraction_id = ?", (ext["id"],)
            ),
            field_key=key,
            field_value=body.get("field_value", ""),
            field_type=body.get("field_type", "text"),
            confidence=1.0,  # human-entered
            is_edited=True,
            page_number=int(body.get("page_number") or 1),
        )
        ctx.repos.extractions.update_stats(ext["id"], s)
        return Response.json(serialize_field(field, s), status=201)

    @r.post("/api/extractions/{extraction_id}/chat")
    async def extraction_chat(req: Request, bg: BackgroundTasks) -> Response:
        """Multi-turn grounded Q&A over one extraction (reference:
        gemini_service.py:584-604 create_extraction_chat — service-only
        there; exposed as a route here). Stateless per request: pass prior
        turns in `history` ([{role, text}, ...]) for multi-turn context."""
        ext = get_extraction_or_404(req.path_params["extraction_id"])
        body = req.json() or {}
        message = (body.get("message") or "").strip()
        if not message:
            raise HTTPError(422, "message is required")
        from ocr_system_tpu_torch.extract.chat import ChatTurn, ExtractionChat

        fields = ctx.repos.fields.list_for_extraction(ext["id"])
        layout = ext.get("layout_data") or []
        chat = ExtractionChat(
            fields=fields,
            ocr_text=ext.get("raw_ocr_markdown") or "",
            layout_boxes=layout if isinstance(layout, list) else [],
            history=[
                ChatTurn(
                    t.get("role", "user"), t.get("text", ""),
                    [str(k) for k in (t.get("fields") or [])],
                )
                for t in (body.get("history") or [])
                if isinstance(t, dict)
            ],
        )
        out = chat.send(message)
        return Response.json(
            {
                "extraction_id": ext["id"],
                "reply": out["reply"],
                "matched_fields": out["matched_fields"],
                # round-trip per-turn field refs: follow-up pronouns
                # ("and its confidence?") resolve against them server-side
                "history": [
                    {"role": t.role, "text": t.text, "fields": t.fields}
                    for t in chat.history
                ],
            }
        )

    @r.post("/api/extractions/{extraction_id}/validate")
    async def validate_extraction(req: Request, bg: BackgroundTasks) -> Response:
        ext = get_extraction_or_404(req.path_params["extraction_id"])
        fields = ctx.repos.fields.list_for_extraction(ext["id"])
        report = ctx.validation.validate_fields(
            [
                {
                    "key": f["id"],
                    "value": f["field_value"],
                    "field_type": f["field_type"],
                    "confidence": f["confidence"],
                }
                for f in fields
            ]
        )
        ctx.repos.fields.bulk_update_validation(
            {
                fid: (res.is_valid, res.message, res.needs_review)
                for fid, res in report.results.items()
            }
        )
        return Response.json(
            {
                "extraction_id": ext["id"],
                "total_fields": report.total_fields,
                "valid_fields": report.valid_fields,
                "invalid_fields": report.invalid_fields,
                "needs_review": report.needs_review,
                "is_valid": report.is_valid,
            }
        )

    @r.post("/api/extractions/{extraction_id}/finalize")
    async def finalize_extraction(req: Request, bg: BackgroundTasks) -> Response:
        ext = get_extraction_or_404(req.path_params["extraction_id"])
        check_not_finalized(ext)
        body = req.json() or {}
        if body.get("confirm") is not True:
            raise HTTPError(422, "confirm=true is required to finalize")
        fields = ctx.repos.fields.list_for_extraction(ext["id"])
        ok, problems = ctx.validation.validate_before_finalization(
            [
                {
                    "key": f["field_key"],
                    "value": f["field_value"],
                    "field_type": f["field_type"],
                    "confidence": f["confidence"],
                }
                for f in fields
            ]
        )
        if not ok and not body.get("force", False):
            raise HTTPError(409, "Validation failed: " + "; ".join(problems[:5]))
        out = ctx.repos.extractions.finalize(ext["id"])
        return Response.json(serialize_extraction_summary(out))

    @r.delete("/api/extractions/{extraction_id}")
    async def delete_extraction(req: Request, bg: BackgroundTasks) -> Response:
        ext = get_extraction_or_404(req.path_params["extraction_id"])
        check_not_finalized(ext)
        with ctx.db.session() as conn:
            conn.execute(
                "DELETE FROM field_edits WHERE extraction_id = ?", (ext["id"],)
            )
            conn.execute(
                "DELETE FROM extracted_fields WHERE extraction_id = ?", (ext["id"],)
            )
            # audit logs survive the extraction; detach the reference
            conn.execute(
                "UPDATE processing_logs SET extraction_id = NULL "
                "WHERE extraction_id = ?",
                (ext["id"],),
            )
            conn.execute("DELETE FROM extractions WHERE id = ?", (ext["id"],))
            if ext.get("is_current"):
                # promote the highest remaining version so GET
                # /api/extractions/document/{id} keeps serving older
                # versions; reset document status if none remain
                row = conn.execute(
                    "SELECT id FROM extractions WHERE document_id = ? "
                    "ORDER BY version DESC LIMIT 1",
                    (ext["document_id"],),
                ).fetchone()
                if row is not None:
                    conn.execute(
                        "UPDATE extractions SET is_current = 1 WHERE id = ?",
                        (row["id"],),
                    )
                else:
                    conn.execute(
                        "UPDATE documents SET status = 'pending' WHERE id = ?",
                        (ext["document_id"],),
                    )
        return Response.json({"detail": "Extraction deleted", "id": ext["id"]})

    # ---- exports ----

    @r.post("/api/exports")
    async def create_export(req: Request, bg: BackgroundTasks) -> Response:
        body = req.json() or {}
        if "extraction_id" not in body or "format" not in body:
            raise HTTPError(422, "extraction_id and format are required")
        try:
            fmt = ExportFormat(body["format"])
        except ValueError:
            raise HTTPError(422, f"Unknown format {body['format']!r}")
        get_extraction_or_404(body["extraction_id"])
        result = ctx.exports.export_extraction(
            body["extraction_id"], fmt,
            validate_first=bool(body.get("validate_first", False)),
        )
        if not result.success:
            raise HTTPError(409, result.error or "Export failed")
        from uuid import uuid4

        export_id = str(uuid4())
        record = {
            "id": export_id,
            "extraction_id": body["extraction_id"],
            "format": fmt.value,
            "filename": result.filename,
            "file_path": result.file_path,
            "size_bytes": result.size_bytes,
            "status": "completed",
            "created_at": datetime.now(timezone.utc).isoformat(),
        }
        ctx.export_records[export_id] = record
        return Response.json(record, status=201)

    @r.get("/api/exports/extraction/{extraction_id}/{fmt}")
    async def quick_export(req: Request, bg: BackgroundTasks) -> Response:
        """Quick path: render + return the file directly (exports.py:356-441)."""
        get_extraction_or_404(req.path_params["extraction_id"])
        try:
            fmt = ExportFormat(req.path_params["fmt"])
        except ValueError:
            raise HTTPError(422, f"Unknown format {req.path_params['fmt']!r}")
        result = ctx.exports.export_extraction(req.path_params["extraction_id"], fmt)
        if not result.success:
            raise HTTPError(409, result.error or "Export failed")
        return Response.file(
            result.file_path, CONTENT_TYPES[fmt], filename=result.filename
        )

    @r.get("/api/exports/{export_id}")
    async def get_export(req: Request, bg: BackgroundTasks) -> Response:
        rec = ctx.export_records.get(req.path_params["export_id"])
        if rec is None:
            raise HTTPError(404, "Export not found")
        return Response.json(rec)

    @r.get("/api/exports/{export_id}/download")
    async def download_export(req: Request, bg: BackgroundTasks) -> Response:
        rec = ctx.export_records.get(req.path_params["export_id"])
        if rec is None:
            raise HTTPError(404, "Export not found")
        fmt = ExportFormat(rec["format"])
        return Response.file(
            rec["file_path"], CONTENT_TYPES[fmt], filename=rec["filename"]
        )

    # ---- templates ----

    @r.get("/api/templates")
    async def list_templates(req: Request, bg: BackgroundTasks) -> Response:
        return Response.json({"items": ctx.repos.templates.list_active()})

    # ---- stats ----

    @r.get("/api/stats/dashboard")
    async def stats_dashboard(req: Request, bg: BackgroundTasks) -> Response:
        """Rollup (reference stats.py:112-257)."""
        repos = ctx.repos
        status_counts = repos.documents.status_counts()
        with ctx.db.session() as conn:
            ext_row = conn.execute(
                "SELECT COUNT(*) n, AVG(avg_confidence) ac, "
                "AVG(processing_time_ms) apt, AVG(ocr_time_ms) aot, "
                "AVG(llm_time_ms) alt FROM extractions WHERE status='completed'"
            ).fetchone()
            field_row = conn.execute(
                "SELECT COUNT(*) n, AVG(confidence) ac, "
                "SUM(is_edited) edited FROM extracted_fields"
            ).fetchone()
            form_rows = conn.execute(
                "SELECT form_type, COUNT(*) c FROM extractions "
                "WHERE form_type IS NOT NULL AND is_current=1 GROUP BY form_type"
            ).fetchall()
        total_fields = field_row["n"] or 0
        return Response.json(
            {
                "documents": {
                    "total": sum(status_counts.values()),
                    "by_status": status_counts,
                },
                "extractions": {
                    "completed": ext_row["n"] or 0,
                    "avg_confidence": ext_row["ac"],
                    "by_form_type": {r["form_type"]: r["c"] for r in form_rows},
                },
                "processing": {
                    "avg_total_ms": ext_row["apt"],
                    "avg_ocr_ms": ext_row["aot"],
                    "avg_extraction_ms": ext_row["alt"],
                },
                "fields": {
                    "total": total_fields,
                    "avg_confidence": field_row["ac"],
                    "edited": field_row["edited"] or 0,
                    "edit_rate": (
                        (field_row["edited"] or 0) / total_fields
                        if total_fields else 0.0
                    ),
                },
            }
        )

    @r.get("/api/stats/documents")
    async def stats_documents(req: Request, bg: BackgroundTasks) -> Response:
        days = int(req.query.get("days", "30") or 30)
        cutoff = (
            datetime.now(timezone.utc) - timedelta(days=days)
        ).isoformat()
        with ctx.db.session() as conn:
            rows = conn.execute(
                "SELECT substr(created_at, 1, 10) day, COUNT(*) c FROM documents "
                "WHERE created_at >= ? AND is_deleted=0 GROUP BY day ORDER BY day",
                (cutoff,),
            ).fetchall()
            types = conn.execute(
                "SELECT file_type, COUNT(*) c FROM documents "
                "WHERE is_deleted=0 GROUP BY file_type"
            ).fetchall()
        return Response.json(
            {
                "by_day": {r["day"]: r["c"] for r in rows},
                "by_file_type": {r["file_type"]: r["c"] for r in types},
                "by_status": ctx.repos.documents.status_counts(),
            }
        )

    @r.get("/api/stats/extractions")
    async def stats_extractions(req: Request, bg: BackgroundTasks) -> Response:
        with ctx.db.session() as conn:
            dist = conn.execute(
                "SELECT CASE WHEN confidence >= ? THEN 'high' "
                "WHEN confidence >= ? THEN 'medium' ELSE 'low' END tier, "
                "COUNT(*) c FROM extracted_fields GROUP BY tier",
                (s.confidence_threshold_high, s.confidence_threshold_medium),
            ).fetchall()
            types = conn.execute(
                "SELECT field_type, COUNT(*) c, AVG(confidence) ac "
                "FROM extracted_fields GROUP BY field_type"
            ).fetchall()
        return Response.json(
            {
                "confidence_distribution": {r["tier"]: r["c"] for r in dist},
                "by_field_type": {
                    r["field_type"]: {"count": r["c"], "avg_confidence": r["ac"]}
                    for r in types
                },
            }
        )

    @r.get("/api/stats/processing")
    async def stats_processing(req: Request, bg: BackgroundTasks) -> Response:
        """Per-step success/fail matrix + timings (reference stats.py:444-507)."""
        stats = ctx.repos.logs.step_stats()
        steps: dict[str, dict] = {}
        for row in stats:
            entry = steps.setdefault(
                row["step"],
                {"completed": 0, "failed": 0, "started": 0,
                 "duration_ms": {"min": None, "avg": None, "max": None}},
            )
            entry[row["status"]] = row["c"]
            if row["status"] == "completed":
                entry["duration_ms"] = {
                    "min": row["mn"], "avg": row["av"], "max": row["mx"],
                }
        return Response.json({"steps": steps})

    @r.get("/api/stats/devices")
    async def stats_devices(req: Request, bg: BackgroundTasks) -> Response:
        """The CUDA devices and their memory (no reference analog — the
        cloud engines hid the hardware)."""
        from ocr_system_tpu_torch.utils.profiler import device_memory_stats

        try:
            devices = device_memory_stats()
        except Exception as e:
            devices = [{"error": str(e)}]
        return Response.json({"devices": devices})

    @r.get("/api/stats/overview")
    async def stats_overview(req: Request, bg: BackgroundTasks) -> Response:
        with ctx.db.session() as conn:
            docs = conn.execute(
                "SELECT COUNT(*) c FROM documents WHERE is_deleted=0"
            ).fetchone()["c"]
            exts = conn.execute("SELECT COUNT(*) c FROM extractions").fetchone()["c"]
            fields = conn.execute(
                "SELECT COUNT(*) c FROM extracted_fields"
            ).fetchone()["c"]
            edits = conn.execute("SELECT COUNT(*) c FROM field_edits").fetchone()["c"]
        try:
            engine_status = ctx.orchestrator.engine.get_status()
        except Exception as e:
            engine_status = {"available": False, "error": str(e)}
        return Response.json(
            {
                "totals": {
                    "documents": docs,
                    "extractions": exts,
                    "fields": fields,
                    "edits": edits,
                },
                "engine": engine_status,
                "version": __version__,
                "uptime_s": round(time.time() - ctx.started_at, 1),
            }
        )

    return app


def main() -> None:
    logging.basicConfig(level=get_settings().log_level)
    ctx = ApiContext()
    app = create_app(ctx)
    app.run(ctx.settings.host, ctx.settings.port)


if __name__ == "__main__":
    main()
