"""Export service: Excel / JSON / CSV / PDF, single + bulk.

Port of ``ocr_system_tpu/service/export.py``: the same code, on the port's modules.

Parity target (backend/services/export_service.py): styled Excel with
confidence-colored cells and a metadata sheet (:198-306), structured JSON
(:309-372), flat CSV (:375-411), PDF report with confidence-colored rows
(:414-554), optional validation gate (:694-710), bulk export — Excel
sheet-per-extraction + summary sheet, JSON array, concatenated CSV
(:761-993). Writers are the framework's own stdlib xlsx/pdf modules.
"""

from __future__ import annotations

import csv
import io
import json
import time
from dataclasses import dataclass
from enum import Enum
from pathlib import Path

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.db.connection import Database, get_database
from ocr_system_tpu_torch.db.crud import Repositories
from ocr_system_tpu_torch.service.validation import ValidationService, confidence_level
from ocr_system_tpu_torch.utils.file_manager import FileManager
from ocr_system_tpu_torch.utils.pdf import A4, PDFDocument
from ocr_system_tpu_torch.utils.xlsx import Workbook


class ExportFormat(str, Enum):
    EXCEL = "excel"
    JSON = "json"
    CSV = "csv"
    PDF = "pdf"


CONTENT_TYPES = {
    ExportFormat.EXCEL: "application/vnd.openxmlformats-officedocument.spreadsheetml.sheet",
    ExportFormat.JSON: "application/json",
    ExportFormat.CSV: "text/csv",
    ExportFormat.PDF: "application/pdf",
}
EXTENSIONS = {
    ExportFormat.EXCEL: "xlsx",
    ExportFormat.JSON: "json",
    ExportFormat.CSV: "csv",
    ExportFormat.PDF: "pdf",
}


@dataclass
class ExportResult:
    """Reference result dataclasses (export_service.py:82-160)."""

    success: bool
    file_path: str | None = None
    filename: str | None = None
    format: str = ""
    size_bytes: int = 0
    error: str | None = None


class ExportError(RuntimeError):
    pass


def _tier_style(conf: float, s: Settings) -> int:
    if conf >= s.confidence_threshold_high:
        return Workbook.STYLE_GREEN
    if conf >= s.confidence_threshold_medium:
        return Workbook.STYLE_YELLOW
    return Workbook.STYLE_RED


def _tier_color(conf: float, s: Settings) -> tuple[float, float, float]:
    if conf >= s.confidence_threshold_high:
        return (0.78, 0.94, 0.81)
    if conf >= s.confidence_threshold_medium:
        return (1.0, 0.92, 0.61)
    return (1.0, 0.78, 0.81)


class ExportService:
    def __init__(self, settings: Settings | None = None, db: Database | None = None):
        self.settings = settings or get_settings()
        self.repos = Repositories(db or get_database())
        self.files = FileManager(self.settings)
        self.validation = ValidationService(self.settings)

    # ---- data fetch (reference _fetch_extraction_data :614-666) ----

    def fetch_extraction_data(self, extraction_id: str) -> dict:
        ext = self.repos.extractions.get(extraction_id)
        if ext is None:
            raise ExportError(f"extraction {extraction_id} not found")
        doc = self.repos.documents.get(ext["document_id"]) or {}
        fields = self.repos.fields.list_for_extraction(extraction_id)
        return {"extraction": ext, "document": doc, "fields": fields}

    # ---- single export (reference export_extraction :668-759) ----

    def export_extraction(
        self,
        extraction_id: str,
        fmt: ExportFormat | str,
        validate_first: bool = False,
    ) -> ExportResult:
        fmt = ExportFormat(fmt)
        try:
            data = self.fetch_extraction_data(extraction_id)
            if validate_first:
                ok, problems = self.validation.validate_before_finalization(
                    [
                        {
                            "key": f["field_key"],
                            "value": f["field_value"],
                            "field_type": f["field_type"],
                            "confidence": f["confidence"],
                        }
                        for f in data["fields"]
                    ]
                )
                if not ok:
                    return ExportResult(
                        success=False, format=fmt.value,
                        error="Validation failed: " + "; ".join(problems[:5]),
                    )
            payload = self.render(data, fmt)
            name = self._filename(data, fmt)
            path = self.files.save_export(payload, name)
            self.repos.logs.log_step(
                data["document"].get("id"), "export", "completed",
                extraction_id=extraction_id, details={"format": fmt.value},
            )
            return ExportResult(
                success=True, file_path=str(path), filename=name,
                format=fmt.value, size_bytes=len(payload),
            )
        except ExportError as e:
            return ExportResult(success=False, format=fmt.value, error=str(e))

    def render(self, data: dict, fmt: ExportFormat) -> bytes:
        if fmt == ExportFormat.EXCEL:
            return self._render_excel(data)
        if fmt == ExportFormat.JSON:
            return self._render_json(data)
        if fmt == ExportFormat.CSV:
            return self._render_csv(data)
        return self._render_pdf(data)

    def _filename(self, data: dict, fmt: ExportFormat) -> str:
        base = Path(data["document"].get("original_filename", "extraction")).stem
        ts = time.strftime("%Y%m%d_%H%M%S")
        return f"{base}_export_{ts}.{EXTENSIONS[fmt]}"

    # ---- renderers ----

    def _render_excel(self, data: dict) -> bytes:
        wb = Workbook()
        sheet = wb.add_sheet("Extracted Fields")
        self._fields_sheet(sheet, data)
        meta = wb.add_sheet("Metadata")
        self._metadata_sheet(meta, data)
        return wb.to_bytes()

    def _fields_sheet(self, sheet, data: dict) -> None:
        s = self.settings
        sheet.col_widths = {0: 30, 1: 45, 2: 12, 3: 12, 4: 14, 5: 10}
        hdr = Workbook.STYLE_HEADER
        sheet.add_row(
            ["Field", "Value", "Type", "Confidence", "Level", "Valid"],
            [hdr] * 6,
        )
        for f in data["fields"]:
            conf = f["confidence"] or 0.0
            style = _tier_style(conf, s)
            sheet.add_row(
                [
                    f["field_key"],
                    f["field_value"],
                    f["field_type"],
                    round(conf, 3),
                    confidence_level(conf, s),
                    "" if f["is_valid"] is None else ("yes" if f["is_valid"] else "no"),
                ],
                [0, 0, 0, style, style, 0],
            )

    def _metadata_sheet(self, sheet, data: dict) -> None:
        ext, doc = data["extraction"], data["document"]
        hdr = Workbook.STYLE_HEADER
        sheet.col_widths = {0: 26, 1: 50}
        sheet.add_row(["Property", "Value"], [hdr, hdr])
        for k, v in [
            ("Document", doc.get("original_filename")),
            ("Document ID", doc.get("id")),
            ("Extraction ID", ext["id"]),
            ("Version", ext["version"]),
            ("Form Type", ext.get("form_type")),
            ("Language", ext.get("language")),
            ("Model", ext.get("model_name")),
            ("Total Fields", ext.get("total_fields")),
            ("Avg Confidence", ext.get("avg_confidence")),
            ("OCR Time (ms)", ext.get("ocr_time_ms")),
            ("Extraction Time (ms)", ext.get("llm_time_ms")),
            ("Created", ext.get("created_at")),
            ("Finalized", bool(ext.get("is_finalized"))),
        ]:
            sheet.add_row([k, "" if v is None else v])

    def _render_json(self, data: dict) -> bytes:
        ext, doc = data["extraction"], data["document"]
        out = {
            "document": {
                "id": doc.get("id"),
                "filename": doc.get("original_filename"),
                "status": doc.get("status"),
            },
            "extraction": {
                "id": ext["id"],
                "version": ext["version"],
                "form_type": ext.get("form_type"),
                "language": ext.get("language"),
                "total_fields": ext.get("total_fields"),
                "avg_confidence": ext.get("avg_confidence"),
                "is_finalized": bool(ext.get("is_finalized")),
                "created_at": ext.get("created_at"),
            },
            "fields": [
                {
                    "key": f["field_key"],
                    "value": f["field_value"],
                    "type": f["field_type"],
                    "confidence": f["confidence"],
                    "confidence_level": confidence_level(
                        f["confidence"] or 0.0, self.settings
                    ),
                    "is_valid": f["is_valid"],
                    "needs_review": f["needs_review"],
                    "page_number": f["page_number"],
                }
                for f in data["fields"]
            ],
        }
        return json.dumps(out, indent=2, ensure_ascii=False).encode("utf-8")

    def _render_csv(self, data: dict) -> bytes:
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(
            ["field_key", "field_value", "field_type", "confidence",
             "confidence_level", "is_valid", "needs_review", "page_number"]
        )
        for f in data["fields"]:
            w.writerow(
                [
                    f["field_key"], f["field_value"], f["field_type"],
                    f["confidence"],
                    confidence_level(f["confidence"] or 0.0, self.settings),
                    f["is_valid"], f["needs_review"], f["page_number"],
                ]
            )
        return buf.getvalue().encode("utf-8")

    def _render_pdf(self, data: dict) -> bytes:
        s = self.settings
        doc_pdf = PDFDocument()
        ext, doc = data["extraction"], data["document"]
        page = doc_pdf.add_page()
        y = 50.0
        page.text(40, y, "Extraction Report", size=18, bold=True)
        y += 26
        page.text(40, y, f"Document: {doc.get('original_filename', '')}", size=10)
        y += 14
        page.text(
            40, y,
            f"Form type: {ext.get('form_type') or 'Unknown'}   "
            f"Version: {ext['version']}   Fields: {ext.get('total_fields', 0)}",
            size=10,
        )
        y += 22
        # table header
        page.rect(40, y - 10, A4[0] - 80, 16, (0.27, 0.45, 0.77))
        page.text(44, y + 2, "Field", size=9, bold=True, color=(1, 1, 1))
        page.text(220, y + 2, "Value", size=9, bold=True, color=(1, 1, 1))
        page.text(470, y + 2, "Conf", size=9, bold=True, color=(1, 1, 1))
        y += 18
        for f in data["fields"]:
            if y > A4[1] - 50:
                page = doc_pdf.add_page()
                y = 50.0
            conf = f["confidence"] or 0.0
            page.rect(40, y - 10, A4[0] - 80, 14, _tier_color(conf, s))
            page.text(44, y + 1, str(f["field_key"])[:34], size=9)
            page.text(220, y + 1, str(f["field_value"] or "")[:52], size=9)
            page.text(470, y + 1, f"{conf:.2f}", size=9)
            y += 15
        return doc_pdf.to_bytes()

    # ---- bulk (reference bulk_export :761-844) ----

    def bulk_export(
        self, extraction_ids: list[str], fmt: ExportFormat | str
    ) -> ExportResult:
        fmt = ExportFormat(fmt)
        try:
            datas = [self.fetch_extraction_data(eid) for eid in extraction_ids]
        except ExportError as e:
            return ExportResult(success=False, format=fmt.value, error=str(e))
        if fmt == ExportFormat.EXCEL:
            payload = self._bulk_excel(datas)
        elif fmt == ExportFormat.JSON:
            payload = json.dumps(
                [json.loads(self._render_json(d)) for d in datas],
                indent=2, ensure_ascii=False,
            ).encode()
        elif fmt == ExportFormat.CSV:
            parts = []
            for i, d in enumerate(datas):
                text = self._render_csv(d).decode()
                if i > 0:  # drop repeated header
                    text = "\n".join(text.splitlines()[1:]) + "\n"
                doc_id = d["document"].get("id", "")
                parts.append(text.replace("\r\n", "\n"))
            payload = "".join(parts).encode()
        else:
            return ExportResult(
                success=False, format=fmt.value,
                error="bulk PDF export not supported",
            )
        ts = time.strftime("%Y%m%d_%H%M%S")
        name = f"bulk_export_{ts}.{EXTENSIONS[fmt]}"
        path = self.files.save_export(payload, name)
        return ExportResult(
            success=True, file_path=str(path), filename=name,
            format=fmt.value, size_bytes=len(payload),
        )

    def _bulk_excel(self, datas: list[dict]) -> bytes:
        wb = Workbook()
        summary = wb.add_sheet("Summary")
        hdr = Workbook.STYLE_HEADER
        summary.col_widths = {0: 35, 1: 16, 2: 12, 3: 14}
        summary.add_row(["Document", "Form Type", "Fields", "Avg Conf"], [hdr] * 4)
        for d in datas:
            ext, doc = d["extraction"], d["document"]
            summary.add_row(
                [
                    doc.get("original_filename", ""),
                    ext.get("form_type") or "",
                    ext.get("total_fields", 0),
                    round(ext.get("avg_confidence") or 0.0, 3),
                ]
            )
        for d in datas:
            name = Path(d["document"].get("original_filename", "doc")).stem
            sheet = wb.add_sheet(name)
            self._fields_sheet(sheet, d)
        return wb.to_bytes()
