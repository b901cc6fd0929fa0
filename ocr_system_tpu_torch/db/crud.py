"""Repository layer over sqlite — same surface as the reference CRUD repos.

Port of ``ocr_system_tpu/db/crud.py``: the same code, on the port's modules.

Reference (backend/database/crud.py): BaseCRUD :42-155, DocumentCRUD
:162-307, ExtractionCRUD :314-446 (create_new_version :364-392, finalize
:394-404, update_stats :406-429), ExtractedFieldCRUD :453-594 (bulk_create
:472-493, update_value with audit :495-533, low-confidence :577-594),
FieldEditCRUD :601-645, FormTemplateCRUD :652-694, ProcessingLogCRUD
:707-755. Rows are returned as plain dicts with JSON columns decoded.
"""

from __future__ import annotations

import json
from typing import Any

from ocr_system_tpu_torch.db.connection import Database, new_id, utcnow

_JSON_COLS = {
    "custom_metadata", "raw_ocr_json", "layout_data", "processed_image_paths",
    "page_dimensions", "key_bbox", "value_bbox", "expected_fields",
    "validation_rules", "details",
}
_BOOL_COLS = {
    "is_deleted", "is_current", "is_finalized", "is_valid", "needs_review",
    "is_edited", "is_active",
}


def _decode(row) -> dict | None:
    if row is None:
        return None
    d = dict(row)
    for k in list(d):
        if k in _JSON_COLS and isinstance(d[k], str):
            try:
                d[k] = json.loads(d[k])
            except (ValueError, TypeError):
                pass
        elif k in _BOOL_COLS and d[k] is not None:
            d[k] = bool(d[k])
    return d


def _encode(values: dict) -> dict:
    out = {}
    for k, v in values.items():
        if k in _JSON_COLS and v is not None and not isinstance(v, str):
            out[k] = json.dumps(v, ensure_ascii=False)
        elif isinstance(v, bool):
            out[k] = int(v)
        else:
            out[k] = v
    return out


class BaseCRUD:
    table: str = ""

    def __init__(self, db: Database):
        self.db = db

    def create(self, **values) -> dict:
        values.setdefault("id", new_id())
        values.setdefault("created_at", utcnow())
        if "updated_at" not in values and self._has_updated_at():
            values["updated_at"] = values["created_at"]
        enc = _encode(values)
        cols = ", ".join(enc)
        ph = ", ".join("?" * len(enc))
        with self.db.session() as conn:
            conn.execute(
                f"INSERT INTO {self.table} ({cols}) VALUES ({ph})",
                list(enc.values()),
            )
        return self.get(values["id"])

    def get(self, id_: str) -> dict | None:
        with self.db.session() as conn:
            row = conn.execute(
                f"SELECT * FROM {self.table} WHERE id = ?", (id_,)
            ).fetchone()
        return _decode(row)

    def update(self, id_: str, **values) -> dict | None:
        if not values:
            return self.get(id_)
        if self._has_updated_at():
            values.setdefault("updated_at", utcnow())
        enc = _encode(values)
        sets = ", ".join(f"{k} = ?" for k in enc)
        with self.db.session() as conn:
            conn.execute(
                f"UPDATE {self.table} SET {sets} WHERE id = ?",
                [*enc.values(), id_],
            )
        return self.get(id_)

    def delete(self, id_: str) -> bool:
        with self.db.session() as conn:
            cur = conn.execute(f"DELETE FROM {self.table} WHERE id = ?", (id_,))
            return cur.rowcount > 0

    def count(self, where: str = "1=1", params: tuple = ()) -> int:
        with self.db.session() as conn:
            return conn.execute(
                f"SELECT COUNT(*) c FROM {self.table} WHERE {where}", params
            ).fetchone()["c"]

    def _has_updated_at(self) -> bool:
        return self.table not in ("field_edits", "processing_logs")


class DocumentCRUD(BaseCRUD):
    table = "documents"

    def get_active(self, id_: str) -> dict | None:
        d = self.get(id_)
        return d if d and not d["is_deleted"] else None

    def list(
        self,
        page: int = 1,
        page_size: int = 20,
        status: str | None = None,
        search: str | None = None,
    ) -> tuple[list[dict], int]:
        """Paginated list with search + status filter (reference
        documents API, crud.py:200-260)."""
        where, params = ["is_deleted = 0"], []
        if status:
            where.append("status = ?")
            params.append(status)
        if search:
            where.append("(original_filename LIKE ? OR filename LIKE ?)")
            params += [f"%{search}%", f"%{search}%"]
        w = " AND ".join(where)
        with self.db.session() as conn:
            total = conn.execute(
                f"SELECT COUNT(*) c FROM documents WHERE {w}", params
            ).fetchone()["c"]
            rows = conn.execute(
                f"SELECT * FROM documents WHERE {w} ORDER BY created_at DESC "
                f"LIMIT ? OFFSET ?",
                [*params, page_size, (page - 1) * page_size],
            ).fetchall()
        return [_decode(r) for r in rows], total

    def update_status(
        self, id_: str, status: str, error_message: str | None = None
    ) -> dict | None:
        values: dict[str, Any] = {"status": status}
        if error_message is not None:
            values["error_message"] = error_message
        if status == "completed":
            values["processed_at"] = utcnow()
        return self.update(id_, **values)

    def soft_delete(self, id_: str) -> bool:
        return self.update(id_, is_deleted=True) is not None

    def status_counts(self) -> dict[str, int]:
        with self.db.session() as conn:
            rows = conn.execute(
                "SELECT status, COUNT(*) c FROM documents "
                "WHERE is_deleted = 0 GROUP BY status"
            ).fetchall()
        return {r["status"]: r["c"] for r in rows}


class ExtractionCRUD(BaseCRUD):
    table = "extractions"

    def create_new_version(self, document_id: str, **values) -> dict:
        """Version bump + demote previous current (reference crud.py:364-392)."""
        with self.db.session() as conn:
            row = conn.execute(
                "SELECT COALESCE(MAX(version), 0) v FROM extractions "
                "WHERE document_id = ?",
                (document_id,),
            ).fetchone()
            next_version = row["v"] + 1
            conn.execute(
                "UPDATE extractions SET is_current = 0 WHERE document_id = ?",
                (document_id,),
            )
        return self.create(
            document_id=document_id,
            version=next_version,
            is_current=True,
            **values,
        )

    def get_current_for_document(self, document_id: str) -> dict | None:
        with self.db.session() as conn:
            row = conn.execute(
                "SELECT * FROM extractions WHERE document_id = ? AND "
                "is_current = 1 ORDER BY version DESC LIMIT 1",
                (document_id,),
            ).fetchone()
        return _decode(row)

    def list_for_document(self, document_id: str) -> list[dict]:
        with self.db.session() as conn:
            rows = conn.execute(
                "SELECT * FROM extractions WHERE document_id = ? "
                "ORDER BY version DESC",
                (document_id,),
            ).fetchall()
        return [_decode(r) for r in rows]

    def finalize(self, id_: str) -> dict | None:
        """Lock the record (reference crud.py:394-404)."""
        return self.update(id_, is_finalized=True, finalized_at=utcnow())

    def update_stats(self, id_: str, settings=None) -> dict | None:
        """Recompute field statistics (reference crud.py:406-429)."""
        from ocr_system_tpu_torch.core.config import get_settings

        s = settings or get_settings()
        with self.db.session() as conn:
            row = conn.execute(
                "SELECT COUNT(*) n, AVG(confidence) avg_c, "
                "SUM(CASE WHEN confidence >= ? THEN 1 ELSE 0 END) hi, "
                "SUM(CASE WHEN confidence < ? THEN 1 ELSE 0 END) lo "
                "FROM extracted_fields WHERE extraction_id = ?",
                (
                    s.confidence_threshold_high,
                    s.confidence_threshold_medium,
                    id_,
                ),
            ).fetchone()
        return self.update(
            id_,
            total_fields=row["n"] or 0,
            avg_confidence=row["avg_c"],
            high_confidence_fields=row["hi"] or 0,
            low_confidence_fields=row["lo"] or 0,
        )


class ExtractedFieldCRUD(BaseCRUD):
    table = "extracted_fields"

    def bulk_create(self, extraction_id: str, fields: list[dict]) -> list[dict]:
        """Insert fields with sequential sort_order (reference crud.py:472-493)."""
        created = []
        for i, f in enumerate(fields):
            created.append(
                self.create(extraction_id=extraction_id, sort_order=i, **f)
            )
        return created

    def list_for_extraction(self, extraction_id: str) -> list[dict]:
        with self.db.session() as conn:
            rows = conn.execute(
                "SELECT * FROM extracted_fields WHERE extraction_id = ? "
                "ORDER BY sort_order",
                (extraction_id,),
            ).fetchall()
        return [_decode(r) for r in rows]

    def update_value(
        self,
        field_id: str,
        new_value: str,
        edit_type: str = "manual",
        edited_by: str | None = None,
    ) -> dict | None:
        """Edit with original-value preservation + audit row
        (reference crud.py:495-533)."""
        field = self.get(field_id)
        if field is None:
            return None
        old_value = field["field_value"]
        values: dict[str, Any] = {"field_value": new_value, "is_edited": True}
        if not field["is_edited"]:
            values["original_value"] = old_value
        updated = self.update(field_id, **values)
        FieldEditCRUD(self.db).create(
            field_id=field_id,
            extraction_id=field["extraction_id"],
            old_value=old_value,
            new_value=new_value,
            edit_type=edit_type,
            edited_by=edited_by,
        )
        return updated

    def bulk_update_validation(
        self, results: dict[str, tuple[bool, str, bool]]
    ) -> None:
        """results: field_id -> (is_valid, message, needs_review)."""
        with self.db.session() as conn:
            for fid, (ok, msg, review) in results.items():
                conn.execute(
                    "UPDATE extracted_fields SET is_valid = ?, "
                    "validation_message = ?, needs_review = ?, updated_at = ? "
                    "WHERE id = ?",
                    (int(ok), msg, int(review), utcnow(), fid),
                )

    def low_confidence(
        self, extraction_id: str, threshold: float
    ) -> list[dict]:
        """Reference crud.py:577-594."""
        with self.db.session() as conn:
            rows = conn.execute(
                "SELECT * FROM extracted_fields WHERE extraction_id = ? AND "
                "confidence < ? ORDER BY confidence",
                (extraction_id, threshold),
            ).fetchall()
        return [_decode(r) for r in rows]


class FieldEditCRUD(BaseCRUD):
    table = "field_edits"

    def list_for_field(self, field_id: str) -> list[dict]:
        with self.db.session() as conn:
            rows = conn.execute(
                "SELECT * FROM field_edits WHERE field_id = ? "
                "ORDER BY created_at",
                (field_id,),
            ).fetchall()
        return [_decode(r) for r in rows]

    def count_for_extraction(self, extraction_id: str) -> int:
        return self.count("extraction_id = ?", (extraction_id,))


class FormTemplateCRUD(BaseCRUD):
    table = "form_templates"

    def get_by_name(self, name: str) -> dict | None:
        with self.db.session() as conn:
            row = conn.execute(
                "SELECT * FROM form_templates WHERE name = ? AND is_active = 1",
                (name,),
            ).fetchone()
        return _decode(row)

    def list_active(self) -> list[dict]:
        with self.db.session() as conn:
            rows = conn.execute(
                "SELECT * FROM form_templates WHERE is_active = 1 ORDER BY name"
            ).fetchall()
        return [_decode(r) for r in rows]

    def increment_usage(self, id_: str) -> None:
        with self.db.session() as conn:
            conn.execute(
                "UPDATE form_templates SET usage_count = usage_count + 1, "
                "updated_at = ? WHERE id = ?",
                (utcnow(), id_),
            )


class ProcessingLogCRUD(BaseCRUD):
    table = "processing_logs"

    def log_step(
        self,
        document_id: str | None,
        step: str,
        status: str,
        message: str | None = None,
        extraction_id: str | None = None,
        details: dict | None = None,
        duration_ms: int | None = None,
    ) -> dict:
        """Reference log_step (crud.py:707-728)."""
        return self.create(
            document_id=document_id,
            extraction_id=extraction_id,
            step=step,
            status=status,
            message=message,
            details=details,
            duration_ms=duration_ms,
        )

    def list_for_document(self, document_id: str) -> list[dict]:
        with self.db.session() as conn:
            rows = conn.execute(
                "SELECT * FROM processing_logs WHERE document_id = ? "
                "ORDER BY created_at",
                (document_id,),
            ).fetchall()
        return [_decode(r) for r in rows]

    def failed_steps(self, limit: int = 50) -> list[dict]:
        """Reference get_failed_steps (crud.py:743-755)."""
        with self.db.session() as conn:
            rows = conn.execute(
                "SELECT * FROM processing_logs WHERE status = 'failed' "
                "ORDER BY created_at DESC LIMIT ?",
                (limit,),
            ).fetchall()
        return [_decode(r) for r in rows]

    def step_stats(self) -> list[dict]:
        """Per-step success/fail counts + duration min/avg/max (feeds the
        /stats/processing endpoint, reference stats.py:444-507)."""
        with self.db.session() as conn:
            rows = conn.execute(
                "SELECT step, status, COUNT(*) c, MIN(duration_ms) mn, "
                "AVG(duration_ms) av, MAX(duration_ms) mx "
                "FROM processing_logs GROUP BY step, status"
            ).fetchall()
        return [dict(r) for r in rows]


class Repositories:
    """One object bundling all repos over a Database (the reference exposes
    module-level singletons, crud.py:762-767; bundling keeps tests isolated)."""

    def __init__(self, db: Database):
        self.db = db
        self.documents = DocumentCRUD(db)
        self.extractions = ExtractionCRUD(db)
        self.fields = ExtractedFieldCRUD(db)
        self.edits = FieldEditCRUD(db)
        self.templates = FormTemplateCRUD(db)
        self.logs = ProcessingLogCRUD(db)


DEFAULT_TEMPLATES = [
    {
        "name": "General Form",
        "description": "Extract all visible key-value pairs",
        "expected_fields": [],
    },
    {
        "name": "Invoice",
        "description": "Invoice field extraction",
        "expected_fields": [
            {"name": "Invoice Number", "field_type": "text"},
            {"name": "Date", "field_type": "date"},
            {"name": "Bill To", "field_type": "name"},
            {"name": "Total Amount", "field_type": "currency"},
            {"name": "Due Date", "field_type": "date"},
        ],
    },
    {
        "name": "Application Form",
        "description": "Application form extraction",
        "expected_fields": [
            {"name": "Full Name", "field_type": "name"},
            {"name": "Date of Birth", "field_type": "date"},
            {"name": "Email", "field_type": "email"},
            {"name": "Phone", "field_type": "phone"},
            {"name": "Address", "field_type": "address"},
            {"name": "Signature", "field_type": "signature"},
        ],
    },
]


def seed_templates(repos: Repositories) -> int:
    """Seed default templates (reference scripts/init_db.py:148-208)."""
    n = 0
    for t in DEFAULT_TEMPLATES:
        if repos.templates.get_by_name(t["name"]) is None:
            repos.templates.create(**t)
            n += 1
    return n
