"""Response serializers — the REST contract shapes.

Port of ``ocr_system_tpu/api/serializers.py``: the same code, on the port's modules.

Mirror of the reference's Pydantic response models with computed fields
(backend/schemas/document.py:183-311 human file size + status display;
backend/schemas/extraction.py:151-225 confidence level/percent/icon,
:317-419 extraction detail incl. layout_data / processed_image_paths /
page_dimensions + high/low-confidence counts). Implemented as plain
serializer functions over CRUD row dicts; the JSON shape is what clients
depend on and it matches field-for-field.
"""

from __future__ import annotations

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.service.validation import confidence_level

_STATUS_DISPLAY = {
    "pending": "Pending",
    "uploading": "Uploading",
    "processing": "Processing...",
    "completed": "Completed",
    "failed": "Failed",
}

_CONF_ICONS = {"high": "🟢", "medium": "🟡", "low": "🔴"}


def human_file_size(size: int | None) -> str:
    size = size or 0
    for unit in ("B", "KB", "MB", "GB"):
        if size < 1024 or unit == "GB":
            return f"{size:.1f} {unit}" if unit != "B" else f"{size} B"
        size /= 1024
    return f"{size:.1f} GB"


def serialize_document(doc: dict, extractions: list[dict] | None = None) -> dict:
    out = {
        "id": doc["id"],
        "filename": doc["filename"],
        "original_filename": doc["original_filename"],
        "file_size": doc["file_size"],
        "file_size_human": human_file_size(doc["file_size"]),
        "file_type": doc["file_type"],
        "status": doc["status"],
        "status_display": _STATUS_DISPLAY.get(doc["status"], doc["status"]),
        "error_message": doc.get("error_message"),
        "custom_metadata": doc.get("custom_metadata"),
        "created_at": doc["created_at"],
        "updated_at": doc["updated_at"],
        "processed_at": doc.get("processed_at"),
    }
    if extractions is not None:
        out["extractions"] = [serialize_extraction_summary(e) for e in extractions]
    return out


def serialize_field(f: dict, settings: Settings | None = None) -> dict:
    s = settings or get_settings()
    conf = f.get("confidence") or 0.0
    level = confidence_level(conf, s)
    return {
        "id": f["id"],
        "field_key": f["field_key"],
        "field_value": f["field_value"],
        "field_type": f["field_type"],
        "confidence": conf,
        "confidence_level": level,
        "confidence_percent": round(conf * 100, 1),
        "confidence_icon": _CONF_ICONS[level],
        "is_valid": f.get("is_valid"),
        "validation_message": f.get("validation_message"),
        "needs_review": f.get("needs_review", False),
        "is_edited": f.get("is_edited", False),
        "original_value": f.get("original_value"),
        "key_bbox": f.get("key_bbox"),
        "value_bbox": f.get("value_bbox"),
        "original_ocr_text": f.get("original_ocr_text"),
        "page_number": f.get("page_number", 1),
        "sort_order": f.get("sort_order", 0),
    }


def serialize_extraction_summary(e: dict) -> dict:
    return {
        "id": e["id"],
        "document_id": e["document_id"],
        "version": e["version"],
        "is_current": e.get("is_current", False),
        "status": e["status"],
        "form_type": e.get("form_type"),
        "language": e.get("language"),
        "total_fields": e.get("total_fields", 0),
        "avg_confidence": e.get("avg_confidence"),
        "is_finalized": e.get("is_finalized", False),
        "created_at": e["created_at"],
    }


def serialize_extraction(
    e: dict,
    fields: list[dict],
    settings: Settings | None = None,
    include_layout: bool = True,
) -> dict:
    """Full detail (reference extraction_to_response, extraction.py:162-214)."""
    s = settings or get_settings()
    out = serialize_extraction_summary(e)
    out.update(
        {
            "model_name": e.get("model_name"),
            "custom_prompt": e.get("custom_prompt"),
            "high_confidence_count": e.get("high_confidence_fields", 0),
            "low_confidence_count": e.get("low_confidence_fields", 0),
            "processing_time_ms": e.get("processing_time_ms"),
            "ocr_time_ms": e.get("ocr_time_ms"),
            "llm_time_ms": e.get("llm_time_ms"),
            "token_count": e.get("token_count"),
            "finalized_at": e.get("finalized_at"),
            "error_message": e.get("error_message"),
            "raw_ocr_markdown": e.get("raw_ocr_markdown"),
            "fields": [serialize_field(f, s) for f in fields],
        }
    )
    if include_layout:
        out["layout_data"] = e.get("layout_data")
        out["processed_image_paths"] = e.get("processed_image_paths")
        out["page_dimensions"] = e.get("page_dimensions")
    return out
