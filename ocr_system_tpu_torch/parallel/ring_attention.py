"""Long documents (port of ocr_system_tpu/parallel/ring_attention.py, its
host half): the per-chunk extraction results of a document longer than
one window, map-reduced into one. Ring attention itself (sequence-parallel
exact attention over a mesh) is not ported yet."""

from __future__ import annotations

from ocr_system_tpu_torch.extract.types import ExtractionResult


def chunked_extract_merge(chunk_results: list[ExtractionResult]) -> ExtractionResult:
    """The pragmatic first tier for long documents (SURVEY §5.7): per-chunk
    extraction results map-reduced into one ExtractionResult. Earlier chunks
    win key conflicts (reading order); confidences carry through."""
    merged = ExtractionResult()
    seen: set[tuple[str, str]] = set()
    for r in chunk_results:
        if not r.success:
            continue
        for f in r.fields:
            key = f.field_key.strip().lower()
            # keyed fields dedup by key (earlier chunk wins); orphan values
            # (empty key) dedup by value — chunk OVERLAP re-decodes the tail
            # of each chunk, which would otherwise duplicate them
            sig = (key, "" if key else f.field_value.strip().lower())
            if sig in seen:
                continue
            seen.add(sig)
            merged.fields.append(f)
        merged.token_count += r.token_count
        merged.processing_time_ms += r.processing_time_ms
        if merged.form_type == "Unknown" and r.form_type != "Unknown":
            merged.form_type = r.form_type
        if merged.language == "en" and r.language != "en":
            merged.language = r.language
    merged.success = bool(chunk_results) and any(r.success for r in chunk_results)
    return merged
