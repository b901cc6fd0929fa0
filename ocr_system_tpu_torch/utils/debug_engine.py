"""Manual OCR engine debug harness (port of scripts/debug_engine.py: the
same options and JSON report, and ``--device``).

Runs one image/PDF through the engine and dumps the layout-box structure
(the golden-fixture shape of azure_debug_output.json).

    python -m ocr_system_tpu_torch.utils.debug_engine path/to/image.png \\
        [--engine fake] [--out out.json] [--device cpu]

The engine is ``get_engine`` of the settings from the environment
(``OCR_ENGINE`` and the rest), on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("path")
    p.add_argument("--engine", default=None, help="jax | classical | hybrid | fake")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from ocr_system_tpu_torch.core.config import get_settings

    settings = get_settings()
    if args.engine:
        settings = settings.model_copy(update={"ocr_engine": args.engine})

    from ocr_system_tpu_torch.engine.pipeline import get_engine

    engine = get_engine(settings, device=args.device)
    data = Path(args.path).read_bytes()
    result = engine.process_document(data, Path(args.path).name)

    boxes = result.combined_layout_boxes
    by_type: dict[str, int] = {}
    for b in boxes:
        by_type[b["type"]] = by_type.get(b["type"], 0) + 1
    report = {
        "success": result.success,
        "error": result.error,
        "total_pages": result.total_pages,
        "processing_time_ms": round(result.processing_time_ms, 1),
        "combined_layout_boxes_count": len(boxes),
        "boxes_by_type": by_type,
        "combined_layout_boxes_sample": boxes[:10],
        "combined_markdown": result.combined_markdown[:2000],
        "pages": [
            {
                "page_number": pg.page_number,
                "layout_boxes_count": len(pg.layout_boxes),
                "has_processed_image": pg.processed_image is not None,
                "page_width": pg.page_width,
                "page_height": pg.page_height,
            }
            for pg in result.pages
        ],
    }
    text = json.dumps(report, indent=2, ensure_ascii=False, default=str)
    if args.out:
        Path(args.out).write_text(text)
        print(f"wrote {args.out}")
    else:
        print(text)


if __name__ == "__main__":
    main()
