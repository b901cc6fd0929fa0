"""Demo: render an invoice, run the full local pipeline, print what the
system read and extracted (port of scripts/demo.py: the same options and
output, and ``--device``).

    python -m ocr_system_tpu_torch.utils.demo                # classical det + neural rec
    python -m ocr_system_tpu_torch.utils.demo --engine jax   # neural det + neural rec

The checkpoints are ``.npz`` files, by default the package's committed
``weights/*.npz``; the invoice is drawn with the package's DejaVu fonts
(``assets/fonts``), so it renders where the system has none. It runs on
the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

from ocr_system_tpu_torch.training.run_evaluate import committed
from ocr_system_tpu_torch.training.synth import PACKAGE_FONTS


def render_invoice() -> bytes:
    import io

    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("RGB", (900, 700), "white")
    d = ImageDraw.Draw(img)
    big = ImageFont.truetype(str(PACKAGE_FONTS / "DejaVuSans-Bold.ttf"), 34)
    f = ImageFont.truetype(str(PACKAGE_FONTS / "DejaVuSans.ttf"), 24)
    d.text((40, 30), "INVOICE", fill="black", font=big)
    lines = [
        "Invoice Number: 2024-0042",
        "Date: 15/01/2024",
        "Bill To: Acme Services Inc",
        "Email: billing@acme.com",
        "Phone: (555) 123-4567",
        "Total Amount: $1,234.56",
    ]
    for i, line in enumerate(lines):
        d.text((40, 110 + i * 55), line, fill="black", font=f)
    # small items table
    d.text((40, 460), "item", font=f, fill="black")
    d.text((340, 460), "quantity", font=f, fill="black")
    d.text((620, 460), "price", font=f, fill="black")
    for r, (a, b, c) in enumerate(
        [("services", "2", "$500.00"), ("tax", "1", "$234.56")]
    ):
        d.text((40, 505 + r * 45), a, font=f, fill="black")
        d.text((340, 505 + r * 45), b, font=f, fill="black")
        d.text((620, 505 + r * 45), c, font=f, fill="black")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--engine", default="classical", choices=["classical", "jax"])
    p.add_argument("--rec-checkpoint", default=committed("rec_latin"))
    p.add_argument("--det-checkpoint", default=committed("det"))
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine.pipeline import get_engine
    from ocr_system_tpu_torch.extract.rules import RuleExtractor

    settings = Settings(
        ocr_engine=args.engine,
        rec_checkpoint=args.rec_checkpoint,
        # the JAX script's engine routes Devanagari crops to the committed
        # checkpoints/rec_devanagari; here its .npz copy
        rec_checkpoint_devanagari=committed("rec_devanagari"),
        det_checkpoint=args.det_checkpoint,
        storage_root="storage",
    )
    engine = get_engine(settings, device=args.device)
    print(f"engine: {args.engine} | running OCR...")
    result = engine.process_document(render_invoice(), "demo_invoice.png")
    print(f"\n=== OCR output ({result.processing_time_ms:.0f} ms, "
          f"{len(result.combined_layout_boxes)} boxes) ===")
    print(result.combined_markdown)

    extraction = RuleExtractor().extract(result.combined_markdown)
    print(f"\n=== Extracted fields (form type: {extraction.form_type}) ===")
    for f in extraction.fields:
        print(f"  {f.field_key:>18}: {f.field_value!r:30} [{f.field_type}]")


if __name__ == "__main__":
    main()
