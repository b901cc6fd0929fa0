"""Deep-dump ONE doc from diag_extract_pipeline's sequence: truth pairs,
engine word boxes, handwriting boxes + pairing, extractor fields (port of
scripts/diag_one_doc.py: the same options and output, and ``--device``).

    python -m ocr_system_tpu_torch.training.diag_one_doc --doc 15 [--seed 4242]

The checkpoints are the package's committed ``weights/*.npz``. It runs on
the card unless ``--device cpu``. ``--save-png`` writes the page's pixels
as a PNG without PIL.
"""
from __future__ import annotations

import argparse
import struct
import zlib

from ocr_system_tpu_torch.training.run_evaluate import build_engine, committed


def write_png(path: str, pixels) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (filter 0 on every row)."""
    h, w = pixels.shape[:2]
    rows = b"".join(b"\x00" + pixels[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--doc", type=int, required=True)
    p.add_argument("--seed", type=int, default=4242)
    p.add_argument("--save-png", default="")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine.handwriting import handwriting_to_fields
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.training import synth_forms as SF

    st = Settings(
        rec_checkpoint=committed("rec_latin"),
        # the JAX script's engine routes Devanagari crops to the committed
        # checkpoints/rec_devanagari; here its .npz copy
        rec_checkpoint_devanagari=committed("rec_devanagari"),
        det_checkpoint=committed("det"),
        det_image_buckets=(960,),
        storage_root="storage",
    )
    engine = build_engine("hybrid", st, get_charset("latin"), args.device)
    lm = LayoutModelExtractor(Settings(
        extract_checkpoint=committed("extract"), storage_root="storage"),
        device=args.device)

    gen = SF.FormGenerator(seed=args.seed)
    spec = None
    for _ in range(args.doc + 1):
        spec = gen.generate(960)
    page = SF.render_spec(spec, augment=False)
    pixels = (page.image * 255).astype(np.uint8)
    if args.save_png:
        write_png(args.save_png, pixels)
    print(f"=== doc {args.doc} form_type={spec.form_type}")
    print("--- truth pairs")
    for k, v, t in spec.pairs:
        print(f"  {k!r}: {v!r}  [{t}]")
    out = engine.process_pages([PageImage(pixels, 1)])[0]
    print("--- engine word boxes (x0,y0,x1,y1 text)")
    words = [b for b in out.layout_boxes if b.get("type") == "word"]
    for b in sorted(words, key=lambda b: (min(b["polygon"][1::2]) // 14,
                                          min(b["polygon"][0::2]))):
        x = b["polygon"][0::2]
        y = b["polygon"][1::2]
        print(f"  ({min(x):4.0f},{min(y):4.0f},{max(x):4.0f},{max(y):4.0f}) "
              f"c={b['confidence']:.2f} {b['content']!r}")
    hand = [b for b in out.layout_boxes if b.get("type") == "handwriting"]
    print("--- handwriting boxes")
    for b in hand:
        x = b["polygon"][0::2]
        y = b["polygon"][1::2]
        print(f"  ({min(x):4.0f},{min(y):4.0f},{max(x):4.0f},{max(y):4.0f})")
    print("--- handwriting_to_fields")
    for sf in handwriting_to_fields(hand, out.layout_boxes):
        print(f"  {sf['field_key']!r} -> {sf['field_value']!r} "
              f"kw={sf.get('keyword_label')} gap={sf.get('label_gap')}")
    result = lm.extract_from_layout(words, (960, 960), ocr_text=out.markdown)
    print("--- extractor fields")
    for f in result.fields:
        print(f"  {f.field_key!r}: {f.field_value!r} "
              f"({f.field_type}, {f.confidence:.2f})")
    print("--- markdown")
    print(out.markdown)


if __name__ == "__main__":
    main()
