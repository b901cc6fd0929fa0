"""Diagnose pipeline-extraction losses (port of
scripts/diag_extract_pipeline.py: the same options and output, and
``--device``).

Mirrors training/evaluate.evaluate_form_extraction_e2e but prints every
non-exact pair with a category, so the exact->relaxed->box-fed losses are
attributable:

  KEY_NOISE   key near-match (cer<=0.25) but not exact -> rec noise on key
  VAL_NOISE   key exact, value near but not exact      -> rec noise on value
  PAIR_NOISE  both near, neither exact
  MISSING     truth pair with no near got-pair          -> det/extract loss
  SPURIOUS    got pair with no near truth-pair          -> merge/hallucination

    python -m ocr_system_tpu_torch.training.diag_extract_pipeline [--docs 10] [--seed 4242]

The checkpoints are the package's committed ``weights/*.npz``. It runs on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
from collections import Counter

from ocr_system_tpu_torch.training.run_evaluate import build_engine, committed


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--docs", type=int, default=10)
    p.add_argument("--seed", type=int, default=4242)
    p.add_argument("--wire-bits", type=int, default=4,
                   help="det canvas wire depth (8 = no quantization); "
                        "A/B how much residual noise the 4-bit serving "
                        "wire contributes")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine.handwriting import (
        handwriting_to_fields,
        squiggle_overrides,
    )
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.training import synth_forms as SF
    from ocr_system_tpu_torch.training.evaluate import _norm_key, _norm_val, cer

    st = Settings(
        rec_checkpoint=committed("rec_latin"),
        # the JAX script's engine routes Devanagari crops to the committed
        # checkpoints/rec_devanagari; here its .npz copy
        rec_checkpoint_devanagari=committed("rec_devanagari"),
        det_checkpoint=committed("det"),
        det_image_buckets=(960,),
        storage_root="storage",
        det_wire_bits=args.wire_bits,
    )
    engine = build_engine("hybrid", st, get_charset("latin"), args.device)
    lm = LayoutModelExtractor(Settings(
        extract_checkpoint=committed("extract"), storage_root="storage"),
        device=args.device)

    gen = SF.FormGenerator(seed=args.seed)
    cats: Counter = Counter()
    for di in range(args.docs):
        spec = gen.generate(960)
        page = SF.render_spec(spec, augment=False)
        pixels = (page.image * 255).astype(np.uint8)
        out = engine.process_pages([PageImage(pixels, 1)])[0]
        words = [b for b in out.layout_boxes if b.get("type") == "word"]
        result = lm.extract_from_layout(
            words, (960, 960), ocr_text=out.markdown)
        got = {
            _norm_key(f.field_key): _norm_val(f.field_value)
            for f in result.fields
            if f.field_key.strip() and f.field_value.strip()
        }
        hand = [b for b in out.layout_boxes if b.get("type") == "handwriting"]
        for sf in handwriting_to_fields(hand, out.layout_boxes):
            k = _norm_key(sf["field_key"])
            if squiggle_overrides(sf, got.get(k), other_keys=set(got)):
                got[k] = _norm_val(sf["field_value"])
        truth = {
            _norm_key(k): _norm_val(v)
            for i, (k, v, _) in enumerate(spec.pairs)
            if v.strip() and i not in spec.dropped_pair_ids
        }

        matched_g = set()
        print(f"--- doc {di} ({spec.form_type}) "
              f"truth={len(truth)} got={len(got)}")
        for k, v in truth.items():
            if got.get(k) == v:
                matched_g.add(k)
                cats["EXACT"] += 1
                continue
            hit = None
            for gk, gv in got.items():
                if gk in matched_g:
                    continue
                if cer(k, gk) <= 0.25 and cer(v, gv) <= 0.25:
                    hit = gk
                    break
            if hit is None:
                cats["MISSING"] += 1
                print(f"  MISSING    {k!r}: {v!r}")
                continue
            matched_g.add(hit)
            gv = got[hit]
            if hit != k and gv != v:
                cats["PAIR_NOISE"] += 1
                print(f"  PAIR_NOISE {k!r}->{hit!r} | {v!r}->{gv!r}")
            elif hit != k:
                cats["KEY_NOISE"] += 1
                print(f"  KEY_NOISE  {k!r}->{hit!r} (val ok: {v!r})")
            else:
                cats["VAL_NOISE"] += 1
                print(f"  VAL_NOISE  {k!r}: {v!r}->{gv!r}")
        for gk, gv in got.items():
            if gk not in matched_g:
                cats["SPURIOUS"] += 1
                print(f"  SPURIOUS   {gk!r}: {gv!r}")

    total_truth = cats["EXACT"] + cats["MISSING"] + cats["KEY_NOISE"] + \
        cats["VAL_NOISE"] + cats["PAIR_NOISE"]
    print("\n=== categories ===")
    for c, n in cats.most_common():
        print(f"  {c:10s} {n:4d}  ({n / max(total_truth, 1):.2%} of truth)")


if __name__ == "__main__":
    main()
