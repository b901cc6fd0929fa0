"""Line-level Hindi e2e diagnosis: worst rows of the e2e_hindi sweep metric
(port of scripts/diag_hindi.py: the same options and output, and
``--device``; the JAX script's persistent compile cache has no counterpart
in eager PyTorch).

Mirrors evaluate_end_to_end's hindi configuration but prints every truth
row whose best engine match is poor, so page-CER losses are attributable
(misread / missing / merged / extra).

    python -m ocr_system_tpu_torch.training.diag_hindi [--pages 20] [--seed 5555]

The checkpoints are the package's committed ``weights/*.npz``
(``--deva-ckpt`` names another Devanagari ``.npz``). It runs on the card
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

from ocr_system_tpu_torch.training.run_evaluate import build_engine, committed


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--pages", type=int, default=20)
    p.add_argument("--seed", type=int, default=5555)
    p.add_argument("--deva-ckpt", default=committed("rec_devanagari"))
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.engine.reading_order import canonicalize_leaders
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.training.evaluate import (
        _cluster_rows,
        _truth_charset,
        cer,
        infix_cer,
    )
    from ocr_system_tpu_torch.training.synth import TextRenderer

    latin = get_charset("latin")
    deva = get_charset("devanagari")
    st = Settings(
        rec_checkpoint=committed("rec_latin"),
        rec_checkpoint_devanagari=args.deva_ckpt,
        det_checkpoint=committed("det"),
        det_image_buckets=(960,),
        storage_root="storage",
    )
    engine = build_engine("hybrid", st, latin, args.device)
    renderer = TextRenderer(deva, seed=args.seed)
    truth_charset = _truth_charset(engine, deva)

    page_rows = []
    for i in range(args.pages):
        page = renderer.render_page(size=960, augment=False)
        out = engine.process_pages(
            [PageImage((page.image * 255).astype(np.uint8), 1)]
        )[0]
        texts = [
            truth_charset.decode(truth_charset.encode(t)) for t in page.texts
        ]
        truth_rows = [
            canonicalize_leaders(t) for t in _cluster_rows(page.quads, texts)
        ]
        pc = cer("\n".join(truth_rows), out.markdown)
        got = out.markdown.splitlines()
        bad = []
        for t in truth_rows:
            best = min(
                (min(cer(t, g), infix_cer(t, g)), g) for g in got
            ) if got else (1.0, "")
            if best[0] >= 0.15:
                bad.append((round(best[0], 2), t, best[1]))
        page_rows.append((pc, i, bad, len(truth_rows)))

    page_rows.sort(reverse=True)
    total_bad = sum(len(b) for _, _, b, _ in page_rows)
    print(f"mean page CER {np.mean([p for p, *_ in page_rows]):.4f}  "
          f"bad rows {total_bad}")
    for pc, i, bad, n in page_rows[:8]:
        print(f"\npage {i}: CER {pc:.3f} ({len(bad)}/{n} bad rows)")
        for c, t, g in bad[:6]:
            print(f"  [{c}] truth: {t[:70]!r}")
            print(f"        got:  {g[:70]!r}")


if __name__ == "__main__":
    main()
