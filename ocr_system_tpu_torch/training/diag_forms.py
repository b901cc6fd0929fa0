"""Diagnose forms e2e loss: per-page truth rows vs engine output, with
per-row best-match CER so det misses vs rec errors are attributable (port
of scripts/diag_forms.py: the same options and output, and ``--device``).

    python -m ocr_system_tpu_torch.training.diag_forms \\
        [--engine hybrid] [--pages 5] [--seed 5555] [--device cpu]

The checkpoints are ``.npz`` files, by default the package's committed
``weights/*.npz``. It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

from ocr_system_tpu_torch.training.run_evaluate import build_engine, committed


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--engine", default="hybrid")
    p.add_argument("--pages", type=int, default=5)
    p.add_argument("--seed", type=int, default=5555)
    p.add_argument("--size", type=int, default=800)
    p.add_argument("--rec-checkpoint", default=committed("rec_latin"))
    p.add_argument("--det-checkpoint", default=committed("det"))
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    import numpy as np

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.training import synth_forms as SF
    from ocr_system_tpu_torch.training.evaluate import _cluster_rows, cer, infix_cer

    charset = get_charset("latin")
    settings = Settings(
        rec_checkpoint=args.rec_checkpoint,
        # the JAX script's engine routes Devanagari crops to the committed
        # checkpoints/rec_devanagari; here its .npz copy
        rec_checkpoint_devanagari=committed("rec_devanagari"),
        det_checkpoint=args.det_checkpoint,
        rec_width_buckets=(80, 160, 320, 640),
        det_image_buckets=(960,),
        storage_root="storage",
    )
    kind = args.engine if args.engine in ("classical", "hybrid") else "jax"
    engine = build_engine(kind, settings, charset, args.device)

    form_gen = SF.FormGenerator(seed=args.seed + 1)
    for i in range(args.pages):
        page = SF.render_spec(form_gen.generate(args.size), augment=False)
        out = engine.process_pages(
            [PageImage((page.image * 255).astype(np.uint8), 1)]
        )[0]
        texts = [charset.decode(charset.encode(t)) for t in page.texts]
        truth_rows = _cluster_rows(page.quads, texts)
        got_lines = out.markdown.splitlines()
        page_cer = cer("\n".join(truth_rows), out.markdown)
        print(f"\n=== form page {i}  page_cer={page_cer:.3f} "
              f"truth_rows={len(truth_rows)} got_lines={len(got_lines)}")
        for t in truth_rows:
            best, bg = 9.9, ""
            for g in got_lines:
                c = min(cer(t, g), infix_cer(t, g))
                if c < best:
                    best, bg = c, g
            flag = "MISS" if best >= 0.3 else ("ok  " if best < 0.05 else "err ")
            print(f"  [{flag} {best:4.2f}] T: {t[:76]!r}")
            if best >= 0.05:
                print(f"             G: {bg[:76]!r}")
        extra = [
            g for g in got_lines
            if all(min(cer(t, g), infix_cer(t, g)) >= 0.5 for t in truth_rows)
        ]
        for g in extra:
            print(f"  [HALLUC   ] G: {g[:76]!r}")


if __name__ == "__main__":
    main()
