"""A/B two layout-extractor checkpoints on the canonical extract metrics
(port of scripts/compare_extractors.py: the same options, output and
verdict, and ``--device``).

Acceptance gate for a scaled extractor: keep it only if held-out Latin
F1 >= 0.90 AND the Devanagari slice improves.

    python -m ocr_system_tpu_torch.training.compare_extractors \\
        --a ocr_system_tpu_torch/weights/extract.npz \\
        --b checkpoints/extract_2x.npz --b-dim 512 --b-depth 8

A checkpoint is an ``.npz`` file (``train_models`` writes them under
``checkpoints/``; ``--a`` defaults to the package's committed
``weights/extract.npz``). It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json

from ocr_system_tpu_torch.training.run_evaluate import committed


def evaluate(ckpt: str, dim: int, depth: int, forms: int, device=None) -> dict:
    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor
    from ocr_system_tpu_torch.training import evaluate as E
    from ocr_system_tpu_torch.training.synth_forms import FormGenerator
    from ocr_system_tpu_torch.training.synth_forms_heldout import HeldoutFormGenerator

    lm = LayoutModelExtractor(Settings(
        extract_checkpoint=ckpt, extract_dim=dim, extract_depth=depth,
        storage_root="storage"), device=device)
    out: dict = {}
    r = E.evaluate_form_extraction(lm, n_docs=forms)
    out["infamily"] = {"f1": round(r.f1, 4), "p": round(r.precision, 4),
                       "r": round(r.recall, 4),
                       "type_acc": round(r.form_type_accuracy, 4)}
    r = E.evaluate_form_extraction(
        lm, n_docs=forms, generator=HeldoutFormGenerator(seed=101))
    out["heldout"] = {"f1": round(r.f1, 4), "p": round(r.precision, 4),
                      "r": round(r.recall, 4)}
    # Devanagari slice: all-deva forms isolate the script's pairing quality
    r = E.evaluate_form_extraction(
        lm, n_docs=forms,
        generator=FormGenerator(seed=31338, deva_fraction=1.0))
    out["deva"] = {"f1": round(r.f1, 4), "p": round(r.precision, 4),
                   "r": round(r.recall, 4)}
    return out


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--a", default=committed("extract"))
    p.add_argument("--a-dim", type=int, default=512)
    p.add_argument("--a-depth", type=int, default=8)
    p.add_argument("--b", default="checkpoints/extract_2x.npz")
    p.add_argument("--b-dim", type=int, default=512)
    p.add_argument("--b-depth", type=int, default=8)
    p.add_argument("--forms", type=int, default=40)
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    a = evaluate(args.a, args.a_dim, args.a_depth, args.forms, args.device)
    print("A", args.a, json.dumps(a), flush=True)
    b = evaluate(args.b, args.b_dim, args.b_depth, args.forms, args.device)
    print("B", args.b, json.dumps(b), flush=True)
    verdict = (
        "ACCEPT" if b["heldout"]["f1"] >= 0.90
        and b["deva"]["f1"] > a["deva"]["f1"] else
        "borderline" if b["heldout"]["f1"] >= a["heldout"]["f1"]
        and b["deva"]["f1"] > a["deva"]["f1"] else "REJECT"
    )
    print("VERDICT", verdict, json.dumps({
        "heldout_delta": round(b["heldout"]["f1"] - a["heldout"]["f1"], 4),
        "deva_delta": round(b["deva"]["f1"] - a["deva"]["f1"], 4),
        "infamily_delta": round(b["infamily"]["f1"] - a["infamily"]["f1"], 4),
    }))


if __name__ == "__main__":
    main()
