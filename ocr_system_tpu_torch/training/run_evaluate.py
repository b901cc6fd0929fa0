"""Evaluate OCR + extraction quality and print a JSON report (port of
scripts/evaluate.py: the same options and defaults, the same report, and
``--device``).

    python -m ocr_system_tpu_torch.training.run_evaluate
    python -m ocr_system_tpu_torch.training.run_evaluate --charset devanagari
    python -m ocr_system_tpu_torch.training.run_evaluate --e2e hybrid --pages 10 \\
        --forms 25 --forms-heldout 25 --signatures 10 --forms-e2e 10

It runs on the card; ``--device cpu`` runs the plain PyTorch path on the
CPU. A checkpoint option names an ``.npz`` file: one that
training/train_models.py writes under ``checkpoints/``, or the package's
committed ``weights/*.npz``, which are the defaults.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

WEIGHTS = Path(__file__).resolve().parents[1] / "weights"


def committed(name: str) -> str:
    """The package's committed weight file ``weights/<name>.npz``, or ""
    (random init) where it is missing."""
    path = WEIGHTS / f"{name}.npz"
    return str(path) if path.is_file() else ""


def build_engine(kind: str, settings, charset, device):
    """The engine an evaluation scores: the ``_build_engine`` kinds "jax"
    (DBNet), "classical" and "hybrid", with the recognizer of ``charset``
    as the primary one, as the JAX scripts build theirs."""
    from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine
    from ocr_system_tpu_torch.engine.recognizer import Recognizer

    rec = Recognizer(settings, charset=charset, device=device)
    if kind == "classical":
        from ocr_system_tpu_torch.engine.classical_detector import ClassicalDetector

        detector = ClassicalDetector(settings)
    elif kind == "hybrid":
        from ocr_system_tpu_torch.engine.hybrid_detector import HybridDetector

        detector = HybridDetector(settings, device=device)
    elif kind == "jax":
        detector = None
    else:
        raise ValueError(f"unknown engine {kind!r}: jax, classical or hybrid")
    return TorchOCREngine(settings, detector=detector, recognizer=rec, device=device)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rec-checkpoint", default="")
    p.add_argument("--det-checkpoint", default=committed("det"))
    p.add_argument("--charset", default="latin")
    p.add_argument("--lines", type=int, default=100)
    p.add_argument("--docs", type=int, default=20)
    p.add_argument(
        "--e2e", default="",
        help="run full-pipeline eval: 'jax', 'classical', or 'hybrid'",
    )
    p.add_argument("--pages", type=int, default=10)
    p.add_argument(
        "--forms", type=int, default=0,
        help="compare rules vs layout model on N noisy synthetic forms",
    )
    p.add_argument("--form-noise", type=float, default=0.03)
    p.add_argument(
        "--forms-heldout", type=int, default=0,
        help="also eval on N out-of-family forms (disjoint layout family)",
    )
    p.add_argument(
        "--signatures", type=int, default=0,
        help="e2e signature-detection eval on N squiggle forms "
             "(requires --e2e engine)",
    )
    p.add_argument(
        "--forms-e2e", type=int, default=0,
        help="field-extraction F1 through the REAL OCR pipeline on N "
             "forms (requires --e2e engine)",
    )
    p.add_argument("--extract-checkpoint", default=committed("extract"))
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    return p


def _fields(res, type_acc: bool) -> dict:
    out = {
        "precision": round(res.precision, 4),
        "recall": round(res.recall, 4),
        "f1": round(res.f1, 4),
    }
    if type_acc:
        out["form_type_accuracy"] = round(res.form_type_accuracy, 4)
    return out


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    if not args.rec_checkpoint:
        args.rec_checkpoint = committed(f"rec_{args.charset}")

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine.recognizer import Recognizer
    from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor
    from ocr_system_tpu_torch.extract.rules import RuleExtractor
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.training import evaluate as E
    from ocr_system_tpu_torch.training.synth_forms_heldout import HeldoutFormGenerator

    dev = args.device
    settings = Settings(
        rec_checkpoint=args.rec_checkpoint,
        det_checkpoint=args.det_checkpoint,
        rec_width_buckets=(320,),
        storage_root="storage",
    )
    charset = get_charset(args.charset)
    rec = Recognizer(settings, charset=charset, device=dev)
    rec_result = E.evaluate_recognizer(rec, charset, n_lines=args.lines)
    field_result = E.evaluate_field_extraction(RuleExtractor(), n_docs=args.docs)
    has_extractor = Path(args.extract_checkpoint).is_file()

    def layout_model():
        return LayoutModelExtractor(
            Settings(extract_checkpoint=args.extract_checkpoint, storage_root="storage"),
            device=dev,
        )

    forms_report = None
    if args.forms:
        def run(extractor):
            return _fields(E.evaluate_form_extraction(
                extractor, n_docs=args.forms, noise_rate=args.form_noise), True)

        forms_report = {"n_docs": args.forms, "noise_rate": args.form_noise,
                        "rules": run(RuleExtractor())}
        if has_extractor:
            forms_report["layout_model"] = run(layout_model())

    heldout_report = None
    if args.forms_heldout:
        def run_heldout(extractor, seed):
            # form types here are outside the trained label set by design;
            # form_type accuracy is not meaningful for this family
            return _fields(E.evaluate_form_extraction(
                extractor, n_docs=args.forms_heldout, noise_rate=args.form_noise,
                generator=HeldoutFormGenerator(seed=seed)), False)

        heldout_report = {"n_docs": args.forms_heldout, "noise_rate": args.form_noise,
                          "rules": run_heldout(RuleExtractor(), 101)}
        if has_extractor:
            heldout_report["layout_model"] = run_heldout(layout_model(), 101)

    e2e_report = None
    if args.e2e:
        e2e_settings = Settings(
            rec_checkpoint=args.rec_checkpoint,
            # the JAX script's engine routes Devanagari crops to the
            # committed checkpoints/rec_devanagari; here its .npz copy
            rec_checkpoint_devanagari=committed("rec_devanagari"),
            det_checkpoint=args.det_checkpoint,
            rec_width_buckets=(80, 160, 320, 640),
            det_image_buckets=(960,),
            storage_root="storage",
        )
        engine = build_engine(args.e2e, e2e_settings, charset, dev)
        r = E.evaluate_end_to_end(engine, charset, n_pages=args.pages)
        e2e_report = {
            "engine": args.e2e,
            "n_pages": r.n_pages,
            "mean_page_cer": round(r.mean_page_cer, 4),
            "line_recall": round(r.line_recall, 4),
            "forms_page_cer": round(r.forms_page_cer, 4),
            "plain_page_cer": round(r.plain_page_cer, 4),
        }
        if args.signatures:
            e2e_report["signatures"] = E.evaluate_signature_detection(
                engine, n_docs=args.signatures)
        if args.forms_e2e:
            e2e_report["form_extraction_e2e"] = E.evaluate_form_extraction_e2e(
                engine, layout_model(), n_docs=args.forms_e2e)

    report = {
        "recognizer": {
            "checkpoint": args.rec_checkpoint or "(random init)",
            "charset": args.charset,
            "n_lines": rec_result.n_lines,
            "mean_cer": round(rec_result.mean_cer, 4),
            "exact_match_rate": round(rec_result.exact_match_rate, 4),
            "samples": rec_result.samples,
        },
        "field_extraction": {
            "precision": round(field_result.precision, 4),
            "recall": round(field_result.recall, 4),
            "f1": round(field_result.f1, 4),
            "n_docs": field_result.n_docs,
        },
        "form_extraction": forms_report,
        "form_extraction_heldout_family": heldout_report,
        "end_to_end": e2e_report,
    }
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
