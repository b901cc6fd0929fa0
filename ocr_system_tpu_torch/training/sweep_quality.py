"""Canonical quality sweep (port of scripts/sweep_quality.py): every README
quality-table row in one process, at serving defaults, on the committed
weights.

    python -m ocr_system_tpu_torch.training.sweep_quality            # full table
    python -m ocr_system_tpu_torch.training.sweep_quality --quick    # 10 pages, 1 seed
    python -m ocr_system_tpu_torch.training.sweep_quality --rows e2e,rec

It runs on the card; ``--device cpu`` runs the plain PyTorch path on the
CPU. Each row prints ``ROW <name> <json>``, and the last line is ``SWEEP
<json>`` with every row. Every row names its weights explicitly (the
package's ``weights/*.npz``; ``SWEEP_CKPT_DET``, ``SWEEP_CKPT_REC_LATIN``,
``SWEEP_CKPT_REC_DEVANAGARI`` and ``SWEEP_CKPT_EXTRACT`` name other
``.npz`` files for an A/B sweep) and refuses to run when one is missing:
random weights would give a number that means nothing. The hybrid engine
runs ``det_prob_wire_bits`` from ``SWEEP_PROB_WIRE_BITS`` (default 4, as
in the JAX sweep).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from ocr_system_tpu_torch.training.run_evaluate import WEIGHTS, build_engine

NAMES = ("det", "rec_latin", "rec_devanagari", "extract")


def checkpoints() -> dict[str, str]:
    """The weight file of each model: the committed one, or the file that
    ``SWEEP_CKPT_<NAME>`` names."""
    ckpts = {}
    for name in NAMES:
        ckpts[name] = str(WEIGHTS / f"{name}.npz")
        env = os.environ.get(f"SWEEP_CKPT_{name.upper()}")
        if env:
            ckpts[name] = env
            print(f"[sweep] {name} checkpoint OVERRIDE: {env}", file=sys.stderr)
    return ckpts


def _require(ckpts: dict[str, str], *names: str) -> None:
    missing = [n for n in names if not Path(ckpts[n]).is_file()]
    if missing:
        raise SystemExit(f"missing checkpoints: {missing} — train or fetch "
                         "them before sweeping (random init would lie)")


def _aggregate(per_seed: list[dict]) -> dict:
    """Collapse per-seed metric dicts into {metric: {mean, min, max}} (flat
    {metric: value} when a single seed ran, preserving the old row shape)."""
    if len(per_seed) == 1:
        return per_seed[0]
    out: dict = {}
    for k in per_seed[0]:
        vals = [d[k] for d in per_seed if isinstance(d.get(k), (int, float))]
        if len(vals) == len(per_seed):
            out[k] = {
                "mean": round(sum(vals) / len(vals), 4),
                "min": round(min(vals), 4),
                "max": round(max(vals), 4),
            }
        else:  # non-numeric (nested dicts): keep per-seed list
            out[k] = [d.get(k) for d in per_seed]
    out["seeds"] = len(per_seed)
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", default="rec,e2e,classical,hindi,extract,"
                                     "forms_e2e,signatures")
    # 10 pages / 1 seed cannot support 0.1-point claims: the defaults are
    # 50 pages x 3 seeds with mean and spread; --quick is the cheap pass
    p.add_argument("--pages", type=int, default=50)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--forms", type=int, default=25)
    p.add_argument("--forms-e2e", type=int, default=10)
    p.add_argument("--signatures", type=int, default=10)
    p.add_argument("--quick", action="store_true",
                   help="single seed, 10 pages (the pre-round-4 default)")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    return p


def main(argv: list[str] | None = None) -> dict:
    args = parser().parse_args(argv)
    if args.quick:
        args.pages, args.seeds = 10, 1
    rows = set(args.rows.split(","))
    # distinct seed offsets per trial; 0 keeps trial 1 on the historical
    # seeds so old and new sweeps stay comparable
    offsets = [i * 1009 for i in range(max(args.seeds, 1))]
    ckpts = checkpoints()
    dev = args.device

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.core.dtypes import resolve_device
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.training import evaluate as E

    resolve_device(dev)  # no card and no --device cpu: raise before any work
    latin = get_charset("latin")
    deva = get_charset("devanagari")
    report: dict = {}

    def engine(detector: str, charset, rec_ckpt: str):
        st = Settings(
            rec_checkpoint=rec_ckpt,
            # explicit: the engine's script-routed Devanagari recognizer
            # follows the checkpoint table too
            rec_checkpoint_devanagari=ckpts["rec_devanagari"],
            det_checkpoint=ckpts["det"],
            det_image_buckets=(960,),
            storage_root="storage",
            # A/B gate for the det wire format (SWEEP_PROB_WIRE_BITS=0 gates
            # the on-device box statistics against the 4-bit map)
            det_prob_wire_bits=int(os.environ.get("SWEEP_PROB_WIRE_BITS", "4")),
        )
        return build_engine(detector, st, charset, dev)

    def emit(key: str, value) -> None:
        report[key] = value
        print("ROW", key, json.dumps(value), flush=True)

    def seeded(key: str, fn) -> None:
        """Run fn(offset) per seed offset, print each trial, emit spread."""
        trials = []
        for off in offsets:
            t = fn(off)
            trials.append(t)
            if len(offsets) > 1:
                print(f"  trial +{off}: {json.dumps(t)}", flush=True)
        emit(key, _aggregate(trials))

    if "rec" in rows:
        _require(ckpts, "rec_latin", "rec_devanagari")
        from ocr_system_tpu_torch.engine.recognizer import Recognizer

        for name, cs in (("rec_latin", latin), ("rec_devanagari", deva)):
            st = Settings(rec_checkpoint=ckpts[name], storage_root="storage")
            rec = Recognizer(st, charset=cs, device=dev)
            seeded(name, lambda off, rec=rec, cs=cs: (
                lambda r: {"cer": round(r.mean_cer, 4),
                           "exact": round(r.exact_match_rate, 4)}
            )(E.evaluate_recognizer(rec, cs, seed=9999 + off)))

    hybrid = None
    if rows & {"e2e", "hindi", "forms_e2e", "signatures"}:
        _require(ckpts, "det", "rec_latin", "rec_devanagari")
        hybrid = engine("hybrid", latin, ckpts["rec_latin"])

    if "e2e" in rows:
        seeded("e2e_hybrid", lambda off: (
            lambda r: {"forms_cer": round(r.forms_page_cer, 4),
                       "plain_cer": round(r.plain_page_cer, 4),
                       "content_cer": round(r.content_page_cer, 4),
                       "recall": round(r.line_recall, 4)}
        )(E.evaluate_end_to_end(
            hybrid, latin, n_pages=args.pages, seed=5555 + off)))

    if "classical" in rows:
        _require(ckpts, "rec_latin")
        eng = engine("classical", latin, ckpts["rec_latin"])
        seeded("e2e_classical", lambda off: (
            lambda r: {"forms_cer": round(r.forms_page_cer, 4),
                       "plain_cer": round(r.plain_page_cer, 4),
                       "recall": round(r.line_recall, 4)}
        )(E.evaluate_end_to_end(
            eng, latin, n_pages=args.pages, seed=5555 + off)))

    if "hindi" in rows:
        # SERVING path: the latin-primary engine script-routes per crop —
        # one endpoint reads both scripts. Hindi pages carry ASCII value
        # lines, so a deva-primary engine is NOT the product.
        _require(ckpts, "det", "rec_latin", "rec_devanagari")
        seeded("e2e_hindi", lambda off: (
            lambda r: {"page_cer": round(r.mean_page_cer, 4),
                       "recall": round(r.line_recall, 4)}
        )(E.evaluate_end_to_end(
            hybrid, deva, n_pages=args.pages, seed=5555 + off)))

    lm = None
    if rows & {"extract", "forms_e2e"}:
        _require(ckpts, "extract")
        from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor

        lm = LayoutModelExtractor(Settings(
            extract_checkpoint=ckpts["extract"], storage_root="storage"), device=dev)

    if "extract" in rows:
        from ocr_system_tpu_torch.training.synth_forms_heldout import HeldoutFormGenerator

        seeded("extract_infamily", lambda off: (
            lambda r: {"f1": round(r.f1, 4),
                       "precision": round(r.precision, 4),
                       "recall": round(r.recall, 4),
                       "type_acc": round(r.form_type_accuracy, 4)}
        )(E.evaluate_form_extraction(
            lm, n_docs=args.forms, seed=31337 + off)))
        seeded("extract_heldout", lambda off: (
            lambda r: {"f1": round(r.f1, 4),
                       "precision": round(r.precision, 4),
                       "recall": round(r.recall, 4)}
        )(E.evaluate_form_extraction(
            lm, n_docs=args.forms,
            generator=HeldoutFormGenerator(seed=101 + off),
            seed=31337 + off)))

    if "forms_e2e" in rows:
        seeded("forms_e2e", lambda off: E.evaluate_form_extraction_e2e(
            hybrid, lm, n_docs=args.forms_e2e, seed=4242 + off))

    if "signatures" in rows:
        seeded("signatures", lambda off: E.evaluate_signature_detection(
            hybrid, n_docs=args.signatures, seed=24601 + off))

    print("SWEEP", json.dumps(report))
    return report


if __name__ == "__main__":
    main()
