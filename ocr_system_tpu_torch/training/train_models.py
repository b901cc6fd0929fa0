"""Train the port's models on synthetic data and save checkpoints (port of
scripts/train_models.py).

    python -m ocr_system_tpu_torch.training.train_models rec    --steps 2000 --batch 64
    python -m ocr_system_tpu_torch.training.train_models det    --steps 500  --batch 8
    python -m ocr_system_tpu_torch.training.train_models layout --steps 4000 --batch 32
    python -m ocr_system_tpu_torch.training.train_models all    [--quick]

It runs on the card (``--device cpu`` is for tests), each trainer on its
default mesh as the JAX script's: the batch split over every visible card
(``training/train.shd_default_mesh``, ``dp=-1``; the layout model at
``tp=1``), one card on a one-card machine. Checkpoints are float32
``.npz`` state dicts (``core/checkpoint.py``) under ``checkpoints/``, the
models computing at the serving policy's dtype (bf16), as the JAX script's:
``rec_<charset>.npz``, ``det.npz`` (with the threshold head, which the
serving DBNet drops on load) and ``extract.npz``; the engines read them
through ``Settings.rec_checkpoint``, ``det_checkpoint`` and
``extract_checkpoint``. ``--resume`` continues from such a file with a
fresh optimizer. The layout trainer refuses to overwrite the serving
checkpoint (``checkpoints/extract.npz``) with a model of another width or
depth than ``Settings.extract_dim``/``extract_depth``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

logger = logging.getLogger("train")

SERVING_LAYOUT = Path("checkpoints/extract.npz")


def _resume(path: str | None, model, lr: float, device):
    """A TrainState continuing from the checkpoint at ``path`` (a fresh
    optimizer), or None when there is none."""
    from ocr_system_tpu_torch.core.checkpoint import maybe_load
    from ocr_system_tpu_torch.training.train import init_state

    if not path or maybe_load(path, model) is None:
        return None
    logger.info("resumed from %s", path)
    return init_state(model, lr, device)


def train_rec(args) -> None:
    from ocr_system_tpu_torch.core.checkpoint import save_checkpoint
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer
    from ocr_system_tpu_torch.training import train as T

    model = SVTRRecognizer(vocab_size=get_charset(args.charset).size)
    state = _resume(args.resume, model, args.lr, args.device)
    state, metrics = T.train_recognizer(
        steps=args.steps, batch_size=args.batch, width=args.rec_width,
        charset_name=args.charset, lr=args.lr, seed=args.seed, state=state,
        font_range=(args.font_min, args.font_max), device=args.device,
    )
    logger.info("rec metrics: %s", metrics)
    out = save_checkpoint(args.out or f"checkpoints/rec_{args.charset}.npz", state.model)
    logger.info("saved %s", out)


def train_det(args) -> None:
    from ocr_system_tpu_torch.core.checkpoint import save_checkpoint
    from ocr_system_tpu_torch.models.dbnet import DBNet
    from ocr_system_tpu_torch.training import train as T

    state = _resume(args.resume, DBNet(thresh_head=True), args.lr, args.device)
    out = Path(args.out or "checkpoints/det.npz")
    state, metrics = T.train_detector(
        steps=args.steps, batch_size=args.batch, size=args.det_size, lr=args.lr,
        seed=args.seed, state=state,
        save_every=1000,  # crash-safe long runs
        save_path=str(out.absolute()),
        forms_fraction=args.forms_fraction, deva_fraction=args.deva_fraction,
        device=args.device,
    )
    logger.info("det metrics: %s", metrics)
    logger.info("saved %s", save_checkpoint(out, state.model))


def train_layout(args) -> None:
    from ocr_system_tpu_torch.core.checkpoint import save_checkpoint
    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor
    from ocr_system_tpu_torch.training import train as T

    out = Path(args.out or SERVING_LAYOUT)
    serving = Settings()
    if (out.resolve() == SERVING_LAYOUT.resolve()
            and (args.dim, args.depth) != (serving.extract_dim, serving.extract_depth)):
        raise SystemExit(
            f"refusing to overwrite {out} with a {args.dim}x{args.depth} model: serving "
            f"expects {serving.extract_dim}x{serving.extract_depth} "
            "(Settings.extract_dim/extract_depth). Pass --out to train an experimental "
            "architecture."
        )
    model = LayoutExtractor(vocab_size=get_charset(args.charset).size, dim=args.dim,
                            depth=args.depth)
    state = _resume(args.resume, model, args.lr, args.device)
    state, metrics = T.train_layout(
        steps=args.steps, batch_size=args.batch, charset_name=args.charset,
        noise_rate=args.noise, lr=args.lr, seed=args.seed, state=state,
        dim=args.dim, depth=args.depth, deva_fraction=args.deva_fraction,
        device=args.device,
    )
    logger.info("layout metrics: %s", metrics)
    logger.info("saved %s", save_checkpoint(out, state.model))


def parser() -> argparse.ArgumentParser:
    from ocr_system_tpu_torch.core.config import Settings

    serving = Settings()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("target", choices=["rec", "det", "layout", "all"])
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--noise", type=float, default=0.03,
                   help="mean OCR-noise rate for layout training")
    # default per target: rec/det latin, layout multilingual (the layout
    # extractor's serving charset, or the parameter shapes diverge)
    p.add_argument("--charset", default=None)
    p.add_argument("--rec-width", type=int, default=320)
    p.add_argument("--det-size", type=int, default=640)
    p.add_argument("--forms-fraction", type=float, default=0.5,
                   help="fraction of det training pages that are forms")
    # defaults track the serving architecture, so a default layout run
    # cannot overwrite the serving checkpoint with a shape serving cannot load
    p.add_argument("--dim", type=int, default=serving.extract_dim,
                   help=f"layout extractor width (serving default {serving.extract_dim})")
    p.add_argument("--depth", type=int, default=serving.extract_depth,
                   help=f"layout extractor depth (serving default {serving.extract_depth})")
    p.add_argument("--deva-fraction", type=float, default=0.0,
                   help="fraction of det training pages in Devanagari")
    p.add_argument("--font-min", type=int, default=12, help="rec training font sizes (px)")
    p.add_argument("--font-max", type=int, default=38)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="checkpoint file to write (.npz)")
    p.add_argument("--resume", default=None, help="checkpoint to continue from (.npz)")
    p.add_argument("--quick", action="store_true", help="tiny smoke run")
    p.add_argument("--device", default=None,
                   help="cuda (the default; raises without a card) or cpu, for tests")
    return p


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(level="INFO", format="%(asctime)s %(message)s")
    args = parser().parse_args(argv)
    if args.target in ("rec", "all"):
        a = argparse.Namespace(**vars(args))
        a.steps = args.steps or (30 if args.quick else 2000)
        a.batch = args.batch or (8 if args.quick else 64)
        a.lr = args.lr or 1e-3
        a.charset = args.charset or "latin"
        train_rec(a)
    if args.target in ("det", "all"):
        a = argparse.Namespace(**vars(args))
        a.steps = args.steps or (10 if args.quick else 600)
        a.batch = args.batch or (2 if args.quick else 8)
        a.lr = args.lr or 1e-3
        a.charset = args.charset or "latin"
        if args.target == "all":
            a.out = None  # 'all' shares --out with rec; det gets its default
        train_det(a)
    if args.target in ("layout", "all"):
        a = argparse.Namespace(**vars(args))
        a.steps = args.steps or (20 if args.quick else 4000)
        a.batch = args.batch or (4 if args.quick else 32)
        a.lr = args.lr or 3e-4
        a.charset = args.charset or "multilingual"
        a.out = args.out if args.target == "layout" else None
        train_layout(a)


if __name__ == "__main__":
    main()
