"""Training loops for the port's three models (port of
ocr_system_tpu/training/train.py), on one device:

  - recognizer (SVTR + CTC) on synthetic text lines,
  - detector (DBNet + the DB loss) on synthetic pages, whose batches come
    in the JAX package's wire format and are decoded and augmented on the
    device,
  - layout extractor (BIO tagging) on streamed synthetic form specs.

A ``TrainState`` holds the model (parameters and BatchNorm statistics),
its optimizer (optax's ``chain(clip_by_global_norm(1.0), adamw(lr,
weight_decay=1e-4))``: ``clip_by_global_norm_`` and ``AdamW``) and the step
count. Each ``make_*_train_step(..., mesh)``
returns ``step(state, batch) -> (state, metrics)``: one forward, backward
and update, its metrics left on the device (a ``float()`` per step would
wait for the device every step; the drivers read them at log points).
Batches are the iterators' numpy dicts moved to the device by
``to_device``.

The mesh (core/mesh.py) is the JAX package's: the batch splits over ``dp``
and the step keeps the global batch's semantics, as JAX's jitted step over
a dp-sharded batch does. The shards run in lockstep (``run_sharded``): the
BatchNorms normalise with the global batch's statistics, and each loss is
summed over the shards as its terms (masked sums and counts) before it is
divided, so masked means are over the global mask. The gradients of every
shard reach the one set of parameters (the dp psum). The layout trainer
also splits the 512 x 8 model's mlp and heads dimensions over ``tp``
(``init_layout_state_sharded``). Without a mesh, the trainers take
``shd_default_mesh``: ``dp=-1`` over the trainer's device.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
from typing import Callable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from ocr_system_tpu_torch.core.dtypes import DTypePolicy, default_policy, resolve_device, widen
from ocr_system_tpu_torch.core.mesh import (
    DATA_AXIS,
    Mesh,
    axis_index,
    build_mesh,
    reduce_to,
    run_sharded,
    shard_batch,
)
from ocr_system_tpu_torch.kernels.enhance import to_unit
from ocr_system_tpu_torch.models.charsets import Charset, get_charset
from ocr_system_tpu_torch.ops.ctc import ctc_line_losses
from ocr_system_tpu_torch.ops.image_ops import NORM_MEAN, NORM_STD
from ocr_system_tpu_torch.parallel.sharding import reduce_replica_grads, replicas
from ocr_system_tpu_torch.training import synth

logger = logging.getLogger(__name__)

MAX_GRAD_NORM = 1.0
WEIGHT_DECAY = 1e-4
# batch entries that stay on the host: the det augmentation seeds a
# torch.Generator from it, and reading it from the device would wait there
HOST_KEYS = ("noise_seed",)


@dataclasses.dataclass
class TrainState:
    """A model with its parameters and BatchNorm statistics, its optimizer
    and the number of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


class AdamW(torch.optim.Optimizer):
    """optax's ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, the decay on every
    parameter, no mask) in optax's arithmetic order, each operation rounded
    on its own as XLA rounds it: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 -
    b2) g^2 + b2 nu``, ``u = (mu / c1) / (sqrt(nu / c2) + eps) + wd p``,
    ``p += -lr u``. ``torch.optim.AdamW`` computes the same in another order
    (``lerp`` for the first moment, the decay before the update), which
    differs wherever the first moment cancels, and it skips a parameter
    without a gradient, which optax decays. A missing gradient counts as
    zero."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = WEIGHT_DECAY):
        super().__init__(params, {"lr": lr, "b1": b1, "b2": b2, "eps": eps,
                                  "weight_decay": weight_decay})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = group["params"]
            lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
            for p in params:
                if not self.state[p]:
                    self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p),
                                     "count": 0}
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            mu = [self.state[p]["mu"] for p in params]
            nu = [self.state[p]["nu"] for p in params]
            count = self.state[params[0]]["count"] + 1
            for p in params:
                self.state[p]["count"] = count
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))
            # the bias corrections 1 - b^count in float32, as optax's
            c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            denom = torch._foreach_sqrt(torch._foreach_div(nu, c2))
            torch._foreach_add_(denom, eps)
            u = torch._foreach_div(torch._foreach_div(mu, c1), denom)
            torch._foreach_add_(u, torch._foreach_mul(params, group["weight_decay"]))
            torch._foreach_mul_(u, -lr)
            torch._foreach_add_(params, u)


def make_optimizer(params, lr: float = 1e-3,
                   weight_decay: float = WEIGHT_DECAY) -> torch.optim.Optimizer:
    """The AdamW half of the JAX chain; the global-norm clip before it is
    ``clip_by_global_norm_``, called by the steps."""
    return AdamW(params, lr=lr, weight_decay=weight_decay)


def clip_by_global_norm_(params, max_norm: float = MAX_GRAD_NORM) -> torch.Tensor:
    """optax's ``clip_by_global_norm``: the gradients scaled by ``max_norm /
    norm`` when their global norm, the square root of the summed squares,
    is at least ``max_norm`` (optax adds nothing to the norm;
    ``nn.utils.clip_grad_norm_`` adds 1e-6). Returns the norm before
    clipping, on the device, without waiting for it.
    ``params`` may live on several devices (tp slices): each parameter,
    replicated or a slice, counts once, and the norm is computed on the
    first one's device."""
    grads = [p.grad for p in params if p.grad is not None]
    dev = grads[0].device
    norm = torch.stack([widen(g).square().sum().to(dev) for g in grads]).sum().sqrt()
    # optax computes (g / norm) * max_norm; the branch stays on the device
    scale = torch.where(norm < max_norm, torch.ones_like(norm), norm / max_norm)
    for d in dict.fromkeys(g.device for g in grads):
        torch._foreach_div_([g for g in grads if g.device == d], scale.to(d))
    return norm


def init_state(model: nn.Module, lr: float, device: str | torch.device | None = None,
               generator: torch.Generator | None = None) -> TrainState:
    """A fresh state for ``model`` on ``device``: with ``generator``, the
    model is first drawn from flax's initializers (``model.init_flax_``);
    without it, the model keeps its weights (a loaded checkpoint)."""
    if generator is not None:
        model.init_flax_(generator)
    model.to(resolve_device(device))
    return TrainState(model, make_optimizer(model.parameters(), lr))


def to_device(batch: Mapping[str, np.ndarray], device: torch.device) -> dict:
    """An iterator's numpy batch as tensors on ``device`` (``HOST_KEYS``
    stay numpy). To the card the copy goes from pinned memory without
    waiting, so the host renders the next batch while the card runs this
    step (a pageable copy would first wait for the card's queue)."""
    def put(v: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    device = torch.device(device)
    return {k: v if k in HOST_KEYS else put(v) for k, v in batch.items()}


def shd_default_mesh(device: str | torch.device | None = None, spec: str = "dp=-1") -> Mesh:
    """The trainers' default mesh, ``spec`` over the trainer's device:
    every visible card for ``cuda`` without an index (JAX's every device),
    else that one device."""
    dev = resolve_device(device)
    return build_mesh(spec, None if dev.type == "cuda" and dev.index is None else [dev])


def sharded_terms(models: list[nn.Module], batch: dict, terms_fn: Callable,
                  mesh: Mesh | None) -> dict[str, torch.Tensor]:
    """``terms_fn(model, batch) -> {name: partial sum}`` over the batch
    split along dp, the shards in lockstep, shard i running ``models[i]``
    (``parallel.sharding.replicas``), each term summed over the shards on
    the mesh's first device (the model's)."""
    if mesh is None:
        return terms_fn(models[0], batch)
    host = {k: v for k, v in batch.items() if k in HOST_KEYS}
    shards = shard_batch(mesh, {k: v for k, v in batch.items() if k not in HOST_KEYS})
    parts = run_sharded(mesh, DATA_AXIS,
                        lambda shard: terms_fn(models[axis_index(DATA_AXIS)], {**shard, **host}),
                        shards)
    return {k: reduce_to([p[k] for p in parts], mesh.lead) for k in parts[0]}


def _train_step(terms_fn: Callable, finish: Callable, mesh: Mesh | None,
                prepare: Callable | None = None) -> Callable:
    """A step from ``terms_fn(model, batch) -> {name: partial sum}`` and
    ``finish(terms, batch) -> (loss, metrics)``: the terms over the dp
    shards (``sharded_terms``; every shard after the first runs a copy of
    the model holding this step's weights), the gradients (every copy's
    summed into the model's, the dp psum), the clip, the AdamW update.
    ``prepare(batch)`` adds what is drawn for the whole batch before it
    splits."""

    def step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        state.optimizer.zero_grad(set_to_none=True)
        if prepare is not None:
            batch = prepare(batch)
        models = [state.model] if mesh is None else replicas(state.model, mesh, DATA_AXIS)
        loss, metrics = finish(sharded_terms(models, batch, terms_fn, mesh), batch)
        loss.backward()
        reduce_replica_grads(models)
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        grad_norm = clip_by_global_norm_(params)
        state.optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm, **metrics}

    return step


# ---------------- recognizer ----------------


def rec_terms(model: nn.Module, batch: dict) -> dict[str, torch.Tensor]:
    """batch: images (B, H, W) gray uint8 (broadcast to the model's 3
    channels here), widths (B,), labels (B, L), label_lengths (B,). The sum
    of the lines' CTC losses."""
    images = to_unit(batch["images"])
    x = images[:, None].expand(-1, 3, -1, -1)
    logits, lengths = model.forward_nchw(x, batch["widths"], train=True)
    return {"ctc": ctc_line_losses(logits, lengths, batch["labels"],
                                   batch["label_lengths"]).sum()}


def make_rec_train_step(mesh: Mesh | None = None) -> Callable:
    """The rec step: the mean CTC loss over the global batch."""
    return _train_step(rec_terms,
                       lambda t, batch: (t["ctc"] / batch["images"].shape[0], {}), mesh)


def rec_batch_iterator(
    charset: Charset,
    batch_size: int,
    width: int = 320,
    max_label_len: int = 48,
    seed: int = 0,
    pool_size: int = 2048,
    refresh_per_step: int = 16,
    font_range: tuple[int, int] = (12, 38),
) -> Iterator[dict]:
    """Line-pool iterator, the JAX package's batch for batch at a seed: a
    refreshing pool of rendered lines, sampled per batch, so rendering does
    not hold back the device."""
    renderer = synth.TextRenderer(charset, seed=seed)
    rng = np.random.default_rng(seed)

    def render_one():
        for _ in range(8):
            sample = renderer.render_line(max_width=width, font_range=font_range)
            enc = charset.encode(sample.text)[:max_label_len] or [1]
            # CTC feasibility: one frame per label plus one blank between
            # each repeated pair; an infeasible line (a long dot leader
            # squeezed) gives a loss near 1e5 and noisy gradients: resample
            repeats = sum(a == b for a, b in zip(enc, enc[1:]))
            if len(enc) + repeats <= sample.width // 4:
                break
        labels = np.zeros((max_label_len,), np.int32)
        labels[: len(enc)] = enc
        return (
            (sample.image[..., 0] * 255).astype(np.uint8),  # gray wire
            np.int32(sample.width),
            labels,
            np.int32(len(enc)),
        )

    pool = [render_one() for _ in range(min(pool_size, 4 * batch_size))]
    while True:
        idxs = rng.integers(0, len(pool), batch_size)
        batch = [pool[i] for i in idxs]
        yield {
            "images": np.stack([b[0] for b in batch]),
            "widths": np.array([b[1] for b in batch], np.int32),
            "labels": np.stack([b[2] for b in batch]),
            "label_lengths": np.array([b[3] for b in batch], np.int32),
        }
        for _ in range(refresh_per_step):
            if len(pool) < pool_size:
                pool.append(render_one())
            else:
                pool[rng.integers(0, len(pool))] = render_one()


# ---------------- detector ----------------


def unpack_bits(packed: torch.Tensor, width: int) -> torch.Tensor:
    """(..., W/8) uint8 -> (..., W) float32 in {0, 1}, ``np.packbits``'s
    big-endian bit order."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)[..., :width].float()


def _upsample2x_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Doubles ``dim`` as ``jax.image.resize(method="bilinear")`` does on the
    CPU: half-pixel centres, output 2i from inputs i (0.75) and i - 1
    (0.25), 2i + 1 from i (0.75) and i + 1 (0.25), the edge outputs the
    edge input. XLA evaluates the pair as a dot whose lower-index product
    is rounded and whose higher-index product is fused into the sum; float64
    gives that single rounding on every device."""
    n = x.shape[dim]
    out = torch.arange(2 * n, device=x.device)
    near = out // 2
    far = torch.where(out % 2 == 0, (near - 1).clamp(min=0), (near + 1).clamp(max=n - 1))
    lo, hi = torch.minimum(near, far), torch.maximum(near, far)
    edge = near == far
    w_lo = torch.where(edge, 1.0, torch.where(near == lo, 0.75, 0.25))
    w_hi = torch.where(edge, 0.0, torch.where(near == hi, 0.75, 0.25))
    shape = [1] * x.dim()
    shape[dim] = -1
    x_lo, x_hi = x.index_select(dim, lo), x.index_select(dim, hi)
    first = (x_lo * w_lo.view(shape).float()).double()
    return (x_hi.double() * w_hi.view(shape).double() + first).float()


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """(B, n, n) -> (B, 2n, 2n), ``jax.image.resize(x, (B, 2n, 2n),
    "bilinear")`` (rows, then columns, as its einsum): bit for bit at the
    trainer's 640 and the tests' 64. XLA's CPU dot drops the fused
    multiply-add in the second pass at some other sizes (80, 96), so there
    it rounds otherwise."""
    return _upsample2x_axis(_upsample2x_axis(x, 1), 2)


def decode_det_wire(batch: dict) -> dict:
    """The det batch's wire format, decoded on the device, with the JAX
    step's bits (XLA multiplies by a constant's float32 reciprocal where
    the code divides by it):

      images      4-bit packed gray (B, S, S/2) -> (B, S, S) in [0, 1]
      thresh_map  stride-2 uint8 (B, S/2, S/2) -> /255, bilinear x2
      *_bits      bit-packed {0, 1} maps (B, S, S/8) -> (B, S, S)
    """
    packed = batch["images"]
    b, s = packed.shape[0], packed.shape[1]
    nib = torch.stack([packed >> 4, packed & 15], dim=-1).reshape(b, s, s).float()
    f = nib * torch.tensor(1.0 / 15.0, dtype=torch.float32, device=packed.device)
    return {
        "image": f,
        "thresh": upsample2x_bilinear(to_unit(batch["thresh_map"])),
        "shrink": unpack_bits(batch["shrink_bits"], s),
        "shrink_mask": unpack_bits(batch["smask_bits"], s),
        "thresh_mask": unpack_bits(batch["tmask_bits"], s),
    }


def augment_det(f: torch.Tensor, seed: int) -> torch.Tensor:
    """The JAX step's on-device augmentation, drawn from a torch.Generator
    seeded by the batch's ``noise_seed``: half the pages quantized to 4 gray
    levels (what a 2-bit det wire delivers), half given Gaussian noise of
    a std drawn up to 0.04, then clipped to [0, 1]."""
    return apply_augment(f, augment_draws(f.shape, seed, f.device))


def augment_draws(shape, seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The augmentation's random draws for a (B, S, S) batch: which pages
    quantize (B, 1, 1), and each page's noise (B, S, S), already scaled by
    its std and its coin. Drawn for the whole batch, so a dp step splits
    the same draws."""
    g = torch.Generator(device=device).manual_seed(seed)
    b = shape[0]

    def uniform():
        return torch.rand((b, 1, 1), generator=g, device=device)

    quantize = uniform() < 0.5
    std = uniform() * 0.04
    apply_noise = (uniform() < 0.5).float()
    noise = torch.randn(shape, generator=g, device=device) * std * apply_noise
    return {"aug_quantize": quantize, "aug_noise": noise}


def apply_augment(f: torch.Tensor, draws: dict) -> torch.Tensor:
    f = torch.where(draws["aug_quantize"], torch.round(f * 3.0) / 3.0, f)
    return (f + draws["aug_noise"]).clamp(0.0, 1.0)


def normalize_nchw(f: torch.Tensor) -> torch.Tensor:
    """(B, H, W) in [0, 1] -> (B, 3, H, W) ImageNet-normalized, as the JAX
    step's jitted ``normalize_for_model`` rounds (a multiply by each std's
    float32 reciprocal)."""
    mean = torch.tensor(NORM_MEAN, dtype=torch.float32, device=f.device).view(1, 3, 1, 1)
    inv = torch.from_numpy(np.float32(1.0) / np.array(NORM_STD, np.float32))
    return (f[:, None] - mean) * inv.to(f.device).view(1, 3, 1, 1)


def make_det_train_step(augment: bool = True, mesh: Mesh | None = None) -> Callable:
    """The det step; ``augment=False`` drops the augmentation (the parity
    tests and the card's check against the JAX record)."""
    from ocr_system_tpu_torch.models.dbnet import db_loss_finish, db_loss_terms

    def terms(model, batch):
        wire = decode_det_wire(batch)
        f = wire["image"]
        if augment:
            f = apply_augment(f, batch)
        out = model.forward_nchw(normalize_nchw(f), train=True)
        return db_loss_terms(out, wire["shrink"], wire["shrink_mask"], wire["thresh"],
                             wire["thresh_mask"])

    def prepare(batch):
        packed = batch["images"]
        s = packed.shape[1]
        seed = int(np.asarray(batch["noise_seed"])[0])
        return {**batch, **augment_draws((packed.shape[0], s, s), seed, packed.device)}

    return _train_step(terms, lambda t, batch: (db_loss_finish(t), {}), mesh,
                       prepare if augment else None)


def det_page_sources(s: int, charset: Charset | None = None, deva_fraction: float = 0.0):
    """One renderer's sources: a Latin text renderer, a form generator, a
    page-kind rng and, with ``deva_fraction``, a Devanagari renderer."""
    from ocr_system_tpu_torch.training import synth_forms as SF

    deva = None
    if deva_fraction > 0:
        # Devanagari pixel diversity: a DBNet trained on Latin pages only
        # misses whole rows of sparse small Hindi text
        deva = synth.TextRenderer(get_charset("devanagari"), seed=s + 7)
    return (synth.TextRenderer(charset or get_charset("latin"), seed=s),
            SF.FormGenerator(seed=s), np.random.default_rng(s), deva)


def det_render_one(sources, size: int, forms_fraction: float = 0.5,
                   deva_fraction: float = 0.0) -> tuple[np.ndarray, ...]:
    """One page in the wire format: half text pages, half forms (and a
    ``deva_fraction`` of Devanagari pages), unaugmented (the step adds noise
    on the device, so the page stays compressible)."""
    from ocr_system_tpu_torch.training import synth_forms as SF

    renderer, gen, r, deva = sources
    roll = r.random()
    if deva is not None and roll >= 1.0 - deva_fraction:
        page = deva.render_page(size=size, augment=False)
    elif roll >= forms_fraction:
        page = renderer.render_page(size=size, augment=False)
    else:
        page = SF.render_spec(gen.generate(size), augment=False)
    return det_wire(page)


def det_wire(page) -> tuple[np.ndarray, ...]:
    """A rendered page's wire format: 4-bit packed gray, the bit-packed
    shrink map and mask, the stride-2 uint8 threshold map, the bit-packed
    threshold mask."""
    def to_u8(a):
        return np.clip(a * 255.0, 0, 255).astype(np.uint8)

    def to_bits(a):
        return np.packbits(a > 0.5, axis=-1)

    g4 = to_u8(page.image[..., 0]) >> 4  # 16 gray levels
    return (
        (g4[:, 0::2] << 4 | g4[:, 1::2]).astype(np.uint8),
        to_bits(page.shrink_map), to_bits(page.shrink_mask),
        to_u8(page.thresh_map)[::2, ::2],
        to_bits(page.thresh_mask),
    )


def det_batch_iterator(
    batch_size: int,
    size: int = 640,
    seed: int = 0,
    charset: Charset | None = None,
    pool_size: int = 256,
    forms_fraction: float = 0.5,
    deva_fraction: float = 0.0,
) -> Iterator[dict]:
    """Page-pool iterator: rendering costs about a second a page, far more
    than a step, so batches sample a pool of pre-rendered pages that two
    background workers keep re-rendering. As in the JAX package the workers
    race, so the batch order is not deterministic; its parts are
    (``det_page_sources``, ``det_render_one``, ``det_wire``)."""
    rng = np.random.default_rng(seed)
    main_sources = det_page_sources(seed, charset, deva_fraction)
    pool = [det_render_one(main_sources, size, forms_fraction, deva_fraction)
            for _ in range(min(pool_size, 64))]
    lock = threading.Lock()
    stop = threading.Event()

    def worker(wid: int):
        sources = det_page_sources(seed + 104729 * (wid + 1), charset, deva_fraction)
        wrng = sources[2]
        while not stop.is_set():
            item = det_render_one(sources, size, forms_fraction, deva_fraction)
            with lock:
                if len(pool) < pool_size:
                    pool.append(item)
                else:
                    pool[wrng.integers(0, len(pool))] = item

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(2)]
    for t in threads:
        t.start()
    try:
        while True:
            with lock:
                idxs = rng.integers(0, len(pool), batch_size)
                batch = [pool[i] for i in idxs]
            yield {
                "images": np.stack([b[0] for b in batch]),
                "shrink_bits": np.stack([b[1] for b in batch]),
                "smask_bits": np.stack([b[2] for b in batch]),
                "thresh_map": np.stack([b[3] for b in batch]),
                "tmask_bits": np.stack([b[4] for b in batch]),
                "noise_seed": rng.integers(0, 1 << 31, batch_size).astype(np.int32),
            }
    finally:
        stop.set()


# ---------------- layout extractor ----------------


def make_layout_train_step(dtype: torch.dtype = torch.float32,
                           loss_dtype: torch.dtype | None = None,
                           mesh: Mesh | None = None) -> Callable:
    """The layout step at compute ``dtype``, the heads' cross-entropies in
    ``loss_dtype`` (default: the heads' own float32); metrics add
    ``tag_acc``. Loss and accuracy are masked means over the global batch."""
    from ocr_system_tpu_torch.models.layout_extractor import (
        extraction_loss_finish,
        extraction_loss_terms,
    )

    def terms(model, batch):
        out = model(batch["ids"].long(), batch["boxes"].long(), batch["mask"], dtype,
                    pos_offset=batch.get("pos_offset"))
        if loss_dtype is not None:
            out = {k: v.to(loss_dtype) for k, v in out.items()}
        t = extraction_loss_terms(out, batch["tags"], batch["types"], batch["form"],
                                  batch["mask"])
        m = batch["mask"].float()
        hit = (out["tag_logits"].argmax(-1) == batch["tags"]).float()
        return {**t, "hit": (hit * m).sum().detach()}

    def finish(t, batch):
        loss = extraction_loss_finish(t, batch["form"].shape[0])
        return loss, {"tag_acc": t["hit"] / t["tag_n"].clamp_min(1.0)}

    return _train_step(terms, finish, mesh)


def init_layout_state_sharded(model: nn.Module, lr: float, mesh: Mesh,
                              generator: torch.Generator | None = None) -> TrainState:
    """A layout state with its weights placed by their logical axes
    (``parallel.sharding.shard_params``: mlp and heads split over ``tp``,
    the rest on the mesh's first device); the optimizer is made on the
    placed weights, so AdamW's moments live beside their slices. With
    ``generator``, the model is first drawn from flax's initializers."""
    from ocr_system_tpu_torch.parallel.sharding import shard_params

    if generator is not None:
        model.init_flax_(generator)
    shard_params(model, mesh)
    return TrainState(model, make_optimizer(model.parameters(), lr))


def layout_batch_iterator(
    charset: Charset, batch_size: int, max_len: int = 512,
    page_size: int = 960, seed: int = 0, noise_rate: float = 0.03,
    pos_span: int = 2048, deva_fraction: float | None = None,
) -> Iterator[dict]:
    """Form-spec batches, the JAX package's batch for batch at a seed:
    synthetic forms tokenized directly (no pixels, ~200 forms/s), OCR noise
    injected tag-aligned, and ``pos_offset`` sliding each sample's position
    window so that all ``pos_span`` serving positions train."""
    from ocr_system_tpu_torch.training import synth_forms as SF

    gen = (
        SF.FormGenerator(seed=seed) if deva_fraction is None
        else SF.FormGenerator(seed=seed, deva_fraction=deva_fraction)
    )
    rng = random.Random(seed + 1)
    max_off = max(pos_span - max_len, 0)
    while True:
        ids = np.zeros((batch_size, max_len), np.int32)
        boxes = np.zeros((batch_size, max_len, 4), np.int32)
        mask = np.zeros((batch_size, max_len), np.int32)
        tags = np.zeros((batch_size, max_len), np.int32)
        types = np.zeros((batch_size, max_len), np.int32)
        form = np.zeros((batch_size,), np.int32)
        pos_offset = np.zeros((batch_size,), np.int32)
        for i in range(batch_size):
            spec = gen.generate(page_size)
            noise = rng.uniform(0, noise_rate * 2)  # clean .. 2x the mean
            (
                ids[i], boxes[i], mask[i], tags[i], types[i], form[i],
            ) = SF.spec_to_tokens(spec, charset, max_len, noise, rng, coord_jitter=True)
            pos_offset[i] = rng.randrange(max_off + 1)
        yield {
            "ids": ids, "boxes": boxes, "mask": mask,
            "tags": tags, "types": types, "form": form,
            "pos_offset": pos_offset,
        }


# ---------------- drivers ----------------


def _run(name: str, state: TrainState, step_fn: Callable, it: Iterator[dict], steps: int,
         log_every: int, keys: tuple[str, ...] = ("loss",),
         save: Callable[[int], None] | None = None) -> dict[str, list[torch.Tensor]]:
    """``steps`` steps from ``it``; the metrics stay on the device and are
    read at the log points only."""
    device = next(state.model.parameters()).device
    state.model.train()
    seen: dict[str, list[torch.Tensor]] = {k: [] for k in keys}
    t0 = time.time()
    for i in range(steps):
        state, metrics = step_fn(state, to_device(next(it), device))
        for k in keys:
            seen[k].append(metrics[k])
        if log_every and (i + 1) % log_every == 0:
            means = {k: torch.stack(v[-log_every:]).mean().item() for k, v in seen.items()}
            logger.info("%s step %d %s (%.2f steps/s)", name, i + 1,
                        " ".join(f"{k} {v:.4f}" for k, v in means.items()),
                        (i + 1) / (time.time() - t0))
        if save is not None:
            save(i + 1)
    return seen


def _mean_last(values: list[torch.Tensor], n: int) -> float:
    return torch.stack(values[-n:]).mean().item()


def train_recognizer(
    steps: int = 200,
    batch_size: int = 64,
    width: int = 320,
    charset_name: str = "latin",
    lr: float = 1e-3,
    policy: DTypePolicy | None = None,
    log_every: int = 50,
    seed: int = 0,
    state: TrainState | None = None,
    font_range: tuple[int, int] = (12, 38),
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> tuple[TrainState, dict]:
    """Train the SVTR recognizer on synthetic lines, the batch split over
    ``mesh``'s dp (default ``shd_default_mesh``). Returns (state,
    metrics). Without ``state``, the model starts from flax's initializers
    at ``seed``."""
    from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer

    charset = get_charset(charset_name)
    mesh = mesh or shd_default_mesh(device)
    if state is None:
        model = SVTRRecognizer(vocab_size=charset.size, policy=policy or default_policy())
        state = init_state(model, lr, mesh.lead, torch.Generator().manual_seed(seed))
    it = rec_batch_iterator(charset, batch_size, width=width, seed=seed, font_range=font_range)
    seen = _run("rec", state, make_rec_train_step(mesh), it, steps, log_every)
    losses = seen["loss"]
    return state, {"loss_first": losses[0].item(), "loss_last": _mean_last(losses, 10)}


def train_detector(
    steps: int = 100,
    batch_size: int = 4,
    size: int = 640,
    lr: float = 1e-3,
    policy: DTypePolicy | None = None,
    log_every: int = 20,
    seed: int = 0,
    state: TrainState | None = None,
    pool_size: int = 1024,
    save_every: int = 0,
    save_path: str | None = None,
    forms_fraction: float = 0.5,
    deva_fraction: float = 0.0,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> tuple[TrainState, dict]:
    """Train DBNet (with its threshold head) on synthetic pages, the batch
    split over ``mesh``'s dp (default ``shd_default_mesh``); with
    ``save_every`` and ``save_path``, a checkpoint every ``save_every``
    steps."""
    from ocr_system_tpu_torch.core.checkpoint import save_checkpoint
    from ocr_system_tpu_torch.models.dbnet import DBNet

    mesh = mesh or shd_default_mesh(device)
    if state is None:
        model = DBNet(policy=policy or default_policy(), thresh_head=True)
        state = init_state(model, lr, mesh.lead, torch.Generator().manual_seed(seed))
    it = det_batch_iterator(batch_size, size=size, seed=seed, pool_size=pool_size,
                            forms_fraction=forms_fraction, deva_fraction=deva_fraction)

    def save(i: int) -> None:
        if save_every and save_path and i % save_every == 0:
            save_checkpoint(save_path, state.model)
            logger.info("det checkpoint @ step %d -> %s", i, save_path)

    try:
        seen = _run("det", state, make_det_train_step(mesh=mesh), it, steps, log_every,
                    save=save)
    finally:
        it.close()  # stops the page workers
    losses = seen["loss"]
    return state, {"loss_first": losses[0].item(), "loss_last": _mean_last(losses, 5)}


def train_layout(
    steps: int = 200,
    batch_size: int = 32,
    max_len: int = 768,
    page_size: int = 960,
    charset_name: str = "multilingual",
    noise_rate: float = 0.03,
    lr: float = 3e-4,
    policy: DTypePolicy | None = None,
    log_every: int = 50,
    seed: int = 0,
    state: TrainState | None = None,
    dim: int = 256,
    depth: int = 6,
    deva_fraction: float | None = None,
    device: str | torch.device | None = None,
    mesh: Mesh | None = None,
) -> tuple[TrainState, dict]:
    """Train the layout extractor on streamed synthetic form specs, at the
    policy's compute dtype, the batch split over ``mesh``'s dp and the
    mlp and heads dimensions over its tp (default ``shd_default_mesh``,
    ``dp=-1,tp=1``)."""
    from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor

    charset = get_charset(charset_name)
    policy = policy or default_policy()
    mesh = mesh or shd_default_mesh(device, "dp=-1,tp=1")
    if state is None:
        model = LayoutExtractor(vocab_size=charset.size, dim=dim, depth=depth)
        state = init_layout_state_sharded(model, lr, mesh, torch.Generator().manual_seed(seed))
    it = layout_batch_iterator(charset, batch_size, max_len=max_len, page_size=page_size,
                               seed=seed, noise_rate=noise_rate,
                               pos_span=state.model.max_len, deva_fraction=deva_fraction)
    seen = _run("layout", state, make_layout_train_step(policy.compute_dtype, mesh=mesh), it,
                steps, log_every, keys=("loss", "tag_acc"))
    losses, accs = seen["loss"], seen["tag_acc"]
    return state, {"loss_first": losses[0].item(), "loss_last": _mean_last(losses, 10),
                   "tag_acc_last": _mean_last(accs, 10)}


# ---------------- records ----------------


def param_group(key: str) -> str:
    """A state-dict key's top-level group: its first name, or the first two
    where the second is a list index (``blocks.3``, ``stem.0``)."""
    parts = key.split(".")
    return ".".join(parts[:2]) if len(parts) > 2 and parts[1].isdigit() else parts[0]


def group_norms(state: Mapping[str, torch.Tensor]) -> dict[str, float]:
    """The L2 norm of each top-level parameter group (BatchNorm running
    statistics left out), in float64."""
    sums: dict[str, float] = {}
    for k, v in state.items():
        if k.rsplit(".", 1)[-1].startswith("running_"):
            continue
        g = param_group(k)
        sums[g] = sums.get(g, 0.0) + float(v.detach().double().square().sum())
    return {g: s ** 0.5 for g, s in sums.items()}
