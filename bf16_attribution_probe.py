#!/usr/bin/env python3
"""Where the port's two bf16 gaps against the JAX package's bf16 records come
from, on the card.

    python3 bf16_attribution_probe.py                  # the H100, ~3 min
    python3 bf16_attribution_probe.py --device cpu --pages 1 --layout-n 2

The JAX package's bf16 records were made by XLA's CPU backend, whose bf16
graph rounds at points of its own (read from the compiled HLO of the JAX
models at a small size): it keeps a convolution's output in float32 into
the BatchNorm that follows, rounds after every elementwise op of a
hard-swish, a hard-sigmoid and a tanh GELU (whose constants it takes in
bf16), rounds a dense layer's or a transposed convolution's product before
adding the bias, and hands a LayerNorm the unrounded float32 sum of the
residual stream (the embedding sum's last add, each residual add) while
the next add reads it rounded. PyTorch rounds each op's result once. The
variants below emulate one of these points each (``DET_VARIANTS``,
``LAYOUT_VARIANTS``; "xla_cpu" all of them) by patching the port's module
methods for one run.

Hindi pages (the mixed wave of ``chip_smoke.py``, served engine at every
serving default): (a) the share of the port's own float32 Hindi words that
its bf16 run matches, beside the JAX package's bf16-against-float32 share;
(b) the port's bf16 recognition, per-crop routing and rescues on the JAX
bf16 record's word polygons (and, as the control, its float32 on the JAX
float32 polygons), held against the JAX record's words: if the texts then
reach 95%, the gap is in detection; (c) each DBNet variant's Hindi share
against the JAX bf16 words, and the Latin wave's and the mixed wave's
shares and box shares (the ``mixed_bf16``/``hybrid_bf16`` gates of
``chip_smoke.py``, ``utils/smoke.BF16_WORD_SHARE``).

Layout training: the 3 committed bf16 steps of ``chip_smoke.py``'s
``train_layout_bfloat16`` phase under each layout variant, their losses
against both JAX bf16 records (``assets/train_expected.json``: XLA as it
is; ``assets/train_spread.json`` ``bfloat16_strict``: every op rounded),
and the served bf16 extraction's fields on the 17 committed documents
under the same variant (``chip_smoke.phase_extract``'s count against the
JAX bf16 record).

Prints one JSON line per measurement, then the card's name and power
limit. Needs no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import types
from contextlib import contextmanager

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

DET_VARIANTS = ("as_is", "xla_hardswish", "xla_se", "xla_head", "f32_conv_into_bn", "xla_cpu")
LAYOUT_VARIANTS = ("as_is", "emb_f32", "res_f32", "gelu_xla", "dense_xla", "xla_cpu")


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


# ---- DBNet under XLA's CPU rounding points ----

def _hardswish_xla(a):
    # round(a + 3), clamp, round(t * float32(1/6)) (XLA's rewrite of / 6),
    # round(a * that): one rounding per op, as the HLO
    return a * ((a + 3).clamp(0, 6) * (1.0 / 6.0))


def _hardsigmoid_xla(s):
    return (s + 3).clamp(0, 6) * (1.0 / 6.0)


def _conv_bn_act(self, x, train=False, *, f32conv, xla_hs):
    import torch
    import torch.nn.functional as F

    from ocr_system_tpu_torch.models.layers import same_pads

    if f32conv and x.dtype == torch.bfloat16:
        # the product of bf16 values accumulated in float32 and kept there
        # into the BatchNorm; rounded once after it
        c = self.conv
        (pt, pb), (pl, pr) = (same_pads(n, k, s) for n, k, s in
                              zip(x.shape[-2:], c.kernel_size, c.stride))
        y = F.conv2d(F.pad(x.float(), (pl, pr, pt, pb)), c.weight.to(x.dtype).float(), None,
                     c.stride, 0, 1, c.groups)
        y = self.bn(y, train).to(x.dtype)
    else:
        y = self.bn(self.conv(x), train)
    if not self.act:
        return y
    return _hardswish_xla(y) if xla_hs else F.hardswish(y)


def _conv_then_bias(conv, z):
    import torch.nn.functional as F

    y = F.conv2d(z, conv.weight.to(z.dtype), None)
    return y + conv.bias.to(z.dtype)[None, :, None, None]


def _se(self, x):
    import torch.nn.functional as F

    s = x.mean(dim=(2, 3), keepdim=True)
    s = _conv_then_bias(self.expand, F.relu(_conv_then_bias(self.reduce, s)))
    return x * _hardsigmoid_xla(s)


def _head(self, x, train=False):
    import torch
    import torch.nn.functional as F

    x = self.conv(x, train)
    y = F.conv_transpose2d(x, self.up1.weight.to(x.dtype), None, stride=2)
    y = y.float() + self.up1.bias.to(x.dtype).float()[None, :, None, None]
    x = F.relu(self.bn(y, train).to(x.dtype))
    y = F.conv_transpose2d(x, self.up2.weight.to(x.dtype), None, stride=2)
    y = y.float() + self.up2.bias.to(x.dtype).float()[None, :, None, None]
    return torch.sigmoid(y)[:, 0]


@contextmanager
def det_variant(model, name: str):
    """The DBNet ``model`` with XLA's CPU rounding at the points ``name``
    names, for the duration."""
    from ocr_system_tpu_torch.models import backbone as bb
    from ocr_system_tpu_torch.models import dbnet as db

    full = name == "xla_cpu"
    f32conv = full or name == "f32_conv_into_bn"
    xla_hs = full or name == "xla_hardswish"
    patched = []
    for m in model.modules():
        fn = None
        if isinstance(m, bb.ConvBNAct) and (f32conv or xla_hs):
            fn = types.MethodType(
                lambda self, x, train=False: _conv_bn_act(self, x, train, f32conv=f32conv,
                                                          xla_hs=xla_hs), m)
        elif isinstance(m, bb.SqueezeExcite) and (full or name == "xla_se"):
            fn = types.MethodType(_se, m)
        elif isinstance(m, db._Head) and (full or name == "xla_head"):
            fn = types.MethodType(_head, m)
        if fn is not None:
            m.forward = fn
            patched.append(m)
    try:
        yield
    finally:
        for m in patched:
            del m.forward


# ---- the layout transformer under XLA's CPU rounding points ----

def _gelu_xla(y):
    # jax.nn.gelu(approximate=True) in bf16 as XLA's CPU graph computes it:
    # its constants in bf16, one rounding per op
    import torch

    c1 = float(torch.tensor(0.044715, dtype=torch.bfloat16))
    c2 = float(torch.tensor((2.0 / np.pi) ** 0.5, dtype=torch.bfloat16))
    cube = (y * y) * y
    inner = (y + cube * c1) * c2
    return y * ((torch.tanh(inner) + 1.0) * 0.5)


def _dense_xla(dense, x):
    import torch.nn.functional as F

    return F.linear(x, dense.weight.to(x.dtype)) + dense.bias.to(x.dtype)


def _block(self, x, bias, mask, *, v: set, dt):
    """Block.forward's dense path; ``x`` may arrive as the float32 sum
    (``emb_f32``/``res_f32``): the LayerNorm reads it so, the residual add
    reads it rounded."""
    import torch.nn.functional as F

    from ocr_system_tpu_torch.models.layout_extractor import _attention

    dense = (lambda m, z: _dense_xla(m, z)) if "dense_xla" in v else (lambda m, z: m(z))
    b, t, d = x.shape
    h = self.heads
    qkv = dense(self.qkv, self.norm1(x).to(dt))
    q, k, vv = (z.reshape(b, t, h, d // h) for z in qkv.split(d, dim=-1))
    y = dense(self.proj, _attention(q, k, vv, bias).reshape(b, t, d))
    x = x.to(dt).float() + y.float() if "res_f32" in v else x.to(dt) + y
    y = dense(self.up, self.norm2(x).to(dt))
    y = _gelu_xla(y) if "gelu_xla" in v else F.gelu(y, approximate="tanh")
    y = dense(self.down, y)
    return x.to(dt).float() + y.float() if "res_f32" in v else x.to(dt) + y


def _extractor(self, token_ids, boxes, mask, dtype=None, pos_offset=None, *, v: set):
    import torch

    from ocr_system_tpu_torch.core.dtypes import widen
    from ocr_system_tpu_torch.models.layout_extractor import MASK_BIAS

    dtype = dtype or torch.float32
    mask = mask.bool()

    def coord(i):
        return self.coord_embed(boxes[..., i]).to(dtype)

    x = self.tok_embed(token_ids).to(dtype)
    x = x + coord(0) + coord(1)
    x = x + coord(2) + coord(3)
    t = x.shape[1]
    if pos_offset is None:
        pos = self.pos_embed[:, :t]
    else:
        start = pos_offset.long().clamp(0, self.max_len - t)
        pos = self.pos_embed[0][start[:, None] + torch.arange(t, device=x.device)]
    x = x.float() + pos.to(dtype).float() if "emb_f32" in v else x + pos.to(dtype)
    bias = torch.zeros(mask.shape, dtype=dtype, device=x.device).masked_fill(
        ~mask, MASK_BIAS)[:, None, None, :]
    for blk in self.blocks:
        x = _block(blk, x, bias, mask, v=v, dt=dtype)
    x = self.norm(x).to(dtype)
    dense = (lambda m, z: _dense_xla(m, z)) if "dense_xla" in v else (lambda m, z: m(z))
    conf = torch.sigmoid(dense(self.conf_head, x))[..., 0]
    m = mask[..., None].to(dtype)
    denom = mask.sum(dim=1, keepdim=True).clamp_min(1).to(dtype)
    form_logits = dense(self.form_head, (x * m).sum(dim=1) / denom)
    return {"tag_logits": widen(dense(self.tag_head, x)),
            "type_logits": widen(dense(self.type_head, x)),
            "form_logits": widen(form_logits), "confidence": widen(conf)}


@contextmanager
def layout_variant(name: str):
    """Every LayoutExtractor with XLA's CPU rounding at the points ``name``
    names, for the duration (class-level: the trainers build their own)."""
    from ocr_system_tpu_torch.models import layout_extractor as le

    if name == "as_is":
        yield
        return
    v = set(LAYOUT_VARIANTS[1:-1]) if name == "xla_cpu" else {name}
    saved = le.LayoutExtractor.forward
    le.LayoutExtractor.forward = lambda self, *a, **kw: _extractor(self, *a, v=v, **kw)
    try:
        yield
    finally:
        le.LayoutExtractor.forward = saved


# ---- the Hindi pages ----

def hindi_share(records: list[dict], expected: list[dict], n: int) -> dict:
    """Of the first ``n`` pages' expected words, those a record's word
    matches (IoU >= 0.9, texts alike with dot-leader runs of any length),
    and those a record's box covers."""
    from ocr_system_tpu_torch.utils.smoke import compare_to_expected, same_text

    rows = [compare_to_expected(e, r) for e, r in zip(expected[:n], records[:n])]
    words = sum(r["words"] for r in rows)
    return {"words": words, "matched": sum(r["matched_leaders"] for r in rows),
            "share": sum(r["matched_leaders"] for r in rows) / max(words, 1),
            "boxes": sum(r["boxes_matched"] for r in rows),
            "misses": [{"page": k + 1, "expected": m["expected"]["content"],
                        "got": None if m["got"] is None else m["got"]["content"]}
                       for k, r in enumerate(rows) for m in r["misses"]
                       if m["got"] is None or not same_text(m["got"]["content"],
                                                            m["expected"]["content"], True)]}


def wave_records(engine, pages) -> list[dict]:
    from ocr_system_tpu_torch.utils.smoke import page_record

    outs = engine.process_pages(pages)
    return [page_record(*r) for r in zip(outs, engine.routed, engine.rescued)]


def on_polygons(engine, pages, expected: list[dict]) -> list[dict]:
    """The engine's recognition, per-crop script routing, rescues, glue
    split and finishing on the expected records' word polygons in place of
    its own boxes (the pages deskewed and the canvases uploaded by its own
    det stage)."""
    from ocr_system_tpu_torch.engine import script as script_mod
    from ocr_system_tpu_torch.engine.pipeline import box_recognizers
    from ocr_system_tpu_torch.ops.boxes import DetectedBox
    from ocr_system_tpu_torch.utils.smoke import page_record

    dets = engine.detector.detect_batch([p.pixels for p in pages])
    for d, rec in zip(dets, expected):
        d.boxes = [DetectedBox(quad=np.asarray(w["polygon"], np.float32).reshape(4, 2),
                               score=1.0) for w in rec["word"]]
        gray = script_mod._to_gray(d.gray if d.gray is not None else d.page)
        d.routing = [engine.devanagari if script_mod.crop_script(
            script_mod._crop_aabb(gray, b.quad)) == "devanagari" else engine.recognizer
            for b in d.boxes]
    outs = engine.rec_stage(pages, dets)
    return [page_record(o, box_recognizers(d), r)
            for o, d, r in zip(outs, dets, engine.rescued)]


def probe_hindi(dev, n_hindi: int | None) -> None:
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.utils import smoke

    forms, expected = smoke.smoke_forms()
    hindi = smoke.hindi_forms()[:n_hindi]
    n = len(hindi)
    # a rehearsal's cut wave is its Hindi pages alone
    latin = forms[:expected["mixed_latin"]] if n_hindi is None else []
    mixed = [PageImage(np.ascontiguousarray(p), i + 1) for i, p in enumerate([*hindi, *latin])]
    want = expected["mixed"]
    e32 = smoke.build_engine(dev, **expected["settings"], compute_dtype="float32")
    e16 = smoke.build_engine(dev, **expected["settings"], compute_dtype="bfloat16")
    e16.process_pages(mixed[:1])  # first call: cuDNN/cuBLAS set-up
    r32, r16 = wave_records(e32, mixed), wave_records(e16, mixed)
    emit({"probe": "hindi_a", "hindi_pages": n,
          "port_f32_vs_jax_f32": hindi_share(r32, want["float32"], n),
          "port_bf16_vs_port_f32": hindi_share(r16, r32, n),
          "port_bf16_vs_jax_bf16": hindi_share(r16, want["bfloat16"], n),
          "jax_bf16_vs_jax_f32": hindi_share(want["bfloat16"], want["float32"], n)})
    hp = mixed[:n]
    emit({"probe": "hindi_b", "hindi_pages": n,
          "port_bf16_on_jax_bf16_polygons": hindi_share(
              on_polygons(e16, hp, want["bfloat16"][:n]), want["bfloat16"], n),
          "port_f32_on_jax_f32_polygons": hindi_share(
              on_polygons(e32, hp, want["float32"][:n]), want["float32"], n)})
    latin_pages = [PageImage(np.ascontiguousarray(p), i + 1)
                   for i, p in enumerate(forms if n_hindi is None else forms[:1])]
    model = e16.detector.neural.model
    for name in DET_VARIANTS:
        t = time.perf_counter()
        with det_variant(model, name):
            rm = wave_records(e16, mixed)
            rl = wave_records(e16, latin_pages)
        k = len(mixed)
        emit({"probe": "hindi_c", "variant": name,
              "hindi_vs_jax_bf16": hindi_share(rm, want["bfloat16"], n),
              "hindi_vs_port_f32": hindi_share(rm, r32, n),
              "mixed_vs_jax_bf16": hindi_share(rm, want["bfloat16"], k),
              "latin_vs_jax_bf16": hindi_share(rl, expected["pages"]["bfloat16"],
                                               len(latin_pages)),
              "s": time.perf_counter() - t})


def probe_layout(dev, n: int | None) -> None:
    import chip_smoke
    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.extract.layout_model import get_extractor
    from ocr_system_tpu_torch.training import train as T
    from ocr_system_tpu_torch.utils import smoke

    expected, strict = smoke.train_expected(), smoke.train_spread()["bfloat16_strict"]
    want = expected["bfloat16"]["layout"]
    batch = smoke.train_batches()["layout"]
    if n is not None:
        batch = {k: v[:n] for k, v in batch.items()}
    batch = T.to_device(batch, dev)
    start = smoke.train_start("layout")
    lr, steps = expected["lr"]["layout"], expected["steps"]
    docs = smoke.extract_documents(smoke.smoke_forms()[1])
    want_ex = smoke.extract_expected()["docs"]["bfloat16"]
    ex = get_extractor(Settings(compute_dtype="bfloat16"), device=dev)
    for name in LAYOUT_VARIANTS:
        with layout_variant(name):
            got, _, ms = chip_smoke.train_run("layout", "bfloat16", dev, batch, start, lr,
                                              steps, want)
            try:
                fields = chip_smoke.phase_extract(ex, docs, want_ex, f"extract_{name}", False,
                                                  min_share=0.0, buckets=())
                fields = {k: fields[k] for k in ("fields_matched", "fields_expected")}
            except Exception as e:  # noqa: BLE001 - reported, not raised
                fields = {"error": repr(e)}
        emit({"probe": "layout", "variant": name, "loss": got["loss"],
              "jax_bf16_loss": want["loss"], "jax_strict_loss": strict["layout"]["loss"],
              "vs_jax_bf16": [a / b - 1 for a, b in zip(got["loss"], want["loss"])],
              "vs_jax_strict": [a / b - 1 for a, b in zip(got["loss"],
                                                          strict["layout"]["loss"])],
              "grad_norm": got["grad_norm"][0], "jax_bf16_grad_norm": want["grad_norm"][0],
              "extraction_bf16": fields, "step_ms": ms})
    # the JAX records' own spread at step 1: the two bf16 records, and each
    # against the float32 record
    f32 = expected["float32"]["layout"]["loss"][0]
    emit({"probe": "layout_reference", "jax_bf16_vs_f32": want["loss"][0] / f32 - 1,
          "jax_strict_vs_f32": strict["layout"]["loss"][0] / f32 - 1,
          "jax_strict_vs_bf16": strict["layout"]["loss"][0] / want["loss"][0] - 1})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pages", type=int, default=None, help="Hindi pages (rehearsal)")
    ap.add_argument("--layout-n", type=int, default=None, help="layout samples (rehearsal)")
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("bf16_attribution_probe: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    probe_hindi(dev, args.pages)
    probe_layout(dev, args.layout_n)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
