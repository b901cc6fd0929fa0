"""Weight conversion from the JAX package's parameter trees (port of the
loading half of ocr_system_tpu/core/checkpoint.py; no orbax here).

The converters take flax variable trees as nested dicts of numpy arrays
(``{"params": ..., "batch_stats": ...}``) and return state dicts for the
port's modules. Conversion rules, each checked by the parity tests:

- conv kernels HWIO -> OIHW (depthwise convs keep I = 1 and use ``groups``);
- flax ``ConvTranspose`` kernels are the spatial flip of torch's, and torch
  stores them (in, out, kh, kw);
- ``Dense`` kernels (in, out) -> (out, in); ``DenseGeneral`` attention
  kernels (D, H, hd) and (H, hd, D) flatten the head axes;
- BatchNorm ``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``.

Train-only parameters (DBNet's ``thresh_head``) are ignored.
``save_npz``/``load_npz`` keep a flat numpy copy of a state dict (numpy has
no bf16: a bf16 tensor is stored as its uint16 bit pattern under its key
plus ``BF16_SUFFIX``); ``load_weights`` fills a model from one of those,
or with seeded random weights.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ocr_system_tpu_torch.models.layers import init_random_

logger = logging.getLogger(__name__)

Tree = Mapping[str, Any]


def _a(x) -> np.ndarray:
    return np.array(x, dtype=np.float32)  # a writable copy


def _conv(p: Tree) -> dict[str, np.ndarray]:
    out = {"weight": _a(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out["bias"] = _a(p["bias"])
    return out


def _conv_transpose(p: Tree) -> dict[str, np.ndarray]:
    k = _a(p["kernel"])[::-1, ::-1]  # (kh, kw, in, out), flipped
    return {"weight": k.transpose(2, 3, 0, 1), "bias": _a(p["bias"])}


def _dense(p: Tree) -> dict[str, np.ndarray]:
    k = _a(p["kernel"])
    return {"weight": k.reshape(k.shape[0], -1).T,
            "bias": _a(p["bias"]).reshape(-1)}


def _bn(p: Tree, s: Tree) -> dict[str, np.ndarray]:
    return {
        "weight": _a(p["scale"]), "bias": _a(p["bias"]),
        "running_mean": _a(s["mean"]), "running_var": _a(s["var"]),
    }


def _ln(p: Tree) -> dict[str, np.ndarray]:
    return {"weight": _a(p["scale"]), "bias": _a(p["bias"])}


def _prefixed(prefix: str, d: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    return {f"{prefix}.{k}": v for k, v in d.items()}


def _conv_bn_act(p: Tree, s: Tree) -> dict[str, np.ndarray]:
    return {
        **_prefixed("conv", _conv(p["Conv_0"])),
        **_prefixed("bn", _bn(p["BatchNorm_0"], s["BatchNorm_0"])),
    }


def _inverted_residual(p: Tree, s: Tree) -> dict[str, np.ndarray]:
    out = {}
    for name, flax_name in (("expand_conv", "ConvBNAct_0"),
                            ("depthwise", "ConvBNAct_1"),
                            ("project", "ConvBNAct_2")):
        out.update(_prefixed(name, _conv_bn_act(p[flax_name], s[flax_name])))
    if "SqueezeExcite_0" in p:
        se = p["SqueezeExcite_0"]
        out.update(_prefixed("se.reduce", _conv(se["Conv_0"])))
        out.update(_prefixed("se.expand", _conv(se["Conv_1"])))
    return out


def dbnet_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """flax DBNet variables -> ``models.dbnet.DBNet`` state dict."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict[str, np.ndarray] = {}
    bp, bs = p["Backbone_0"], s["Backbone_0"]
    out.update(_prefixed("backbone.stem", _conv_bn_act(
        bp["ConvBNAct_0"], bs["ConvBNAct_0"])))
    i = 0
    while f"InvertedResidual_{i}" in bp:
        name = f"InvertedResidual_{i}"
        out.update(_prefixed(f"backbone.blocks.{i}",
                             _inverted_residual(bp[name], bs[name])))
        i += 1
    npl, nsl = p["FPNNeck_0"], s["FPNNeck_0"]
    for j in range(4):
        for k, part in ((j, "lateral"), (j + 4, "smooth")):
            name = f"ConvBNAct_{k}"
            out.update(_prefixed(f"neck.{part}.{j}",
                                 _conv_bn_act(npl[name], nsl[name])))
    hp, hs = p["prob_head"], s["prob_head"]
    out.update(_prefixed("prob_head.conv", _conv_bn_act(
        hp["ConvBNAct_0"], hs["ConvBNAct_0"])))
    out.update(_prefixed("prob_head.up1", _conv_transpose(hp["ConvTranspose_0"])))
    out.update(_prefixed("prob_head.bn", _bn(hp["BatchNorm_0"], hs["BatchNorm_0"])))
    out.update(_prefixed("prob_head.up2", _conv_transpose(hp["ConvTranspose_1"])))
    return _to_torch(out)


def svtr_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """flax SVTRRecognizer variables -> ``models.recognizer.SVTRRecognizer``
    state dict."""
    p, s = variables["params"], variables["batch_stats"]
    out: dict[str, np.ndarray] = {}
    for i in range(3):
        name = f"ConvBNAct_{i}"
        out.update(_prefixed(f"stem.{i}", _conv_bn_act(p[name], s[name])))
    out["pos_embed"] = _a(p["pos_embed"])
    i = 0
    while f"MixerBlock_{i}" in p:
        blk = p[f"MixerBlock_{i}"]
        pre = f"blocks.{i}"
        attn = blk["MultiHeadDotProductAttention_0"]
        out.update(_prefixed(f"{pre}.norm1", _ln(blk["LayerNorm_0"])))
        out.update(_prefixed(f"{pre}.norm2", _ln(blk["LayerNorm_1"])))
        for name in ("query", "key", "value"):
            out.update(_prefixed(f"{pre}.{name}", _dense(attn[name])))
        o = _a(attn["out"]["kernel"])  # (H, hd, D)
        out[f"{pre}.out.weight"] = o.reshape(-1, o.shape[-1]).T
        out[f"{pre}.out.bias"] = _a(attn["out"]["bias"])
        out.update(_prefixed(f"{pre}.fc1", _dense(blk["Dense_0"])))
        out.update(_prefixed(f"{pre}.fc2", _dense(blk["Dense_1"])))
        i += 1
    out.update(_prefixed("norm", _ln(p["LayerNorm_0"])))
    out.update(_prefixed("head", _dense(p["Dense_0"])))
    return _to_torch(out)


def layout_state_dict(variables: Tree) -> dict[str, torch.Tensor]:
    """flax LayoutExtractor variables ->
    ``models.layout_extractor.LayoutExtractor`` state dict."""
    p = variables["params"]
    out: dict[str, np.ndarray] = {
        "tok_embed.weight": _a(p["tok_embed"]["embedding"]),
        "coord_embed.weight": _a(p["coord_embed"]["embedding"]),
        "pos_embed": _a(p["pos_embed"]),
    }
    i = 0
    while f"block{i}" in p:
        blk = p[f"block{i}"]
        pre = f"blocks.{i}"
        out.update(_prefixed(f"{pre}.norm1", _ln(blk["LayerNorm_0"])))
        out.update(_prefixed(f"{pre}.norm2", _ln(blk["LayerNorm_1"])))
        for name in ("qkv", "proj", "up", "down"):
            out.update(_prefixed(f"{pre}.{name}", _dense(blk[name])))
        i += 1
    out.update(_prefixed("norm", _ln(p["LayerNorm_0"])))
    for name in ("tag_head", "type_head", "conf_head", "form_head"):
        out.update(_prefixed(name, _dense(p[name])))
    return _to_torch(out)


def bf16_but_norms(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Every tensor rounded to bf16 but LayerNorm's (modules ``norm*``),
    which stay float32: what a flax module at ``dtype=bfloat16,
    param_dtype=float32`` computes with, so a model at bf16 compute reads
    the same values from this copy as from the float32 one."""
    return {k: v if _is_norm(k) else v.to(torch.bfloat16)
            for k, v in state.items()}


def _is_norm(key: str) -> bool:
    parts = key.split(".")
    return len(parts) >= 2 and parts[-2].startswith("norm")


def _to_torch(d: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


BF16_SUFFIX = ":bf16"


def save_npz(path: str | Path, state: Mapping[str, torch.Tensor]) -> Path:
    """Flat, zip-deflated numpy copy of a state dict (one array per key; a
    bf16 tensor as its uint16 bit pattern under ``key + BF16_SUFFIX``)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for k, v in state.items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            arrays[k + BF16_SUFFIX] = v.view(torch.int16).numpy().view(np.uint16)
        else:
            arrays[k] = v.numpy()
    np.savez_compressed(path, **arrays)
    return path


def load_npz(path: str | Path) -> dict[str, torch.Tensor]:
    out = {}
    with np.load(Path(path)) as z:
        for k in z.files:
            a = z[k].copy()
            if k.endswith(BF16_SUFFIX):
                out[k[: -len(BF16_SUFFIX)]] = torch.from_numpy(a.view(np.int16)).view(
                    torch.bfloat16)
            else:
                out[k] = torch.from_numpy(a)
    return out


def load_weights(model: torch.nn.Module, checkpoint: str, state_dict, seed: int) -> None:
    """``state_dict`` if given; else ``checkpoint`` as a ``save_npz`` file;
    else seeded random weights (logged, as the JAX engines do)."""
    if state_dict is None and checkpoint:
        if not checkpoint.endswith(".npz"):
            raise ValueError(
                f"checkpoint {checkpoint!r}: the torch port reads the .npz "
                "copies written by core/weights.save_npz, not orbax"
            )
        state_dict = load_npz(checkpoint)
    if state_dict is None:
        logger.warning("no checkpoint set; using RANDOM init (seed %d)", seed)
        init_random_(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
