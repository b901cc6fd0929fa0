"""Plain float32 references of the three models the served path runs:
the DBNet detector, the SVTR recognizer and the layout transformer.

Written from the architectures' equations as plain ``torch`` functions over
state dicts read straight from the committed ``.npz`` weight files. They
import nothing of the program. Every convolution and matrix product takes
its inputs through ``Precision.q``: the identity for the reference, and for
the control (the precision below the configurations' bfloat16) a
per-tensor-scaled float8 (e4m3) round trip, with every tensor in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value


class Precision:
    """How the reference computes: ``FP32`` is float32 throughout; ``FP8``
    is the control, the step below the configurations' bfloat16: tensors
    in bfloat16 as the program keeps them, and every convolution's and
    matrix product's inputs rounded to float8 e4m3 with one scale per
    tensor."""

    def __init__(self, dtype: torch.dtype = torch.float32, fp8: bool = False):
        self.dtype = dtype
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        amax = x.detach().abs().amax().float()
        scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
        return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)

    def cast(self, sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """A state dict in this precision's tensor dtype."""
        return sd if self.dtype == torch.float32 else {k: v.to(self.dtype) for k, v in sd.items()}


FP32 = Precision()
FP8 = Precision(torch.bfloat16, fp8=True)


def set_exact_float32() -> None:
    """TF32 off for convolutions and matrix products, so float32 means
    float32 on the card."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def load_state(path: str, device: str | torch.device) -> dict[str, torch.Tensor]:
    """A weight ``.npz`` as float32 tensors. Keys ending in ``:bf16`` hold
    a bfloat16 tensor as its uint16 bit pattern; its float32 value is the
    pattern shifted to the high half."""
    out: dict[str, torch.Tensor] = {}
    with np.load(path) as z:
        for k in z.files:
            a = z[k]
            if k.endswith(":bf16"):
                a = (a.astype(np.uint32) << 16).view(np.float32)
                k = k[: -len(":bf16")]
            out[k] = torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
    return out


# ---- shared layers ----

def _same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """SAME padding: output ceil(n / s), an odd total pad's extra pixel at
    the end."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv(sd, p: str, x, prec: Precision, stride=1, groups: int = 1):
    w = sd[p + ".weight"]
    b = sd.get(p + ".bias")
    st = (stride, stride) if isinstance(stride, int) else stride
    (pt, pb), (pl, pr) = (_same_pads(n, k, s)
                          for n, k, s in zip(x.shape[-2:], w.shape[-2:], st))
    x = F.pad(x, (pl, pr, pt, pb))
    return F.conv2d(prec.q(x), prec.q(w), b, st, 0, 1, groups)


def batch_norm(sd, p: str, x):
    """Inference BatchNorm on the running statistics, eps 1e-5."""
    shape = (1, -1, 1, 1)
    mul = torch.rsqrt(sd[p + ".running_var"] + 1e-5) * sd[p + ".weight"]
    return (x - sd[p + ".running_mean"].view(shape)) * mul.view(shape) + sd[p + ".bias"].view(shape)


def conv_bn_act(sd, p: str, x, prec: Precision, stride=1, groups: int = 1, act: bool = True):
    y = batch_norm(sd, p + ".bn", conv(sd, p + ".conv", x, prec, stride, groups))
    return F.hardswish(y) if act else y


def linear(sd, p: str, x, prec: Precision):
    return F.linear(prec.q(x), prec.q(sd[p + ".weight"]), sd[p + ".bias"])


def layer_norm(sd, p: str, x):
    return F.layer_norm(x, x.shape[-1:], sd[p + ".weight"], sd[p + ".bias"], 1e-6)


# ---- DBNet ----

# MobileNetV3-style stages: output features, inverted residuals per stage
DB_STAGES = ((16, 24, 56, 120), (1, 2, 3, 3))


def _repeat2d(x, s: int):
    return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)


def dbnet_prob(sd, x, prec: Precision = FP32):
    """(B, 3, H, W) normalised page -> (B, H, W) text probability: a
    backbone of inverted residuals (squeeze-excite from the third stage),
    a top-down FPN to stride 4, and a head of a 3x3 conv and two 2x2
    transposed convolutions to full resolution, then a sigmoid."""
    x = conv_bn_act(sd, "backbone.stem", x, prec, 2)
    feats, cin, i = [], 16, 0
    for si, (f, depth) in enumerate(zip(*DB_STAGES)):
        for bi in range(depth):
            stride = 2 if bi == 0 else 1
            p = f"backbone.blocks.{i}"
            h = conv_bn_act(sd, p + ".expand_conv", x, prec)
            h = conv_bn_act(sd, p + ".depthwise", h, prec, stride, groups=h.shape[1])
            if si >= 2:
                s = h.mean(dim=(2, 3), keepdim=True)
                s = conv(sd, p + ".se.expand", F.relu(conv(sd, p + ".se.reduce", s, prec)), prec)
                h = h * F.hardsigmoid(s)
            h = conv_bn_act(sd, p + ".project", h, prec, act=False)
            x = h + x if stride == 1 and cin == f else h
            cin, i = f, i + 1
        feats.append(x)
    lat = [conv_bn_act(sd, f"neck.lateral.{j}", f, prec) for j, f in enumerate(feats)]
    for j in range(len(lat) - 2, -1, -1):
        hh, ww = lat[j].shape[-2:]
        lat[j] = lat[j] + _repeat2d(lat[j + 1], 2)[..., :hh, :ww]
    hh, ww = lat[0].shape[-2:]
    outs = []
    for j, f in enumerate(lat):
        f = conv_bn_act(sd, f"neck.smooth.{j}", f, prec)
        outs.append(_repeat2d(f, 2**j)[..., :hh, :ww] if j else f)
    x = conv_bn_act(sd, "prob_head.conv", torch.cat(outs, dim=1), prec)
    x = F.conv_transpose2d(prec.q(x), prec.q(sd["prob_head.up1.weight"]),
                           sd["prob_head.up1.bias"], stride=2)
    x = F.relu(batch_norm(sd, "prob_head.bn", x))
    x = F.conv_transpose2d(prec.q(x), prec.q(sd["prob_head.up2.weight"]),
                           sd["prob_head.up2.bias"], stride=2)
    return torch.sigmoid(x)[:, 0]


# ---- SVTR recognizer ----

SVTR_HEADS = 6


def svtr_logits(sd, x, widths, prec: Precision = FP32):
    """(B, 3, 48, W) crops in [0, 1] and (B,) valid pixel widths -> (B, T,
    V) logits and (B,) valid steps, T = W / 4: three strided conv stages
    that collapse the height, a learned position table, pre-norm
    transformer blocks whose attention masks the keys past each crop's
    width, a final LayerNorm and the CTC projection."""
    w_in = x.shape[-1]
    for j, stride in enumerate(((2, 2), (2, 2), (2, 1))):
        x = conv_bn_act(sd, f"stem.{j}", x, prec, stride)
    x = x.mean(dim=2).transpose(1, 2)
    b, t, d = x.shape
    lengths = torch.ceil(widths.float() / (w_in / t)).to(torch.int64).clamp(1, t)
    mask = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
    x = x + sd["pos_embed"][:, :t]
    hd = d // SVTR_HEADS
    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    for i in range(n_blocks):
        p = f"blocks.{i}"
        h = layer_norm(sd, p + ".norm1", x)

        def split(z):
            return z.view(b, t, SVTR_HEADS, hd).transpose(1, 2)

        q = split(linear(sd, p + ".query", h, prec)) / math.sqrt(hd)
        k = split(linear(sd, p + ".key", h, prec))
        v = split(linear(sd, p + ".value", h, prec))
        att = prec.q(q) @ prec.q(k).transpose(-1, -2)
        att = att.masked_fill(~mask[:, None, None, :], torch.finfo(att.dtype).min)
        y = prec.q(torch.softmax(att, dim=-1)) @ prec.q(v)
        x = x + linear(sd, p + ".out", y.transpose(1, 2).reshape(b, t, d), prec)
        h = F.gelu(linear(sd, p + ".fc1", layer_norm(sd, p + ".norm2", x), prec),
                   approximate="tanh")
        x = x + linear(sd, p + ".fc2", h, prec)
    x = layer_norm(sd, "norm", x)
    return linear(sd, "head", x, prec), lengths


# ---- layout transformer ----

LAYOUT_HEADS = 8
MASK_BIAS = -1e9


def layout_tag_logits(sd, ids, boxes, mask, prec: Precision = FP32):
    """(B, L) character ids, (B, L, 4) quantized word boxes, (B, L) mask ->
    (B, L, 5) BIO tag logits: token plus four coordinate embeddings plus
    positions, pre-norm blocks of fused-QKV attention (an additive -1e9 on
    masked keys) and a tanh-GELU MLP, a final LayerNorm and the tag head."""
    ce = sd["coord_embed.weight"]
    x = sd["tok_embed.weight"][ids]
    for i in range(4):
        x = x + ce[boxes[..., i]]
    b, t, d = x.shape
    x = x + sd["pos_embed"][:, :t]
    bias = torch.zeros(mask.shape, device=x.device, dtype=x.dtype).masked_fill(
        ~mask.bool(), MASK_BIAS)
    bias = bias[:, None, None, :]
    hd = d // LAYOUT_HEADS
    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("blocks."))
    for i in range(n_blocks):
        p = f"blocks.{i}"
        qkv = linear(sd, p + ".qkv", layer_norm(sd, p + ".norm1", x), prec)
        q, k, v = (z.reshape(b, t, LAYOUT_HEADS, hd).transpose(1, 2)
                   for z in qkv.split(d, dim=-1))
        att = (prec.q(q) @ prec.q(k).transpose(-1, -2)) * hd**-0.5
        y = prec.q(torch.softmax(att + bias, dim=-1)) @ prec.q(v)
        x = x + linear(sd, p + ".proj", y.transpose(1, 2).reshape(b, t, d), prec)
        h = F.gelu(linear(sd, p + ".up", layer_norm(sd, p + ".norm2", x), prec),
                   approximate="tanh")
        x = x + linear(sd, p + ".down", h, prec)
    return linear(sd, "tag_head", layer_norm(sd, "norm", x), prec)
