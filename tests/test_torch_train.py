"""Training in the port against the JAX package on the CPU, at small sizes
(SVTR dim 32 depth 1, DBNet at 64 x 64, the layout model at 64 x 2):
flax-semantics BatchNorm in train mode, the CTC, DB and extraction losses,
the position-table windows, the clip + AdamW optimizer, one full step of
each trainer against ``jax.value_and_grad`` of the JAX composition on the
same converted weights, the det wire decode and augmentation. Data crosses
as numpy; each test names its tolerance. (Checkpoints, the entry point and
the from-scratch init: test_torch_train_cli.py.)"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ocr_system_tpu.core.dtypes import DTypePolicy as JaxPolicy
from ocr_system_tpu.models.dbnet import DBNet as JaxDBNet
from ocr_system_tpu.models.dbnet import db_loss as jax_db_loss
from ocr_system_tpu.models.layout_extractor import LayoutExtractor as JaxLayout
from ocr_system_tpu.models.layout_extractor import extraction_loss as jax_extraction_loss
from ocr_system_tpu.models.recognizer import SVTRRecognizer as JaxSVTR
from ocr_system_tpu.ops import ctc as jax_ctc
from ocr_system_tpu.ops.image_ops import normalize_for_model
from ocr_system_tpu.training import train as JT
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.dtypes import DTypePolicy
from ocr_system_tpu_torch.models.dbnet import DBNet, db_loss
from ocr_system_tpu_torch.models.layers import BatchNorm
from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor, extraction_loss
from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer
from ocr_system_tpu_torch.ops.ctc import ctc_loss
from ocr_system_tpu_torch.training import train as T

torch.set_num_threads(1)

F32 = JaxPolicy(compute_dtype=jnp.float32)
VOCAB = 40
# float32 through a forward and backward pass of a small model, on two
# implementations of the same arithmetic: within a few ulps, relatively
RTOL = 2e-5


def _close(got, want, rtol=RTOL, what=""):
    """|got - want| <= rtol * max(|want|) elementwise: a float32 relative
    tolerance on the scale of the array."""
    got, want = (np.asarray(x.detach().double() if isinstance(x, torch.Tensor) else x,
                            np.float64) for x in (got, want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: {err} > {rtol} x {scale}"


def _perturbed(variables, seed):
    """flax's init with every parameter and statistic moved at random
    (flax leaves BatchNorm at identity, which would hide a mix-up)."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        noise = rng.standard_normal(a.shape).astype(np.float32)
        if "var" in jax.tree_util.keystr(path):
            return np.abs(a) + 0.5 + np.abs(noise)
        return a + 0.1 * noise

    return jax.tree_util.tree_map_with_path(f, variables)


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _init(model, seed, *args, **kw):
    """flax's init, jitted (eager init of DBNet takes ~15 s on the CPU),
    with the logical-partitioning boxes of the layout model unwrapped."""
    v = jax.jit(lambda *a: model.init(jax.random.PRNGKey(seed), *a, **kw))(*args)
    return jax.tree.map(lambda a: np.asarray(getattr(a, "value", a)), v,
                        is_leaf=lambda a: hasattr(a, "value"))


def _to_device_batch(batch):
    return T.to_device(batch, torch.device("cpu"))


# ---------------- BatchNorm in train mode ----------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    """Output and updated running statistics of flax's nn.BatchNorm with
    mutable batch_stats. Tolerance: float32 2e-5 relative; bf16 output
    within one bf16 ulp (2^-7 relative) of flax's, statistics (float32
    in both) 2e-5."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 6, 5, 8)) * 3 + 1.5).astype(np.float32)  # NHWC
    jdt = getattr(jnp, dtype)
    bn = fnn.BatchNorm(dtype=jdt, param_dtype=jnp.float32)
    v = _perturbed(bn.init(jax.random.PRNGKey(0), jnp.asarray(x), use_running_average=False), 1)
    y, mut = bn.apply(v, jnp.asarray(x).astype(jdt), use_running_average=False,
                      mutable=["batch_stats"])
    port = BatchNorm(8)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in (
        ("weight", v["params"]["scale"]), ("bias", v["params"]["bias"]),
        ("running_mean", v["batch_stats"]["mean"]), ("running_var", v["batch_stats"]["var"]))})
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    got = port(xt, train=True).detach().float().permute(0, 2, 3, 1)
    _close(got, np.asarray(y, np.float32), RTOL if dtype == "float32" else 2.0 ** -7, "out")
    _close(port.running_mean, mut["batch_stats"]["mean"], what="mean")
    _close(port.running_var, mut["batch_stats"]["var"], what="var")
    # inference reads the running statistics, as before
    y_eval = bn.apply({"params": v["params"], "batch_stats": mut["batch_stats"]},
                      jnp.asarray(x).astype(jdt), use_running_average=True)
    got = port(xt).detach().float().permute(0, 2, 3, 1)
    _close(got, np.asarray(y_eval, np.float32), RTOL if dtype == "float32" else 2.0 ** -7)


# ---------------- losses ----------------


def _ctc_case():
    rng = np.random.default_rng(3)
    b, t, n = 5, 12, 6
    logits = (rng.standard_normal((b, t, VOCAB)) * 2).astype(np.float32)
    lengths = np.array([12, 10, 3, 12, 8], np.int32)
    label_lengths = np.array([4, 4, 5, 6, 2], np.int32)
    labels = rng.integers(1, VOCAB, (b, n)).astype(np.int32)
    labels[1, :4] = [2, 2, 2, 3]  # repeated labels
    # line 2: 5 labels in 3 steps, infeasible (optax floors log 0 at -1e5)
    for i in range(b):
        labels[i, label_lengths[i]:] = 0
    return logits, lengths, labels, label_lengths


@pytest.mark.parametrize("lines", [[0, 1, 3, 4], [2], [0, 1, 2, 3, 4]],
                         ids=["feasible", "infeasible", "mixed"])
def test_ctc_loss_matches_optax(lines):
    """Value and gradient of the mean per-line CTC loss, repeated labels and
    an infeasible line (loss ~1e5) included. Tolerance: value 2e-6
    relative; gradient 1e-6 absolute (the gradient is a probability
    difference, at most 1 in size)."""
    logits, lengths, labels, label_lengths = (a[lines] for a in _ctc_case())
    want, grad = jax.value_and_grad(lambda z: jax_ctc.ctc_loss(
        z, jnp.asarray(lengths), jnp.asarray(labels), jnp.asarray(label_lengths)))(
        jnp.asarray(logits))
    z = torch.tensor(logits, requires_grad=True)
    got = ctc_loss(z, torch.from_numpy(lengths), torch.from_numpy(labels),
                   torch.from_numpy(label_lengths))
    got.backward()
    assert abs(got.item() - float(want)) <= 2e-6 * abs(float(want))
    assert np.abs(z.grad.numpy() - np.asarray(grad)).max() <= 1e-6
    if 2 in lines:
        assert float(want) > 1e4  # the infeasible line, finite


def test_db_loss_matches_jax():
    """Value and gradients (prob, thresh, binary) of the DB loss on random
    maps and targets. Tolerance 2e-5 relative."""
    rng = np.random.default_rng(4)
    shape = (2, 16, 24)
    outs = {k: rng.uniform(0.01, 0.99, shape).astype(np.float32)
            for k in ("prob", "thresh", "binary")}
    gts = [(rng.random(shape) > p).astype(np.float32) for p in (0.7, 0.2)]
    gts.insert(2, rng.random(shape).astype(np.float32))
    gts.append((rng.random(shape) > 0.5).astype(np.float32))
    want, grads = jax.value_and_grad(lambda o: jax_db_loss(o, *map(jnp.asarray, gts)))(
        {k: jnp.asarray(v) for k, v in outs.items()})
    t = {k: torch.tensor(v, requires_grad=True) for k, v in outs.items()}
    got = db_loss(t, *map(torch.from_numpy, gts))
    got.backward()
    _close(got.item(), float(want), what="loss")
    for k in outs:
        _close(t[k].grad, grads[k], what=k)


def test_extraction_loss_matches_jax():
    """Value and gradients of the masked tag CE + type CE on non-O tokens +
    0.2 x form CE. Tolerance 2e-5 relative."""
    rng = np.random.default_rng(5)
    b, length = 3, 10
    outs = {"tag_logits": rng.standard_normal((b, length, 5)),
            "type_logits": rng.standard_normal((b, length, 7)),
            "form_logits": rng.standard_normal((b, 9))}
    outs = {k: v.astype(np.float32) for k, v in outs.items()}
    tags = rng.integers(0, 5, (b, length)).astype(np.int32)
    types = rng.integers(0, 7, (b, length)).astype(np.int32)
    form = rng.integers(0, 9, (b,)).astype(np.int32)
    mask = (rng.random((b, length)) > 0.3).astype(np.int32)
    labels = (tags, types, form, mask)
    want, grads = jax.value_and_grad(lambda o: jax_extraction_loss(o, *map(jnp.asarray, labels)))(
        {k: jnp.asarray(v) for k, v in outs.items()})
    t = {k: torch.tensor(v, requires_grad=True) for k, v in outs.items()}
    got = extraction_loss(t, *map(torch.from_numpy, labels))
    got.backward()
    _close(got.item(), float(want), what="loss")
    for k in outs:
        _close(t[k].grad, grads[k], what=k)


def test_pos_offset_windows():
    """Each sample reads its own window of the position table, clamped as
    jax.lax.dynamic_slice clamps; the outputs equal flax's with pos_offset.
    Tolerance 2e-5 relative."""
    jmodel = JaxLayout(vocab_size=VOCAB, dim=64, depth=2, heads=2, max_len=48, policy=F32)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, VOCAB, (3, 16)).astype(np.int32)
    boxes = rng.integers(0, 1024, (3, 16, 4)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    off = np.array([0, 17, 40], np.int32)  # the last clamps to 48 - 16
    v = _init(jmodel, 0, ids, boxes, mask)
    want = jmodel.apply(v, ids, boxes, mask, train=True, pos_offset=jnp.asarray(off))
    model = LayoutExtractor(VOCAB, dim=64, depth=2, heads=2, max_len=48)
    model.load_state_dict(weights.layout_state_dict(v))
    with torch.no_grad():
        got = model(*(torch.from_numpy(a).long() for a in (ids, boxes, mask)),
                    pos_offset=torch.from_numpy(off))
        pos = model.pos_embed[0]
        start = torch.tensor([0, 17, 32])
        win = pos[start[:, None] + torch.arange(16)]
        assert torch.equal(win[2], pos[32:48])
    for k in want:
        _close(got[k], want[k], what=k)


# ---------------- the optimizer ----------------


def test_clip_adamw_matches_optax_over_5_steps():
    """optax's chain(clip_by_global_norm(1.0), adamw(1e-3, weight_decay=
    1e-4)) against the port's clip + AdamW on the same gradients over 5
    steps, norms above and below the clip. Tolerance: the global norm 1e-6
    relative; the parameters within 2 float32 ulps of optax's after 5
    steps (the two round the same AdamW update in another order)."""
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    scales = [3.0, 0.2, 1.5, 0.01, 0.7]  # global norms from ~10 to ~0.03
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in scales]
    opt = JT.make_optimizer(1e-3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = T.make_optimizer(list(tp.values()), 1e-3)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norm = T.clip_by_global_norm_(list(tp.values()))
        assert abs(norm.item() - float(optax.global_norm(g))) <= 1e-6 * norm.item()
        topt.step()
        for k in params:
            want = np.asarray(jp[k])
            assert (np.abs(tp[k].detach().numpy() - want) <= 2 * np.abs(np.spacing(want))).all(), k


# ---------------- one full step of each trainer ----------------


def _assert_grads(got: dict, want_state: dict, what: str):
    """Every gradient leaf of the JAX tree, converted, against the port's
    parameter gradients before the clip: within 1e-4 of the leaf's scale,
    or 1e-6 of the largest gradient for a leaf that is zero in exact
    arithmetic (an attention key bias) and holds rounding noise in both."""
    want = {k: want_state[k] for k in got}
    top = max(np.abs(np.asarray(w)).max() for w in want.values())
    for k, g in got.items():
        w = np.asarray(want[k], np.float64)
        err = np.abs(g.detach().double().numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-6 * top, f"{what} grad {k}: {err}"


def _grads_before_clip(monkeypatch, model) -> dict:
    """The parameters' gradients as the step's clip receives them."""
    seen: dict = {}
    orig = T.clip_by_global_norm_

    def clip(params, *a):  # an unused head has no gradient: zero in JAX
        seen.update({n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
                     for n, p in model.named_parameters()})
        return orig(params, *a)

    monkeypatch.setattr(T, "clip_by_global_norm_", clip)
    return seen


def _assert_state(model, want_state, want_grads, lr, what):
    """The state after one step against the JAX update: within 1e-5 of each
    tensor's scale, except where the JAX gradient is rounding noise (below
    1e-5 of the largest gradient: zero in exact arithmetic, as a key bias's
    or a bias before a BatchNorm on batch statistics). There AdamW's first
    step, lr * g / (|g| + eps), is +-lr by the noise's sign in either
    package, so the two may be 2 lr apart."""
    got = model.state_dict()
    assert set(got) == set(want_state), set(got) ^ set(want_state)
    top = max(np.abs(np.asarray(g)).max() for g in want_grads.values())
    for k, v in want_state.items():
        w = np.asarray(v, np.float64)
        err = np.abs(got[k].double().numpy() - w)
        noise = np.abs(np.asarray(want_grads[k])) <= 1e-5 * top if k in want_grads else False
        limit = np.where(noise, 2.05 * lr, 1e-5 * np.abs(w).max())
        assert (err <= limit).all(), f"{what} {k}: {err.max()}"


def _jax_update(loss_fn, params, stats, batch, lr):
    """The JAX package's update: value_and_grad of the composition, then its
    make_optimizer chain."""
    (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, stats, batch)
    opt = JT.make_optimizer(lr)
    upd, _ = opt.update(grads, opt.init(params), params)
    return loss, aux, grads, optax.apply_updates(params, upd)


def _rec_batch(rng, b=4, width=64):
    images = rng.integers(0, 256, (b, 48, width)).astype(np.uint8)
    widths = np.array([64, 40, 64, 17][:b], np.int32)
    labels = np.zeros((b, 8), np.int32)
    label_lengths = np.array([3, 5, 8, 4][:b], np.int32)
    for i, n in enumerate(label_lengths):
        labels[i, :n] = rng.integers(1, VOCAB, n)
    labels[3, :4] = [7, 7, 7, 7]  # 4 labels, 3 repeats, in 5 steps: infeasible
    return {"images": images, "widths": widths, "labels": labels,
            "label_lengths": label_lengths}


def test_rec_step_matches_jax(monkeypatch):
    """One rec step (SVTR dim 32, depth 1, width 64; the last line, 17 px
    wide, is infeasible) against value_and_grad of SVTRRecognizer.apply +
    ctc_loss: loss, every gradient, the updated parameters and BatchNorm
    statistics. Tolerance: loss and statistics 2e-5, gradients 1e-4
    relative to each leaf's scale, parameters 1e-5."""
    rng = np.random.default_rng(8)
    batch = _rec_batch(rng)
    jm = JaxSVTR(vocab_size=VOCAB, dim=32, depth=1, heads=2, policy=F32)
    v = _perturbed(_init(jm, 0, jnp.zeros((1, 48, 64, 3)), jnp.array([64])), 2)

    def loss_fn(params, stats, b):
        images = jnp.repeat((b["images"].astype(jnp.float32) / 255.0)[..., None], 3, -1)
        (logits, lengths), mut = jm.apply({"params": params, "batch_stats": stats}, images,
                                          b["widths"], train=True, mutable=["batch_stats"])
        return jax_ctc.ctc_loss(logits, lengths, b["labels"], b["label_lengths"]), \
            mut["batch_stats"]

    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    loss, stats, grads, new = jax.jit(lambda p, s, b: _jax_update(loss_fn, p, s, b, 1e-3))(
        v["params"], v["batch_stats"], jb)
    model = SVTRRecognizer(VOCAB, dim=32, depth=1, heads=2,
                           policy=DTypePolicy(compute_dtype=torch.float32))
    model.load_state_dict(weights.svtr_state_dict(v))
    seen = _grads_before_clip(monkeypatch, model)
    state = T.init_state(model, 1e-3, "cpu")
    state, metrics = T.make_rec_train_step()(state, _to_device_batch(batch))
    _close(metrics["loss"].item(), float(loss), what="loss")
    want_g = weights.svtr_state_dict({"params": _np_tree(grads), "batch_stats": _np_tree(stats)})
    _assert_grads(seen, want_g, "rec")
    _assert_state(model, weights.svtr_state_dict({"params": _np_tree(new),
                                                  "batch_stats": _np_tree(stats)}), want_g,
                  1e-3, "rec")


def _det_batch(rng, b=2, s=64):
    shrink = rng.random((b, s, s)) > 0.8
    return {
        "images": rng.integers(0, 256, (b, s, s // 2)).astype(np.uint8),
        "shrink_bits": np.packbits(shrink, axis=-1),
        "smask_bits": np.packbits(rng.random((b, s, s)) > 0.1, axis=-1),
        "thresh_map": rng.integers(0, 256, (b, s // 2, s // 2)).astype(np.uint8),
        "tmask_bits": np.packbits(rng.random((b, s, s)) > 0.5, axis=-1),
        "noise_seed": rng.integers(0, 1 << 31, b).astype(np.int32),
    }


def _jax_det_decode(batch):
    """The wire decode lines of the JAX det step (make_det_train_step)."""
    packed = batch["images"]
    b, s = packed.shape[0], packed.shape[1]
    hi = (packed >> 4).astype(jnp.float32)
    lo = (packed & 15).astype(jnp.float32)
    f = jnp.stack([hi, lo], axis=-1).reshape(b, s, s) / 15.0
    thresh = jax.image.resize(batch["thresh_map"].astype(jnp.float32) / 255.0, (b, s, s),
                              method="bilinear")
    return {"image": f, "thresh": thresh,
            "shrink": JT._unpack_bits(batch["shrink_bits"], s),
            "shrink_mask": JT._unpack_bits(batch["smask_bits"], s),
            "thresh_mask": JT._unpack_bits(batch["tmask_bits"], s)}


@pytest.mark.parametrize("side", [64, 640])
def test_det_wire_decode_bit_for_bit(side):
    """The 4-bit gray unpack, the /15 and /255 scalings as XLA rounds them,
    np.packbits' bit order and the x2 bilinear upsampling of the stride-2
    threshold map (jax.image.resize): bit for bit the jitted JAX lines, at
    the trainer's 640 and at the tests' 64. (XLA's CPU dot rounds the
    upsampling's second pass without a fused multiply-add at some other
    sizes, 80 and 96 among them, so there it differs from itself.)"""
    batch = _det_batch(np.random.default_rng(9), 3, side)
    want = jax.jit(_jax_det_decode)({k: jnp.asarray(v) for k, v in batch.items()})
    got = T.decode_det_wire(_to_device_batch(batch))
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), np.asarray(v)), k
    norm = jax.jit(jax.vmap(normalize_for_model))(want["image"])
    assert np.array_equal(T.normalize_nchw(got["image"]).permute(0, 2, 3, 1).numpy(),
                          np.asarray(norm))


def test_det_step_matches_jax(monkeypatch):
    """One det step at 64 x 64 without augmentation against value_and_grad
    of DBNet.apply + db_loss + normalize_for_model on the decoded wire:
    loss, every gradient (threshold head included), the updated parameters
    and BatchNorm statistics (the projections' stay: the reference runs
    them on their running statistics). Tolerance as the rec step's."""
    rng = np.random.default_rng(10)
    batch = _det_batch(rng)
    jm = JaxDBNet(policy=F32)
    v = _perturbed(_init(jm, 1, jnp.zeros((1, 64, 64, 3)), train=True), 3)

    def loss_fn(params, stats, b):
        wire = _jax_det_decode(b)
        out, mut = jm.apply({"params": params, "batch_stats": stats},
                            jax.vmap(normalize_for_model)(wire["image"]), train=True,
                            mutable=["batch_stats"])
        loss = jax_db_loss(out, wire["shrink"], wire["shrink_mask"], wire["thresh"],
                           wire["thresh_mask"])
        return loss, mut["batch_stats"]

    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    loss, stats, grads, new = jax.jit(lambda p, s, b: _jax_update(loss_fn, p, s, b, 1e-3))(
        v["params"], v["batch_stats"], jb)
    model = DBNet(policy=DTypePolicy(compute_dtype=torch.float32), thresh_head=True)
    model.load_state_dict(weights.dbnet_state_dict(v, thresh_head=True))
    seen = _grads_before_clip(monkeypatch, model)
    state = T.init_state(model, 1e-3, "cpu")
    state, metrics = T.make_det_train_step(augment=False)(state, _to_device_batch(batch))
    _close(metrics["loss"].item(), float(loss), what="loss")
    want_g = weights.dbnet_state_dict({"params": _np_tree(grads), "batch_stats": _np_tree(stats)},
                                      thresh_head=True)
    _assert_grads(seen, want_g, "det")
    _assert_state(model, weights.dbnet_state_dict({"params": _np_tree(new),
                                                   "batch_stats": _np_tree(stats)},
                                                  thresh_head=True), want_g, 1e-3, "det")


def _layout_batch(rng, b=3, length=24):
    mask = np.ones((b, length), np.int32)
    mask[1, 15:] = 0
    return {"ids": rng.integers(0, VOCAB, (b, length)).astype(np.int32),
            "boxes": rng.integers(0, 1024, (b, length, 4)).astype(np.int32),
            "mask": mask, "tags": rng.integers(0, 5, (b, length)).astype(np.int32),
            "types": rng.integers(0, 7, (b, length)).astype(np.int32),
            "form": rng.integers(0, 9, (b,)).astype(np.int32),
            "pos_offset": rng.integers(0, 40, (b,)).astype(np.int32)}


def test_layout_step_matches_jax(monkeypatch):
    """One layout step (64 x 2) with pos_offset through the JAX package's
    make_layout_train_step, and its gradients through value_and_grad of
    LayoutExtractor.apply + extraction_loss: loss, tag accuracy, every
    gradient, the updated parameters. Tolerance as the rec step's."""
    rng = np.random.default_rng(11)
    batch = _layout_batch(rng)
    jm = JaxLayout(vocab_size=VOCAB, dim=64, depth=2, heads=2, max_len=64, policy=F32)
    v = _init(jm, 2, jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8, 4), jnp.int32),
              jnp.ones((1, 8), jnp.int32))
    params = _perturbed(v["params"], 4)

    def loss_fn(p, stats, b):
        out = jm.apply({"params": p}, b["ids"], b["boxes"], b["mask"], train=True,
                       pos_offset=b["pos_offset"])
        return jax_extraction_loss(out, b["tags"], b["types"], b["form"], b["mask"]), stats

    jb = {k: jnp.asarray(a) for k, a in batch.items()}
    loss, _, grads, _ = jax.jit(lambda p, b: _jax_update(loss_fn, p, {}, b, 3e-4))(params, jb)
    opt = JT.make_optimizer(3e-4)
    jstate = JT.TrainState(params, {}, opt.init(params), 0)
    jstate, jmetrics = JT.make_layout_train_step(jm, opt, None)(jstate, jb)
    model = LayoutExtractor(VOCAB, dim=64, depth=2, heads=2, max_len=64)
    model.load_state_dict(weights.layout_state_dict({"params": params}))
    seen = _grads_before_clip(monkeypatch, model)
    state = T.init_state(model, 3e-4, "cpu")
    state, metrics = T.make_layout_train_step(torch.float32)(state, _to_device_batch(batch))
    _close(metrics["loss"].item(), float(loss), what="loss")
    _close(metrics["loss"].item(), float(jmetrics["loss"]), what="loss, JAX step")
    assert metrics["tag_acc"].item() == pytest.approx(float(jmetrics["tag_acc"]), abs=1e-6)
    want_g = weights.layout_state_dict({"params": _np_tree(grads)})
    _assert_grads(seen, want_g, "layout")
    _assert_state(model, weights.layout_state_dict({"params": _np_tree(jstate.params)}), want_g,
                  3e-4, "layout")


# ---------------- the float64 reference ----------------


def _small_trainer(name, dtype):
    """A small model of each trainer at compute ``dtype``, its step
    function and a batch."""
    policy = DTypePolicy(compute_dtype=dtype)
    rng = np.random.default_rng(21)
    if name == "rec":
        model = SVTRRecognizer(VOCAB, dim=32, depth=1, heads=2, policy=policy)
        batch = _rec_batch(rng)
        # one label on the 17 px line: feasible (an infeasible line's
        # -1e5 floor has a float32 ulp of 0.008, float32's own error there)
        batch["label_lengths"][3] = 1
        return model, T.make_rec_train_step(), batch
    if name == "det":
        return (DBNet(policy=policy, thresh_head=True), T.make_det_train_step(augment=False),
                _det_batch(rng))
    return (LayoutExtractor(VOCAB, dim=64, depth=2, heads=2, max_len=64),
            T.make_layout_train_step(dtype), _layout_batch(rng))


@pytest.mark.parametrize("name", ["rec", "det", "layout"])
def test_float64_step_is_an_exact_reference(name):
    """One step at float64 (parameters and optimizer widened, and with them
    the policy's float32 islands: statistics, heads, losses), the exact
    reference of chip_smoke.py's float32 training phases, against the same
    step at float32 from the same weights: the loss a float64 tensor, every
    parameter and statistic float64 after the step, loss and gradient norm
    within float32's rounding (RTOL)."""
    m32, step32, batch = _small_trainer(name, torch.float32)
    m32.init_flax_(torch.Generator().manual_seed(3))
    m64, step64, _ = _small_trainer(name, torch.float64)
    m64.load_state_dict(m32.state_dict())
    m64.double()
    b = _to_device_batch(batch)
    _, r32 = step32(T.init_state(m32, 1e-3, "cpu"), b)
    _, r64 = step64(T.init_state(m64, 1e-3, "cpu"), b)
    assert r64["loss"].dtype == torch.float64
    assert all(v.dtype == torch.float64 for v in m64.state_dict().values()
               if v.is_floating_point())
    for key in ("loss", "grad_norm"):
        _close(r32[key].item(), r64[key].item(), what=key)


def test_layout_loss_dtype():
    """The layout step with its heads' cross-entropy in float64 (the cause
    run of chip_smoke.py's layout phase): a float64 loss within float32's
    rounding of the float32 step's (RTOL)."""
    model, step32, batch = _small_trainer("layout", torch.float32)
    model.init_flax_(torch.Generator().manual_seed(3))
    b = _to_device_batch(batch)
    fn = T.make_layout_train_step(torch.float32, torch.float64)
    twin, _, _ = _small_trainer("layout", torch.float32)
    twin.load_state_dict(model.state_dict())
    _, r64 = fn(T.init_state(model, 3e-4, "cpu"), b)
    _, r32 = step32(T.init_state(twin, 3e-4, "cpu"), b)
    assert r64["loss"].dtype == torch.float64 and r32["loss"].dtype == torch.float32
    _close(r32["loss"].item(), r64["loss"].item(), what="loss")


# ---------------- augmentation ----------------


def test_det_augmentation_statistics():
    """The on-device augmentation by its statistics over 400 pages drawn
    from 50 seeds (the JAX PRNG cannot be matched): about half the pages
    quantized to 4 levels, about half noised, the noise std uniform on
    [0, 0.04], values clipped to [0, 1], the same seed the same pages."""
    f = torch.from_numpy(np.random.default_rng(12).random((8, 64, 64)).astype(np.float32))
    quantized = noised = 0
    stds = []
    for seed in range(50):
        out = T.augment_det(f, seed)
        assert torch.equal(out, T.augment_det(f, seed))
        assert out.min() >= 0 and out.max() <= 1
        for i in range(8):
            q = torch.round(f[i] * 3) / 3
            base = q if (out[i] - q).abs().max() < (out[i] - f[i]).abs().max() else f[i]
            quantized += base is q
            d = out[i] - base
            inside = (base > 0.2) & (base < 0.8)  # no clipping there
            if d.abs().max() > 0:
                noised += 1
                stds.append(d[inside].std().item())
    assert 0.4 < quantized / 400 < 0.6 and 0.4 < noised / 400 < 0.6
    assert max(stds) <= 0.04 * 1.1 and 0.015 < np.mean(stds) < 0.025
