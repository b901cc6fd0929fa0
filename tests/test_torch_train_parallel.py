"""The port's train steps over a mesh against the JAX package's steps on
the same mesh, on the CPU: a dp=4 recognizer step, a dp=4 detector step
(augmentation off, as test_det_step_matches_jax) and a dp=2 x tp=2 layout
step, the JAX steps jitted over a dp-sharded batch on the JAX 8-device CPU
mesh and the port's on meshes of repeated ``cpu`` devices, from the same
converted weights and seeded batches. Each is held at
test_torch_train.py's RTOL (2e-5): loss, global gradient norm, every
gradient, the updated parameters and the global BatchNorm running
statistics; so a BatchNorm on a shard's statistics, or a loss averaged
over the shards' means, fails. One layout case gives the two dp shards
unequal token counts, and checks that an average of the shards' masked
means misses the global one by far more than RTOL."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ocr_system_tpu.core.mesh import build_mesh as jax_build_mesh
from ocr_system_tpu.models.dbnet import DBNet as JaxDBNet
from ocr_system_tpu.models.dbnet import db_loss as jax_db_loss
from ocr_system_tpu.models.layout_extractor import LayoutExtractor as JaxLayout
from ocr_system_tpu.models.layout_extractor import extraction_loss as jax_extraction_loss
from ocr_system_tpu.models.recognizer import SVTRRecognizer as JaxSVTR
from ocr_system_tpu.ops import ctc as jax_ctc
from ocr_system_tpu.ops.image_ops import normalize_for_model
from ocr_system_tpu.parallel import sharding as jshd
from ocr_system_tpu.training import train as JT
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.dtypes import DTypePolicy
from ocr_system_tpu_torch.core.mesh import build_mesh
from ocr_system_tpu_torch.models.dbnet import DBNet
from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor
from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer
from ocr_system_tpu_torch.parallel.sharding import ShardedDense, dense_state_dict
from ocr_system_tpu_torch.training import train as T

from test_torch_train import (
    F32,
    RTOL,
    VOCAB,
    _assert_grads,
    _close,
    _det_batch,
    _init,
    _jax_det_decode,
    _layout_batch,
    _np_tree,
    _perturbed,
)

torch.set_num_threads(1)

# the global gradient norm is held at the gradients' tolerance
# (test_torch_train._assert_grads): the one-device det step's norm is
# already 4.2e-5 from JAX's (2.270733 against 2.270829)
GRAD_RTOL = 1e-4


def _sharded(jmesh, batch):
    return {k: jax.device_put(jnp.asarray(a), NamedSharding(jmesh, P("dp", *[None] * (a.ndim - 1))))
            for k, a in batch.items()}


def _jax_grads(loss_fn, params, stats, batch, jmesh):
    """Loss, auxiliary output and gradients of the JAX composition, jitted
    over the dp-sharded batch (the parameters replicated)."""
    repl = NamedSharding(jmesh, P())
    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True),
                 in_shardings=(repl, repl, jax.tree.map(lambda _: NamedSharding(jmesh, P("dp")),
                                                        batch)))
    (loss, aux), grads = fn(params, stats, _sharded(jmesh, batch))
    return float(loss), aux, grads


def _capture_grads(monkeypatch, model) -> dict:
    """The gradients as the step's clip receives them, in the unsharded
    model's keys (tp slices gathered)."""
    seen: dict = {}
    orig = T.clip_by_global_norm_

    def clip(params, *a):
        twin = copy.deepcopy(model)
        for p, q in zip(model.parameters(), twin.parameters()):
            q.data = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
        seen.update({k: v for k, v in dense_state_dict(twin).items()
                     if not k.rsplit(".", 1)[-1].startswith("running_")})
        return orig(params, *a)

    monkeypatch.setattr(T, "clip_by_global_norm_", clip)
    return seen


def _assert_state_dict(got: dict, want_state: dict, want_grads: dict, lr: float, what: str):
    """As test_torch_train._assert_state, on a state dict."""
    assert set(got) == set(want_state), set(got) ^ set(want_state)
    top = max(np.abs(np.asarray(g)).max() for g in want_grads.values())
    for k, v in want_state.items():
        w = np.asarray(v, np.float64)
        err = np.abs(got[k].double().numpy() - w)
        noise = np.abs(np.asarray(want_grads[k])) <= 1e-5 * top if k in want_grads else False
        limit = np.where(noise, 2.05 * lr, 1e-5 * np.abs(w).max())
        assert (err <= limit).all(), f"{what} {k}: {err.max()}"


def _rec_batch8(rng):
    b = 8
    lengths = np.array([3, 5, 8, 4, 2, 6, 1, 7], np.int32)
    labels = np.zeros((b, 8), np.int32)
    for i, n in enumerate(lengths):
        labels[i, :n] = rng.integers(1, VOCAB, n)
    return {"images": rng.integers(0, 256, (b, 48, 64)).astype(np.uint8),
            "widths": np.array([64, 40, 64, 17, 33, 64, 25, 58], np.int32),
            "labels": labels, "label_lengths": lengths}


def test_rec_step_dp4_matches_jax(monkeypatch):
    """A dp=4 rec step (SVTR dim 32, depth 1; 2 lines a shard) against the
    JAX package's make_rec_train_step over dp=4: loss, gradient norm,
    gradients, parameters and the global BatchNorm statistics (RTOL)."""
    rng = np.random.default_rng(30)
    batch = _rec_batch8(rng)
    jm = JaxSVTR(vocab_size=VOCAB, dim=32, depth=1, heads=2, policy=F32)
    v = _perturbed(_init(jm, 0, jnp.zeros((1, 48, 64, 3)), jnp.array([64])), 31)
    jmesh = jax_build_mesh("dp=4")

    def loss_fn(params, stats, b):
        images = jnp.repeat((b["images"].astype(jnp.float32) / 255.0)[..., None], 3, -1)
        (logits, lengths), mut = jm.apply({"params": params, "batch_stats": stats}, images,
                                          b["widths"], train=True, mutable=["batch_stats"])
        return jax_ctc.ctc_loss(logits, lengths, b["labels"], b["label_lengths"]), \
            mut["batch_stats"]

    loss, stats, grads = _jax_grads(loss_fn, v["params"], v["batch_stats"], batch, jmesh)
    opt = JT.make_optimizer(1e-3)
    jstate = JT.TrainState(v["params"], v["batch_stats"], opt.init(v["params"]), 0)
    jstate, jmetrics = JT.make_rec_train_step(jm, opt, jmesh)(jstate, _sharded(jmesh, batch))

    model = SVTRRecognizer(VOCAB, dim=32, depth=1, heads=2,
                           policy=DTypePolicy(compute_dtype=torch.float32))
    model.load_state_dict(weights.svtr_state_dict(v))
    seen = _capture_grads(monkeypatch, model)
    mesh = build_mesh("dp=4", ["cpu"] * 4)
    state, metrics = T.make_rec_train_step(mesh)(T.init_state(model, 1e-3, "cpu"),
                                                 T.to_device(batch, torch.device("cpu")))
    _close(metrics["loss"].item(), loss, what="loss")
    _close(metrics["loss"].item(), float(jmetrics["loss"]), what="loss, JAX step")
    _close(metrics["grad_norm"].item(), float(optax.global_norm(grads)), GRAD_RTOL, "grad norm")
    want_g = weights.svtr_state_dict({"params": _np_tree(grads), "batch_stats": _np_tree(stats)})
    _assert_grads(seen, want_g, "rec dp4")
    want = weights.svtr_state_dict({"params": _np_tree(jstate.params),
                                    "batch_stats": _np_tree(jstate.batch_stats)})
    _assert_state_dict(model.state_dict(), want, want_g, 1e-3, "rec dp4")
    for k in want:  # the running statistics at RTOL
        if k.rsplit(".", 1)[-1].startswith("running_"):
            _close(model.state_dict()[k], want[k], what=k)


def test_det_step_dp4_matches_jax(monkeypatch):
    """A dp=4 det step at 64 x 64 (one page a shard, augmentation off)
    against value_and_grad of DBNet.apply + db_loss jitted over the
    dp-sharded batch and the JAX optimizer: loss, gradient norm, gradients,
    parameters and BatchNorm statistics (RTOL). The seeds are
    test_det_step_matches_jax's. (With seeds 32 and 33 one threshold-head
    BatchNorm output lies within float32 rounding of the ReLU kink, +3.5e-6
    in the port against -1.7e-6 at float64, and that one flipped gradient
    element moves every earlier gradient by ~2e-3 of its scale: in the
    port's one-device step as much as at dp=4, while dp=4 moves them by
    1e-6.)"""
    rng = np.random.default_rng(10)
    batch = _det_batch(rng, b=4)
    jm = JaxDBNet(policy=F32)
    v = _perturbed(_init(jm, 1, jnp.zeros((1, 64, 64, 3)), train=True), 3)
    jmesh = jax_build_mesh("dp=4")

    def loss_fn(params, stats, b):
        wire = _jax_det_decode(b)
        out, mut = jm.apply({"params": params, "batch_stats": stats},
                            jax.vmap(normalize_for_model)(wire["image"]), train=True,
                            mutable=["batch_stats"])
        return jax_db_loss(out, wire["shrink"], wire["shrink_mask"], wire["thresh"],
                           wire["thresh_mask"]), mut["batch_stats"]

    loss, stats, grads = _jax_grads(loss_fn, v["params"], v["batch_stats"], batch, jmesh)
    opt = JT.make_optimizer(1e-3)
    upd, _ = jax.jit(opt.update)(grads, opt.init(v["params"]), v["params"])
    new = optax.apply_updates(v["params"], upd)

    model = DBNet(policy=DTypePolicy(compute_dtype=torch.float32), thresh_head=True)
    model.load_state_dict(weights.dbnet_state_dict(v, thresh_head=True))
    seen = _capture_grads(monkeypatch, model)
    mesh = build_mesh("dp=4", ["cpu"] * 4)
    state, metrics = T.make_det_train_step(augment=False, mesh=mesh)(
        T.init_state(model, 1e-3, "cpu"), T.to_device(batch, torch.device("cpu")))
    _close(metrics["loss"].item(), loss, what="loss")
    _close(metrics["grad_norm"].item(), float(optax.global_norm(grads)), GRAD_RTOL, "grad norm")
    want_g = weights.dbnet_state_dict({"params": _np_tree(grads), "batch_stats": _np_tree(stats)},
                                      thresh_head=True)
    _assert_grads(seen, want_g, "det dp4")
    want = weights.dbnet_state_dict({"params": _np_tree(new), "batch_stats": _np_tree(stats)},
                                    thresh_head=True)
    _assert_state_dict(model.state_dict(), want, want_g, 1e-3, "det dp4")
    for k in want:
        if k.rsplit(".", 1)[-1].startswith("running_"):
            _close(model.state_dict()[k], want[k], what=k)


def test_det_step_dp4_matches_one_device_at_kink_seeds(monkeypatch):
    """The seeds test_det_step_dp4_matches_jax leaves out (32 and 33, one
    threshold-head activation within float32 rounding of the ReLU kink):
    the port's dp=4 det step against its own one-device step from the same
    weights and batch, where the kink falls the same way in both (a flip
    would move the gradients by ~2e-3). Loss, gradient norm, the updated
    parameters and the BatchNorm running statistics at RTOL, every
    gradient at test_torch_train's gradient bar (the global statistics'
    summation order alone moves a leaf by up to ~2.4e-5 of its scale, at
    seeds 10 and 3 as here). Shards 1-3 run copies of the model, so this
    holds the copies' weights and the sum of their gradients."""
    rng = np.random.default_rng(32)
    batch = _det_batch(rng, b=4)
    v = _perturbed(_init(JaxDBNet(policy=F32), 1, jnp.zeros((1, 64, 64, 3)), train=True), 33)
    runs = []
    for mesh in (build_mesh("dp=1", ["cpu"]), build_mesh("dp=4", ["cpu"] * 4)):
        model = DBNet(policy=DTypePolicy(compute_dtype=torch.float32), thresh_head=True)
        model.load_state_dict(weights.dbnet_state_dict(v, thresh_head=True))
        with monkeypatch.context() as m:
            seen = _capture_grads(m, model)
            _, metrics = T.make_det_train_step(augment=False, mesh=mesh)(
                T.init_state(model, 1e-3, "cpu"), T.to_device(batch, torch.device("cpu")))
        runs.append((metrics, seen, model.state_dict()))
    (m1, g1, s1), (m4, g4, s4) = runs
    _close(m4["loss"].item(), m1["loss"].item(), what="loss")
    _close(m4["grad_norm"].item(), m1["grad_norm"].item(), what="grad norm")
    assert set(g4) == set(g1)
    want_g = {k: t.numpy() for k, t in g1.items()}
    _assert_grads(g4, want_g, "det dp4 vs dp1")
    _assert_state_dict(s4, {k: t.numpy() for k, t in s1.items()}, want_g, 1e-3,
                       "det dp4 vs dp1")
    for k in s1:
        if k.rsplit(".", 1)[-1].startswith("running_"):
            _close(s4[k], s1[k], what=k)


def _layout_cases():
    rng = np.random.default_rng(34)
    even = _layout_batch(rng, b=4)
    uneven = _layout_batch(rng, b=4)
    # shard 0 (samples 0-1) full; shard 1 (samples 2-3) 5 and 9 tokens
    uneven["mask"][:] = 1
    uneven["mask"][2, 5:] = 0
    uneven["mask"][3, 9:] = 0
    return {"even": even, "uneven": uneven}


@pytest.mark.parametrize("case", ["even", "uneven"])
def test_layout_step_dp2_tp2_matches_jax(monkeypatch, case):
    """A dp=2 x tp=2 layout step (64 x 2, 2 heads: one head per tp device)
    against the JAX package's init_layout_state_sharded placement and
    make_layout_train_step on the same mesh: loss, tag accuracy, gradient
    norm, gradients and parameters (RTOL). The uneven case: the shards hold
    96 and 14 tokens, and the mean of the two shards' losses misses the
    global loss by far more than RTOL."""
    batch = _layout_cases()[case]
    jm = JaxLayout(vocab_size=VOCAB, dim=64, depth=2, heads=2, max_len=64, policy=F32)
    example = (jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8, 4), jnp.int32),
               jnp.ones((1, 8), jnp.int32))
    boxed = jm.init(jax.random.PRNGKey(2), *example)
    params = _perturbed(jax.tree.map(np.asarray, jshd.unbox(boxed))["params"], 35)
    jmesh = jax_build_mesh("dp=2,tp=2")
    placed = jax.tree.map(jax.device_put, params,
                          jshd.logical_to_mesh_sharding(boxed, jmesh)["params"])
    assert "tp" in str(placed["block0"]["up"]["kernel"].sharding.spec)

    def loss_fn(p, stats, b):
        out = jm.apply({"params": p}, b["ids"], b["boxes"], b["mask"], train=True,
                       pos_offset=b["pos_offset"])
        return jax_extraction_loss(out, b["tags"], b["types"], b["form"], b["mask"]), stats

    loss, _, grads = _jax_grads(loss_fn, params, {}, batch, jmesh)
    opt = JT.make_optimizer(3e-4)
    jstate = JT.TrainState(placed, {}, jax.jit(opt.init)(placed), 0)
    jstate, jmetrics = JT.make_layout_train_step(jm, opt, jmesh)(jstate, _sharded(jmesh, batch))

    model = LayoutExtractor(VOCAB, dim=64, depth=2, heads=2, max_len=64)
    model.load_state_dict(weights.layout_state_dict({"params": params}))
    mesh = build_mesh("dp=2,tp=2", ["cpu"] * 4)
    state = T.init_layout_state_sharded(model, 3e-4, mesh)
    assert isinstance(model.blocks[0].up, ShardedDense)
    seen = _capture_grads(monkeypatch, model)
    state, metrics = T.make_layout_train_step(torch.float32, mesh=mesh)(
        state, T.to_device(batch, torch.device("cpu")))
    _close(metrics["loss"].item(), loss, what="loss")
    _close(metrics["loss"].item(), float(jmetrics["loss"]), what="loss, JAX step")
    assert metrics["tag_acc"].item() == pytest.approx(float(jmetrics["tag_acc"]), abs=1e-6)
    _close(metrics["grad_norm"].item(), float(optax.global_norm(grads)), GRAD_RTOL, "grad norm")
    want_g = weights.layout_state_dict({"params": _np_tree(grads)})
    _assert_grads(seen, want_g, "layout dp2 tp2")
    _assert_state_dict(dense_state_dict(model),
                       weights.layout_state_dict({"params": _np_tree(jstate.params)}),
                       want_g, 3e-4, "layout dp2 tp2")
    if case == "uneven":
        halves = [{k: v[i:i + 2] for k, v in batch.items()} for i in (0, 2)]
        per_shard = np.mean([float(jax.jit(lambda p, b: loss_fn(p, {}, b)[0])(params, h))
                             for h in halves])
        assert abs(per_shard - loss) > 100 * RTOL * abs(loss), (per_shard, loss)


def test_default_mesh_is_dp_over_the_trainers_device():
    """shd_default_mesh: dp=-1 over the trainer's device (the CPU here),
    dp=-1,tp=1 for the layout trainer; a step over it equals the step
    without a mesh."""
    mesh = T.shd_default_mesh("cpu")
    assert mesh.shape == {"dp": 1} and mesh.distinct_devices() == [torch.device("cpu")]
    assert T.shd_default_mesh("cpu", "dp=-1,tp=1").shape == {"dp": 1, "tp": 1}
    rng = np.random.default_rng(36)
    batch = T.to_device(_rec_batch8(rng), torch.device("cpu"))
    model = SVTRRecognizer(VOCAB, dim=32, depth=1, heads=2,
                           policy=DTypePolicy(compute_dtype=torch.float32))
    model.init_flax_(torch.Generator().manual_seed(0))
    twin = copy.deepcopy(model)
    _, a = T.make_rec_train_step(mesh)(T.init_state(model, 1e-3, "cpu"), batch)
    _, b = T.make_rec_train_step()(T.init_state(twin, 1e-3, "cpu"), batch)
    assert a["loss"].item() == b["loss"].item() and a["grad_norm"].item() == b["grad_norm"].item()
    for k, v in model.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
