"""The port's parallel layer against the JAX package's on the CPU, the JAX
functions on their 8-device CPU mesh and the port's on meshes of repeated
``cpu`` devices, from the same seeded numpy inputs: ring attention at sp=4
(atol 1e-5, with and without a mask, and a row whose first blocks are all
masked), the GPipe schedule at pp=4 (forward 1e-5, gradient 1e-4), the
layout extractor served with in-model ring attention at sp=4 (its weights
carried by the converter, 1e-4), the tp-sharded block and model against the
port's dense ones (1e-5), the logical axes against flax's partition specs,
the dp copies of a module and the sum of their gradients, and
``LayoutModelExtractor`` turning sp on from the mesh."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ocr_system_tpu.core.dtypes import DTypePolicy as JaxPolicy
from ocr_system_tpu.core.mesh import build_mesh as jax_build_mesh
from ocr_system_tpu.core.mesh import mesh_context as jax_mesh_context
from ocr_system_tpu.models.layout_extractor import LayoutExtractor as JaxLayout
from ocr_system_tpu.parallel import pipeline as jpipe
from ocr_system_tpu.parallel import ring_attention as jring
from ocr_system_tpu.parallel.sharding import unbox
from ocr_system_tpu_torch.core import weights
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.core.mesh import build_mesh, mesh_context
from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor
from ocr_system_tpu_torch.parallel import pipeline, ring_attention, sharding

torch.set_num_threads(1)

VOCAB = 40


def _mesh(spec, n):
    return build_mesh(spec, ["cpu"] * n)


@pytest.fixture(scope="module")
def jax_sp():
    return jax_build_mesh("sp=4")


def _qkv(seed, b, t, h, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


MASKS = {
    "none": lambda b, t: np.ones((b, t), np.int32),
    "tail": lambda b, t: (np.arange(t)[None] < t - 6).repeat(b, 0).astype(np.int32),
    # row 1's first three of four ring blocks are all masked: its queries
    # meet only masked keys until the last block's correction zeroes them
    "first_blocks": lambda b, t: np.stack(
        [np.arange(t) % 3 != 0, np.arange(t) >= 3 * t // 4]).astype(np.int32),
}


@pytest.mark.parametrize("mask_name", sorted(MASKS))
def test_ring_attention_matches_jax(jax_sp, mask_name):
    """ring_attention at sp=4 against the JAX package's on the same inputs:
    1e-5; and both against their dense -1e30 references."""
    b, t, h, d = 2, 32, 4, 16
    q, k, v = _qkv(0, b, t, h, d)
    mask = MASKS[mask_name](b, t)
    want = np.asarray(jax.jit(lambda *a: jring.ring_attention(*a, jax_sp))(q, k, v, mask))
    got = ring_attention.ring_attention(*map(torch.from_numpy, (q, k, v, mask)),
                                        _mesh("sp=4", 4))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    dense = ring_attention.dense_attention_reference(*map(torch.from_numpy, (q, k, v, mask)))
    jdense = jring.dense_attention_reference(q, k, v, mask.astype(bool))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5, rtol=0)


def test_ring_attention_keeps_the_query_dtype(jax_sp):
    """bf16 in, bf16 out (the running max and sum in the query dtype, as
    JAX's), and within bf16 rounding of JAX's bf16 ring."""
    q, k, v = _qkv(1, 1, 16, 2, 8)
    mask = MASKS["tail"](1, 16)
    want = jax.jit(lambda *a: jring.ring_attention(*a, jax_sp))(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), mask)
    got = ring_attention.ring_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), torch.from_numpy(mask),
        _mesh("sp=4", 4))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=0.05)


def test_ring_attention_refuses_an_uneven_split():
    q = torch.zeros(1, 10, 2, 4)
    with pytest.raises(ValueError):
        ring_attention.ring_attention(q, q, q, torch.ones(1, 10), _mesh("sp=4", 4))


# ---------------- the GPipe schedule ----------------


def _stage_params(seed, d, hidden):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((d, hidden)) * 0.3).astype(np.float32),
            "b1": np.zeros((hidden,), np.float32),
            "w2": (rng.standard_normal((hidden, d)) * 0.3).astype(np.float32)}


def _jax_stage(p, x):
    return x + jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


def _torch_stage(p, x):
    return x + torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


@pytest.mark.parametrize("n_micro", [4, 8])
def test_pipeline_matches_jax(n_micro):
    """pipeline_apply at pp=4 against the JAX package's (its shard_map
    over the JAX CPU mesh): the forward within 1e-5, and the gradient of a
    squared-error loss through the schedule within 1e-4, each also against
    serial_reference."""
    d, hidden, mb = 8, 12, 2
    stages = [_stage_params(20 + i, d, hidden) for i in range(4)]
    rng = np.random.default_rng(21)
    x = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    tgt = rng.standard_normal((n_micro, mb, d)).astype(np.float32)
    jmesh = jax_build_mesh("pp=4")

    def jloss(p):
        return jnp.mean((jpipe.pipeline_apply(_jax_stage, p, x, jmesh) - tgt) ** 2)

    jstacked = jpipe.stack_stage_params([jax.tree.map(jnp.asarray, s) for s in stages])
    want_out = np.asarray(jpipe.pipeline_apply(_jax_stage, jstacked, x, jmesh))
    want_grad = jax.tree.map(np.asarray, jax.grad(jloss)(jstacked))

    mesh = _mesh("pp=4", 4)
    tstages = [{k: torch.from_numpy(v) for k, v in s.items()} for s in stages]
    stacked = {k: v.requires_grad_() for k, v in pipeline.stack_stage_params(tstages).items()}
    out = pipeline.pipeline_apply(_torch_stage, stacked, torch.from_numpy(x), mesh)
    np.testing.assert_allclose(out.detach().numpy(), want_out, atol=1e-5, rtol=0)
    serial = pipeline.serial_reference(_torch_stage, tstages, torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), serial.numpy(), atol=1e-5, rtol=0)
    ((out - torch.from_numpy(tgt)) ** 2).mean().backward()
    for k, g in want_grad.items():
        np.testing.assert_allclose(stacked[k].grad.numpy(), g, atol=1e-4, rtol=0, err_msg=k)


def test_pipeline_refuses_a_stage_count_off_the_mesh():
    stacked = pipeline.stack_stage_params([{"w": torch.zeros(2)}] * 3)
    with pytest.raises(ValueError):
        pipeline.pipeline_apply(lambda p, x: x, stacked, torch.zeros(4, 1, 2), _mesh("pp=4", 4))


# ---------------- the layout model: sp and tp ----------------


def _inputs(seed, b, n):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (b, n)).astype(np.int32)
    boxes = np.sort(rng.integers(0, 1024, (b, n, 4)), -1).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    mask[-1, n // 3:] = 0
    return ids, boxes, mask


@pytest.fixture(scope="module")
def small_pair():
    """A flax layout model at 64 x 2 (4 heads) and its port through the
    converter, float32."""
    jm = JaxLayout(vocab_size=VOCAB, dim=64, depth=2, heads=4, max_len=64,
                   policy=JaxPolicy.from_names("float32"))
    ids, boxes, mask = _inputs(0, 2, 8)
    variables = unbox(jax.jit(lambda r: jm.init(r, ids, boxes, mask))(jax.random.PRNGKey(5)))
    variables = jax.tree.map(np.asarray, variables)
    pm = LayoutExtractor(VOCAB, dim=64, depth=2, heads=4, max_len=64)
    pm.load_state_dict(weights.layout_state_dict(variables))
    return variables, pm


def test_layout_extractor_sp_matches_jax_sp(small_pair):
    """The port at sp=4 against the JAX model at sp=4 (ring attention in
    each block), weights carried by the converter: every output within
    1e-4; and against the port's dense model."""
    variables, pm = small_pair
    ids, boxes, mask = _inputs(1, 2, 32)
    jm = JaxLayout(vocab_size=VOCAB, dim=64, depth=2, heads=4, max_len=64,
                   policy=JaxPolicy.from_names("float32"), sequence_parallel=True)
    with jax_mesh_context(jax_build_mesh("dp=1,tp=1,sp=4")):
        want = jax.jit(lambda v: jm.apply(v, ids, boxes, mask))(variables)
    ring = LayoutExtractor(VOCAB, dim=64, depth=2, heads=4, max_len=64, sequence_parallel=True)
    ring.load_state_dict(pm.state_dict())
    args = [torch.from_numpy(a).long() for a in (ids, boxes, mask)]
    with torch.no_grad(), mesh_context(_mesh("dp=1,tp=1,sp=4", 4)):
        got = ring(*args)
    with torch.no_grad():
        dense = pm(*args)
    valid = mask.astype(bool)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, atol=1e-4, rtol=0, err_msg=k)
        g, dn = got[k].numpy(), dense[k].numpy()
        if g.ndim == 3:
            g, dn = g[valid], dn[valid]
        np.testing.assert_allclose(g, dn, atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_block_and_model_match_dense(small_pair, tp):
    """shard_params at tp (q, k and v each split by heads; up column-,
    proj and down row-parallel): one block and the whole model within 1e-5
    of the port's dense ones, and the gathered state dict equal to the
    dense one."""
    import copy

    _, pm = small_pair
    ids, boxes, mask = (torch.from_numpy(a).long() for a in _inputs(2, 2, 16))
    sharded = sharding.shard_params(copy.deepcopy(pm), _mesh(f"dp=1,tp={tp}", tp))
    assert isinstance(sharded.blocks[0].qkv, sharding.ShardedDense)
    assert isinstance(sharded.blocks[0].down, sharding.ShardedDense)
    assert not isinstance(sharded.tag_head, sharding.ShardedDense)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 16, 64)).astype(np.float32))
    bias = torch.zeros(2, 1, 1, 16).masked_fill(~mask.bool()[:, None, None, :], -1e9)
    with torch.no_grad():
        np.testing.assert_allclose(sharded.blocks[0](x, bias, mask.bool()).numpy(),
                                   pm.blocks[0](x, bias, mask.bool()).numpy(), atol=1e-5, rtol=0)
        got, want = sharded(ids, boxes, mask), pm(ids, boxes, mask)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)
    dense = sharding.dense_state_dict(sharded)
    assert set(dense) == set(pm.state_dict())
    assert all(torch.equal(dense[k], v) for k, v in pm.state_dict().items())


def test_logical_axes_match_flax(small_pair):
    """Each port parameter's logical axes equal the flax parameter's it
    converts from (flax's kernel axes are (in, out), as Dense.axes)."""
    jm = JaxLayout(vocab_size=VOCAB, dim=64, depth=2, heads=4, max_len=64)
    ids, boxes, mask = _inputs(0, 1, 8)
    boxed = jax.eval_shape(lambda r: jm.init(r, ids, boxes, mask), jax.random.PRNGKey(0))
    specs = jax.tree.map(lambda p: tuple(p), fnn.get_partition_spec(boxed),
                         is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, tuple))[0]}
    got = sharding.logical_axes(small_pair[1])
    names = {"tok_embed.weight": "params/tok_embed/embedding",
             "coord_embed.weight": "params/coord_embed/embedding",
             "pos_embed": "params/pos_embed"}
    for i in range(2):
        for layer in ("qkv", "proj", "up", "down"):
            names[f"blocks.{i}.{layer}.weight"] = f"params/block{i}/{layer}/kernel"
            names[f"blocks.{i}.{layer}.bias"] = f"params/block{i}/{layer}/bias"
    for head in ("tag_head", "type_head", "conf_head", "form_head"):
        names[f"{head}.weight"] = f"params/{head}/kernel"
        names[f"{head}.bias"] = f"params/{head}/bias"
    assert set(got) == set(names)
    for port_name, flax_name in names.items():
        assert got[port_name] == flat[flax_name], port_name
    assert sharding.mesh_axes(got["blocks.0.qkv.weight"]) == (None, "tp")
    assert sharding.mesh_axes(got["blocks.0.down.weight"]) == ("tp", None)


def test_shard_params_refuses_an_uneven_split(small_pair):
    import copy

    with pytest.raises(ValueError):
        sharding.shard_params(copy.deepcopy(small_pair[1]), _mesh("tp=8", 8))


def test_replicas_copy_every_shard_after_the_first():
    """``replicas`` over dp=3 of one device: shard 0 runs the module itself
    and shards 1-2 copies (a virtual mesh takes the path of distinct
    cards), made once for the mesh, given the module's weights again after
    an in-place change (an optimizer step, a loaded checkpoint) and its
    train or eval mode; a new mesh makes new copies."""
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(4, 4), torch.nn.BatchNorm1d(4))
    mesh = _mesh("dp=3", 3)
    models = sharding.replicas(model, mesh)
    assert models[0] is model and len(models) == 3
    assert all(m is not model for m in models[1:])
    assert not any(p is q for m in models[1:] for p, q in zip(m.parameters(), model.parameters()))
    with torch.no_grad():
        model[0].weight.add_(1.0)
        model[1].running_mean.fill_(0.5)
    model.eval()
    again = sharding.replicas(model, mesh)
    assert all(a is b for a, b in zip(again, models))
    for m in again[1:]:
        assert not m.training
        for (k, a), b in zip(m.state_dict().items(), model.state_dict().values()):
            assert torch.equal(a, b), k
    other = sharding.replicas(model, _mesh("dp=2", 2))
    assert len(other) == 2 and other[1] is not models[1]


def test_replica_gradients_sum_into_the_module():
    """The dp psum of the gradients (``reduce_replica_grads``): each copy's
    gradient is added to the module's and cleared."""
    model = torch.nn.Linear(3, 2)
    models = sharding.replicas(model, _mesh("dp=2", 2))
    x = torch.arange(6.0).reshape(2, 3)
    (models[0](x[:1]).sum() + models[1](x[1:]).sum()).backward()
    assert models[1].weight.grad is not None
    sharding.reduce_replica_grads(models)
    assert models[1].weight.grad is None
    torch.testing.assert_close(model.weight.grad, x.sum(0).expand(2, 3), rtol=0, atol=0)


def test_serving_enables_sp_from_mesh():
    """LayoutModelExtractor builds a sequence-parallel model iff its mesh
    has sp > 1 (the counterpart of test_serving_enables_sp_from_mesh)."""
    s = Settings(extract_dim=64, extract_depth=2)
    state = LayoutExtractor(get_charset("multilingual").size, dim=64, depth=2,
                            max_len=2048).state_dict()
    with mesh_context(_mesh("dp=1,tp=1,sp=4", 4)):
        ex = LayoutModelExtractor(s, state_dict=state, device="cpu")
        assert ex.model.sequence_parallel and all(b.sequence_parallel for b in ex.model.blocks)
    with mesh_context(_mesh("dp=-1,tp=1", 4)):
        assert not LayoutModelExtractor(s, state_dict=state, device="cpu").model.sequence_parallel
    assert not LayoutModelExtractor(s, state_dict=state, device="cpu").model.sequence_parallel


# ---------------- the multichip dry run ----------------


def test_dryrun_multichip_on_a_virtual_cpu_mesh():
    """Every mesh path at tiny sizes on 4 repeated CPU devices (the
    counterpart of __graft_entry__.dryrun_multichip on the JAX CPU mesh):
    the dp x tp meshes, engine and scheduler waves, sp ring against dense
    within the JAX dry run's 5e-2, GPipe against serial within 1e-4."""
    from ocr_system_tpu_torch.utils.multichip import dryrun_multichip

    out = dryrun_multichip(4, devices=["cpu"] * 4)
    assert out["n_devices"] == 4 and out["distinct_devices"] == 1
    assert np.isfinite(out["rec_loss"]) and np.isfinite(out["layout_loss"])
    assert out["engine_boxes"] > 0 and out["scheduler_waves"] == 2
    assert out["sp_diff"] < 5e-2 and out["pp"] == 4 and out["pp_fwd_diff"] < 1e-4


def test_dryrun_multichip_needs_its_cards(monkeypatch):
    from ocr_system_tpu_torch.utils.multichip import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="cards"):
        dryrun_multichip(2)
    with pytest.raises(ValueError):
        dryrun_multichip(4, devices=["cpu"] * 2)
