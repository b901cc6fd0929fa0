"""The port's device mesh against the JAX package's (core/mesh.py, the
counterpart of tests/test_core.py's TestMesh): the spec parsing and the -1
fill on a mesh of repeated CPU devices beside JAX's 8-device CPU mesh, the
errors, ``shard_batch``, and the collectives against ``shard_map``'s
``ppermute``, ``psum`` and ``all_gather``. Then what the port adds: no
hidden fallback (no card, too few devices, a mesh of another device type),
an engine asked for the CPU with no mesh set runs unsharded, the shards of
``run_sharded`` meet at ``axis_psum`` (its gradient too), a failing shard
raises instead of hanging, and the kernels count launches per dp shard."""

import threading
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from ocr_system_tpu.core import mesh as jmesh
from ocr_system_tpu.core.config import Settings as JaxSettings
from ocr_system_tpu_torch.core import mesh as M
from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.detector import Detector
from ocr_system_tpu_torch.kernels import _build

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8
SPECS = ["dp=-1", "dp=-1,tp=2", "dp=2,tp=2", "dp=4,tp=2", "sp=4", "dp=1,tp=1,pp=4", "tp=8", ""]


@pytest.mark.parametrize("spec", ["dp=4,tp=2", "dp=-1", "dp=1, tp=1 ,sp=4", ""])
def test_mesh_shape_parse(spec):
    assert (Settings(mesh_shape=spec).parsed_mesh_shape()
            == JaxSettings(mesh_shape=spec).parsed_mesh_shape())


@pytest.mark.parametrize("spec", SPECS)
def test_build_matches_jax(spec):
    """The same axes in the same order, the -1 filled the same way, and an
    all-fixed spec taking the first devices (8 repeated CPU devices beside
    the JAX test mesh's 8)."""
    got, want = M.build_mesh(spec, CPU8), jmesh.build_mesh(spec)
    assert got.shape == dict(want.shape)
    assert list(got.shape) == list(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert got.distinct_devices() == [torch.device("cpu")]


@pytest.mark.parametrize("spec,n", [("dp=-1,tp=-1", 8), ("tp=3", 8), ("dp=4", 1)])
def test_resolve_errors_like_jax(spec, n):
    for config in (M.MeshConfig, jmesh.MeshConfig):
        with pytest.raises(ValueError):
            config.from_string(spec).resolve(n)


def test_shard_batch_places_on_dp():
    mesh = M.build_mesh("dp=-1", CPU8)
    x = torch.arange(32.0).reshape(8, 4)
    shards = M.shard_batch(mesh, {"x": x, "y": x[:, 0]})
    assert len(shards) == 8
    for i, s in enumerate(shards):
        assert torch.equal(s["x"], x[i:i + 1]) and torch.equal(s["y"], x[i:i + 1, 0])
    assert torch.equal(M.all_gather([s["x"] for s in shards]), x)
    with pytest.raises(ValueError):
        M.shard_batch(M.build_mesh("dp=3", ["cpu"] * 3), x)


@pytest.mark.parametrize("n,m", [(0, 4), (3, 4), (8, 4), (9, 8), (5, 1)])
def test_pad_to_multiple_like_jax(n, m):
    assert M.pad_to_multiple(n, m) == jmesh.pad_to_multiple(n, m)


def test_replicated_copies_along_dp():
    mesh = M.build_mesh("dp=2,tp=2", ["cpu"] * 4)
    x = torch.arange(3.0)
    copies = M.replicated(mesh, x)
    assert len(copies) == 2 and all(c is x for c in copies)  # moves within one device
    assert len(M.replicated(mesh, x, "tp")) == 2


def test_collectives_match_shard_map():
    """ppermute (the ring step), psum and all_gather along sp=4, against
    jax.lax's under shard_map on the JAX CPU mesh."""
    x = np.random.default_rng(0).standard_normal((8, 3)).astype(np.float32)
    jm = jmesh.build_mesh("sp=4")

    @partial(shard_map, mesh=jm, in_specs=P("sp"), out_specs=P("sp"), check_rep=False)
    def ring(a):
        return jax.lax.ppermute(a, "sp", [(i, (i + 1) % 4) for i in range(4)])

    @partial(shard_map, mesh=jm, in_specs=P("sp"), out_specs=P("sp"), check_rep=False)
    def total(a):
        return jax.lax.psum(a, "sp")

    @partial(shard_map, mesh=jm, in_specs=P("sp"), out_specs=P("sp"), check_rep=False)
    def gather(a):
        return jax.lax.all_gather(a, "sp", tiled=True)

    mesh = M.build_mesh("sp=4", ["cpu"] * 4)
    shards = list(torch.from_numpy(x).chunk(4))
    np.testing.assert_array_equal(torch.cat(M.ppermute(shards, mesh, "sp")).numpy(),
                                  np.asarray(ring(jnp.asarray(x))))
    np.testing.assert_allclose(torch.cat(M.psum(shards, mesh, "sp")).numpy(),
                               np.asarray(total(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_array_equal(
        torch.cat([M.all_gather(shards)] * 4).numpy(), np.asarray(gather(jnp.asarray(x))))


def test_collectives_are_functional():
    """On a virtual mesh a move within one device returns the same tensor;
    no collective writes into a shard."""
    mesh = M.build_mesh("dp=4", ["cpu"] * 4)
    shards = [torch.full((2,), float(i)) for i in range(4)]
    before = [s.clone() for s in shards]
    moved = M.ppermute(shards, mesh, "dp")
    assert moved[1] is shards[0]
    summed = M.psum(shards, mesh, "dp")
    summed[0].add_(1.0)
    assert all(torch.equal(a, b) for a, b in zip(shards, before))
    assert torch.equal(summed[1], torch.full((2,), 6.0))


# ---------------- no hidden fallback ----------------


def test_build_mesh_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.build_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.build_mesh("dp=1")


def test_default_mesh_raises_without_a_card(monkeypatch):
    """get_mesh builds the settings' dp=-1 over the visible cards: none
    here, so it raises rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MESH_SHAPE", raising=False)

    def fresh():
        M.set_mesh(None)
        return M.get_mesh()

    result: list = []
    t = threading.Thread(target=lambda: result.append(pytest.raises(RuntimeError, fresh)))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and result and result[0].type is RuntimeError


def test_more_devices_than_given_raise():
    with pytest.raises(ValueError):
        M.build_mesh("dp=4", ["cpu"])
    with pytest.raises(ValueError):
        M.build_mesh("dp=2,tp=2", ["cpu"] * 3)
    assert M.build_mesh("dp=4", ["cpu"] * 4).shape == {"dp": 4}


def test_engine_mesh_rules():
    """A CPU engine with no mesh set: unsharded (None); a mesh set in the
    thread serves; a mesh of another device type raises."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    prev = M.current_mesh()
    M.set_mesh(None)
    try:
        _engine_mesh_rules(cpu, cuda)
    finally:
        M.set_mesh(prev)


def _engine_mesh_rules(cpu, cuda):
    assert M.engine_mesh(cpu) is None
    cpu_mesh = M.build_mesh("dp=4", ["cpu"] * 4)
    with M.mesh_context(cpu_mesh):
        assert M.engine_mesh(cpu) is cpu_mesh
        with pytest.raises(ValueError, match="devices"):
            M.engine_mesh(cuda)
    card_mesh = M.build_mesh("dp=2", ["cuda:0"] * 2)  # built without touching a card
    with M.mesh_context(card_mesh), pytest.raises(ValueError, match="devices"):
        M.engine_mesh(cpu)
    assert M.current_mesh() is None
    with M.mesh_context(card_mesh), pytest.raises(ValueError, match="devices"):
        Detector(Settings(det_image_buckets=(64,)), device="cpu")._mesh()


def test_cpu_engine_without_a_mesh_runs_unsharded():
    s = Settings(det_image_buckets=(64,))
    det = Detector(s, device="cpu")
    assert det._mesh() is None
    packed = det._pack_wire(np.full((3, 64, 64), 200, np.uint8))
    out = det._forward(packed)
    assert isinstance(out["canvas"], torch.Tensor) and out["canvas"].shape[0] == 3
    sharded = Detector(s, state_dict=det.model.state_dict(), device="cpu")
    with M.mesh_context(M.build_mesh("dp=2", ["cpu"] * 2)):
        out2 = sharded._forward(packed)
    # 3 pages padded to 4 (a white page), split 2 + 2
    assert isinstance(out2["canvas"], M.ShardedBatch) and out2["canvas"].shape[0] == 4
    assert (out2["canvas"].shards[1][1] == 255).all()
    for k in out:
        if k != "canvas":
            assert out[k].shape == out2[k].shape, k
            torch.testing.assert_close(out[k], out2[k], atol=1e-5, rtol=0, msg=k)


# ---------------- shards in lockstep ----------------


def test_run_sharded_psum_and_its_gradient():
    """Each shard gets the sum over the shards; the gradient of a loss of
    every shard's sum reaches every shard, as psum's transpose."""
    mesh = M.build_mesh("dp=4", ["cpu"] * 4)
    x = torch.arange(8.0, requires_grad=True)

    def fn(shard):
        total = M.axis_psum(shard.square().sum(), "dp")
        return total * (M.axis_index("dp") + 1), M.axis_size("dp")

    outs = M.run_sharded(mesh, "dp", fn, M.shard_batch(mesh, x))
    want = float((x.detach() ** 2).sum())
    assert [o[0].item() for o in outs] == [want * k for k in (1, 2, 3, 4)]
    assert {o[1] for o in outs} == {4}
    sum(o[0] for o in outs).backward()
    assert torch.allclose(x.grad, 10 * 2 * x.detach())
    assert M.axis_size("dp") == 1 and M.axis_psum(x, "dp") is x


def test_run_sharded_failing_shard_raises():
    mesh = M.build_mesh("dp=3", ["cpu"] * 3)

    def fn(shard):
        if M.axis_index("dp") == 1:
            raise KeyError("shard 1")
        return M.axis_psum(shard.sum(), "dp")

    result: list = []

    def run():
        try:
            M.run_sharded(mesh, "dp", fn, [torch.ones(2)] * 3)
        except KeyError as e:
            result.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and result and "shard 1" in str(result[0])


def test_launch_counter_splits_by_shard():
    c = _build.LaunchCounter()
    c.add()
    for i in (0, 1, 1, 3):
        with M.shard_scope(dp=i):
            c.add()
    assert c.value == 5 and c.by_shard == {-1: 1, 0: 1, 1: 2, 3: 1}
    c.reset()
    assert c.value == 0 and c.by_shard == {}
