"""Device mesh and the collectives along its axes (port of
ocr_system_tpu/core/mesh.py).

The JAX package drives every device of a ``jax.sharding.Mesh`` from one
Python process, and XLA inserts the collectives from sharding annotations.
The port keeps that design, one controller process, and makes the
collectives explicit tensor moves between the mesh's devices:

    ppermute    each shard ``.to`` the next device along the axis
    psum        the sum of every shard's copy on each device
    all_gather  ``torch.cat`` of the shards on one device

The axes:

    dp — data parallel: page and training batches split over dp;
    tp — tensor parallel: the layout model's mlp and head dimensions;
    sp — sequence parallel: ring attention's K/V blocks (parallel/);
    pp — pipeline stages (parallel/pipeline.py).

A mesh may name one device several times (``build_mesh(..., devices=[d] *
4)``): the CPU tests and the card's single H100 build n-way meshes that way.
A move within one device returns the same tensor, so everything here is
functional: no collective writes into a shard in place.

Shards of one function that must meet inside it (a BatchNorm's batch
statistics under dp) run in lockstep through ``run_sharded``: one thread per
shard, each in a ``shard_scope``, joined at every ``axis_psum``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Callable, Iterator, Mapping, Sequence

import numpy as np
import torch

DATA_AXIS = "dp"
TENSOR_AXIS = "tp"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh shape spec. Sizes of -1 are filled with the remaining devices."""

    axes: tuple[tuple[str, int], ...] = ((DATA_AXIS, -1),)

    @classmethod
    def from_string(cls, spec: str) -> "MeshConfig":
        axes = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, _, size = part.partition("=")
            axes.append((name.strip(), int(size)))
        return cls(axes=tuple(axes) or ((DATA_AXIS, -1),))

    def resolve(self, n_devices: int) -> tuple[tuple[str, int], ...]:
        fixed = math.prod(s for _, s in self.axes if s != -1)
        unknowns = [name for name, s in self.axes if s == -1]
        if len(unknowns) > 1:
            raise ValueError(f"at most one -1 axis allowed, got {unknowns}")
        if n_devices % max(fixed, 1) != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {fixed}"
            )
        fill = n_devices // fixed if unknowns else None
        return tuple(
            (name, fill if s == -1 else s) for name, s in self.axes  # type: ignore[misc]
        )


def _device(d: str | torch.device) -> torch.device:
    """A device as tensors report it: ``cuda`` without an index is the
    current card."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A named grid of ``torch.device``s: ``devices`` is an object ndarray
    of shape ``tuple(shape.values())``, ``shape`` the ordered ``{axis:
    size}``."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        """The first device: where replicated values live."""
        return self.devices.flat[0]

    def distinct_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.devices.flat))

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` through the current shard's position
        on the other axes (``shard_scope``; index 0 outside one). An axis
        the mesh lacks has size 1."""
        if axis not in self.shape:
            return [self.devices[tuple(axis_index(a) for a in self.axis_names)]]
        idx = [axis_index(a) if a != axis else slice(None) for a in self.axis_names]
        return list(self.devices[tuple(idx)])

    def moved(self, device: torch.device, axis: str, index: int) -> torch.device:
        """The device at ``device``'s position (its first on the mesh) with
        ``axis`` set to ``index``: where shard ``index`` along ``axis``
        keeps its copy of a value that lives on ``device``."""
        if axis not in self.shape:
            return device
        hits = np.argwhere(self.devices == device)
        if not len(hits):
            raise ValueError(f"{device} is not on {self}")
        pos = list(hits[0])
        pos[self.axis_names.index(axis)] = index
        return self.devices[tuple(pos)]

    def __deepcopy__(self, memo: dict) -> "Mesh":
        return self  # it names devices: a copied module shares its mesh

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, {len(self.distinct_devices())} distinct of "
                f"{self.size} devices)")


def build_mesh(
    config: MeshConfig | str | None = None,
    devices: Sequence[str | torch.device] | None = None,
) -> Mesh:
    """Build a Mesh over the given devices; ``None`` means every visible
    CUDA device, and raises when there is none. An explicit list may repeat
    a device (a virtual mesh). All-fixed axes may take a subset of the
    devices (``sp=4`` of 8), as in JAX; asking for more devices than the
    list holds raises. Axis order follows the config, dp outermost."""
    if isinstance(config, str):
        config = MeshConfig.from_string(config)
    if config is None:
        config = MeshConfig()
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device visible: pass devices= to build a mesh of other "
                "devices (a repeated device builds a virtual mesh)"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    axes = config.resolve(len(devs))
    names = tuple(name for name, _ in axes)
    sizes = tuple(size for _, size in axes)
    total = math.prod(sizes)
    dev_array = np.empty(total, dtype=object)
    dev_array[:] = devs[:total]
    return Mesh(dev_array.reshape(sizes), names)


_local = threading.local()


def get_mesh() -> Mesh:
    """This thread's mesh, built at first use from ``MESH_SHAPE`` (or
    ``Settings.mesh_shape``) over every visible CUDA device."""
    mesh = getattr(_local, "mesh", None)
    if mesh is None:
        spec = os.environ.get("MESH_SHAPE")
        if spec is None:
            from ocr_system_tpu_torch.core.config import get_settings

            spec = get_settings().mesh_shape
        mesh = build_mesh(spec)
        _local.mesh = mesh
    return mesh


def current_mesh() -> Mesh | None:
    """The mesh set in this thread (``set_mesh``, ``mesh_context``, or an
    earlier ``get_mesh``), without building one."""
    return getattr(_local, "mesh", None)


def set_mesh(mesh: Mesh | None) -> None:
    _local.mesh = mesh


@contextlib.contextmanager
def mesh_context(mesh: Mesh) -> Iterator[Mesh]:
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def engine_mesh(device: torch.device) -> Mesh | None:
    """The mesh an engine built on ``device`` serves under: the one set in
    this thread, else for a card the default (``get_mesh``); a CPU engine
    with no mesh set runs unsharded (None). A mesh whose devices are not of
    the engine's device type raises."""
    mesh = current_mesh()
    if mesh is None:
        if torch.device(device).type == "cpu":
            return None
        mesh = get_mesh()
    kinds = {d.type for d in mesh.devices.flat}
    if kinds != {torch.device(device).type}:
        raise ValueError(f"{mesh} has {sorted(kinds)} devices; the engine runs on {device}")
    return mesh


# ---- shards ----


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_batch(mesh: Mesh, x, axis: str = DATA_AXIS) -> list:
    """Per-device shards of a batch-leading tensor (or a mapping of them)
    along ``axis``: shard i is the i-th equal slice on the i-th device. The
    batch must divide evenly."""
    devs = mesh.axis_devices(axis)
    if isinstance(x, Mapping):
        parts = {k: shard_batch(mesh, v, axis) for k, v in x.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(len(devs))]
    if x.shape[0] % len(devs):
        raise ValueError(f"batch {x.shape[0]} does not split over {axis}={len(devs)}")
    return [c.to(d) for c, d in zip(x.chunk(len(devs)), devs)]


@dataclasses.dataclass
class ShardedBatch:
    """A batch split along dp: ``shards[i]`` (equal row counts) lives on
    the i-th dp device of ``mesh``. What the JAX package holds as one array
    with a dp sharding (the det stage's canvas stack)."""

    shards: list[torch.Tensor]
    mesh: Mesh

    @property
    def shape(self) -> tuple[int, ...]:
        first = self.shards[0].shape
        return (first[0] * len(self.shards), *first[1:])

    @property
    def rows_per_shard(self) -> int:
        return self.shards[0].shape[0]


def replicated(mesh: Mesh, x: torch.Tensor, axis: str = DATA_AXIS) -> list[torch.Tensor]:
    """A copy of ``x`` on each device along ``axis`` (``x`` itself where it
    already lives there)."""
    return [x.to(d) for d in mesh.axis_devices(axis)]


# ---- collectives along a named axis (lists of shards, one per device) ----


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str,
             shift: int = 1) -> list[torch.Tensor]:
    """Shard i moves to position (i + shift) mod n along ``axis``: the ring
    step of ``jax.lax.ppermute(x, axis, [(i, (i + shift) % n)])``."""
    devs = mesh.axis_devices(axis)
    n = len(devs)
    return [xs[(i - shift) % n].to(devs[i]) for i in range(n)]


def psum(xs: Sequence[torch.Tensor], mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """The sum of every shard, on each device along ``axis``; shards add
    in axis order, so every copy holds the same bits."""
    return [reduce_to(xs, d) for d in mesh.axis_devices(axis)]


def all_gather(xs: Sequence[torch.Tensor], dim: int = 0,
               device: torch.device | None = None) -> torch.Tensor:
    """The shards concatenated along ``dim`` on ``device`` (default: the
    first shard's)."""
    device = xs[0].device if device is None else device
    return torch.cat([x.to(device) for x in xs], dim=dim)


def reduce_to(xs: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The reduce half of ``psum``: the shards' sum, in shard order, on
    ``device`` only."""
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total


# ---- shards in lockstep ----


class _Group:
    """The meeting point of one ``run_sharded`` call's threads."""

    def __init__(self, axis: str, n: int):
        self.axis = axis
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots: list = [None] * n

    def psum(self, i: int, x: torch.Tensor) -> torch.Tensor:
        self.slots[i] = x
        self.barrier.wait()
        total = reduce_to(self.slots, x.device)
        self.barrier.wait()  # every shard has read the slots before reuse
        return total


def axis_index(axis: str) -> int:
    """This shard's position along ``axis`` (``jax.lax.axis_index``); 0
    outside a ``shard_scope`` on that axis."""
    return getattr(_local, "coords", {}).get(axis, 0)


def shard_coords() -> dict[str, int]:
    return dict(getattr(_local, "coords", {}))


@contextlib.contextmanager
def shard_scope(**coords: int) -> Iterator[None]:
    """Run the body as the shard at ``coords`` (``axis=index``)."""
    prev = getattr(_local, "coords", {})
    _local.coords = {**prev, **coords}
    try:
        yield
    finally:
        _local.coords = prev


def axis_size(axis: str) -> int:
    """The number of shards meeting at ``axis_psum`` over ``axis``: the
    shard count inside ``run_sharded`` on that axis, else 1."""
    group = getattr(_local, "group", None)
    return group.n if group is not None and group.axis == axis else 1


def axis_psum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Inside ``run_sharded`` over ``axis``: the sum of ``x`` over every
    shard, differentiable (its gradient is the psum of the shards'
    gradients, as ``jax.lax.psum``'s transpose). Elsewhere: ``x``."""
    group = getattr(_local, "group", None)
    if group is None or group.axis != axis:
        return x
    return group.psum(axis_index(axis), x)


def on_device(device: torch.device) -> contextlib.AbstractContextManager:
    """Make ``device`` the thread's current card (a CUDA launch goes to the
    current card's streams); nothing for another device type."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def run_sharded(mesh: Mesh, axis: str, fn: Callable, shards: Sequence) -> list:
    """``fn(shard)`` for each shard along ``axis``, each in its own thread
    under ``shard_scope(axis=i)`` with the caller's mesh, so the shards
    meet at each ``axis_psum``; returns the results in shard order. One
    shard runs in the calling thread. A failing shard breaks the others'
    wait and its exception is raised here."""
    n = len(shards)
    if n != mesh.shape.get(axis, 1):
        raise ValueError(f"{n} shards for {axis}={mesh.shape.get(axis, 1)}")
    if n == 1:
        with shard_scope(**{axis: 0}):
            return [fn(shards[0])]
    group = _Group(axis, n)
    results: list = [None] * n
    errors: list = [None] * n
    grad = torch.is_grad_enabled()
    coords = shard_coords()
    devs = mesh.axis_devices(axis)

    def work(i: int) -> None:
        _local.mesh = mesh
        _local.group = group
        _local.coords = coords
        try:
            with torch.set_grad_enabled(grad), shard_scope(**{axis: i}), on_device(devs[i]):
                results[i] = fn(shards[i])
        except BaseException as e:  # handed to the caller below
            errors[i] = e
            group.barrier.abort()

    threads = [threading.Thread(target=work, args=(i,), name=f"{axis}{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    real = [e for e in errors if e is not None and not isinstance(e, threading.BrokenBarrierError)]
    if real or any(errors):
        raise (real or [e for e in errors if e is not None])[0]
    return results
