"""Sharding rules: logical axes to mesh axes, and parameter placement (port
of ocr_system_tpu/parallel/sharding.py).

Modules declare the logical axes of their weights, the counterpart of
flax's ``with_logical_partitioning``: a ``Dense`` carries the axes of its
flax kernel, ``(in, out)``, and a model lists its other parameters in
``PARAM_AXES``. ``LOGICAL_RULES`` maps each logical axis to a mesh axis
(None: replicated), and ``shard_params`` places every weight by its rule:

    the out axis on tp  column-parallel: the kernel's output features split
                        over tp, each device computing its slice;
    the in axis on tp   row-parallel: the input features split, each device
                        a partial product, summed over tp (psum) before the
                        bias, which is replicated.

The JAX package leaves the layout of a sharded tensor to XLA; here a
sharded ``Dense`` becomes a ``ShardedDense`` holding its slices, each on its
tp device, with its optimizer moments beside it. A fused kernel of several
outputs (attention's q, k, v) splits each output group by heads, so every
device holds whole heads of each.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
import weakref

import torch
import torch.nn.functional as F
from torch import nn

from ocr_system_tpu_torch.core.mesh import DATA_AXIS, TENSOR_AXIS, Mesh, reduce_to
from ocr_system_tpu_torch.models.layers import Dense

# logical axis -> mesh axis (None = replicate)
LOGICAL_RULES: tuple[tuple[str, str | None], ...] = (
    ("batch", "dp"),
    ("embed", None),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", None),
    ("vocab", None),
    ("tags", None),
    ("types", None),
    ("forms", None),
    ("one", None),
)


def mesh_axes(axes: tuple[str | None, ...]) -> tuple[str | None, ...]:
    """Logical axes -> the mesh axes they shard over (None: replicated)."""
    rules = dict(LOGICAL_RULES)
    return tuple(None if a is None else rules[a] for a in axes)


def logical_axes(module: nn.Module) -> dict[str, tuple[str | None, ...]]:
    """Every annotated parameter's logical axes in flax's order (a Dense's
    kernel as ``(in, out)``, its bias as ``(out,)``), by state-dict name."""
    out: dict[str, tuple[str | None, ...]] = {}
    for prefix, m in module.named_modules():
        dot = f"{prefix}." if prefix else ""
        if isinstance(m, Dense) and m.axes is not None:
            out[f"{dot}weight"] = m.axes
            if m.bias is not None:
                out[f"{dot}bias"] = (m.axes[-1],)
        for name, axes in getattr(m, "PARAM_AXES", {}).items():
            out[f"{dot}{name}"] = axes
    return out


class ShardedDense(nn.Module):
    """A ``Dense`` split over the mesh's tp axis. ``weight[j]`` and (column-
    parallel) ``bias[j]`` live on tp device j of the mesh's first row;
    ``shard_forward(j, x)`` computes device j's part on x's device, and
    ``reduce(parts)`` finishes a row-parallel product."""

    def __init__(self, dense: Dense, mesh: Mesh, mode: str):
        super().__init__()
        if mode not in ("column", "row"):
            raise ValueError(mode)
        self.mesh, self.mode, self.groups = mesh, mode, dense.shard_groups
        devs = mesh.axis_devices(TENSOR_AXIS)
        n = len(devs)
        w, b = dense.weight.detach(), dense.bias.detach()
        if mode == "column":
            if w.shape[0] % (n * self.groups * dense.shard_unit):
                raise ValueError(f"{w.shape[0]} outputs in {self.groups} groups of "
                                 f"{dense.shard_unit}-wide units do not split over tp={n}")
            ws, bs = (self._column_split(t, n) for t in (w, b))
            self.bias = nn.ParameterList(nn.Parameter(p.to(d)) for p, d in zip(bs, devs))
        else:
            if w.shape[1] % n:
                raise ValueError(f"{w.shape[1]} inputs do not split over tp={n}")
            ws = [c.clone() for c in w.chunk(n, dim=1)]
            self.bias = nn.Parameter(b.clone())
        self.weight = nn.ParameterList(nn.Parameter(p.to(d)) for p, d in zip(ws, devs))

    def _column_split(self, t: torch.Tensor, n: int) -> list[torch.Tensor]:
        groups = t.chunk(self.groups, dim=0)
        return [torch.cat([g.chunk(n, dim=0)[j] for g in groups]) for j in range(n)]

    def shard_forward(self, j: int, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[j].to(x.device).to(x.dtype)
        if self.mode == "row":
            return F.linear(x, w)
        return F.linear(x, w, self.bias[j].to(x.device).to(x.dtype))

    def reduce(self, parts: list[torch.Tensor], device: torch.device) -> torch.Tensor:
        """Row-parallel: the partial products summed over tp (psum) on
        ``device``, then the bias."""
        total = reduce_to(parts, device)
        return total + self.bias.to(device).to(total.dtype)

    def dense(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The full (out, in) kernel and the bias, on the first slice's
        device."""
        dev = self.weight[0].device
        ws = [w.detach().to(dev) for w in self.weight]
        if self.mode == "row":
            return torch.cat(ws, dim=1), self.bias.detach().to(dev)
        bs = [b.detach().to(dev) for b in self.bias]
        n = len(ws)

        def join(parts):
            per = [p.chunk(self.groups, dim=0) for p in parts]
            return torch.cat([per[j][g] for g in range(self.groups) for j in range(n)])

        return join(ws), join(bs)


def shard_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Place every weight of ``module`` by its rule, in place: each Dense
    whose kernel has an axis on tp becomes a ``ShardedDense`` (with tp > 1),
    and every other parameter and buffer moves to the mesh's first device
    (replicated: a dp shard reads its copy from there). Returns
    ``module``."""
    module.to(mesh.lead)
    if mesh.shape.get(TENSOR_AXIS, 1) == 1:
        return module
    for parent in list(module.modules()):
        for name, child in list(parent.named_children()):
            if not isinstance(child, Dense) or child.axes is None:
                continue
            kin, kout = mesh_axes(child.axes)
            if kout == TENSOR_AXIS:
                setattr(parent, name, ShardedDense(child, mesh, "column"))
            elif kin == TENSOR_AXIS:
                setattr(parent, name, ShardedDense(child, mesh, "row"))
    return module


def dense_state_dict(module: nn.Module) -> dict[str, torch.Tensor]:
    """``module``'s state dict with every ``ShardedDense`` gathered back into
    one kernel and bias, the keys of the unsharded module."""
    state = dict(module.state_dict())
    for prefix, m in module.named_modules():
        if isinstance(m, ShardedDense):
            for k in [k for k in state if k.startswith(f"{prefix}.")]:
                del state[k]
            state[f"{prefix}.weight"], state[f"{prefix}.bias"] = m.dense()
    return state


def replicas(module: nn.Module, mesh: Mesh, axis: str = DATA_AXIS) -> list[nn.Module]:
    """The module each shard along ``axis`` runs: shard 0 runs ``module``
    itself, every other shard a copy with each weight on the shard's device
    at its position on the other axes (``Mesh.moved``), on every mesh, a
    virtual one too. The copies are made once per module and mesh; a call
    after the module's parameters or buffers changed (an optimizer step, a
    loaded checkpoint) copies them again (the dp broadcast of the weights),
    and the copies follow the module's train or eval mode."""
    src = [*module.parameters(), *module.buffers()]
    sig = [(t.data_ptr(), t._version) for t in src]
    with _REPLICAS_LOCK, torch.inference_mode(False), torch.no_grad():
        entry = _REPLICAS.get(module)
        if entry is None or entry.mesh is not mesh or entry.axis != axis:
            copies = []
            for i in range(1, mesh.shape.get(axis, 1)):
                twin = copy.deepcopy(module)
                for t in [*twin.parameters(), *twin.buffers()]:
                    t.data = t.data.to(mesh.moved(t.device, axis, i))
                    t.grad = None
                copies.append(twin)
            entry = _REPLICAS[module] = _Replicas(mesh, axis, copies, sig)
        elif entry.sig != sig:
            for twin in entry.copies:
                for r, t in zip([*twin.parameters(), *twin.buffers()], src):
                    r.copy_(t)
            entry.sig = sig
    for twin in entry.copies:
        twin.train(module.training)
    return [module, *entry.copies]


def reduce_replica_grads(models: list[nn.Module]) -> None:
    """The dp psum of the gradients: each copy's (``replicas``) added to
    the module's own, ``models[0]``, and cleared."""
    for twin in models[1:]:
        for r, p in zip(twin.parameters(), models[0].parameters()):
            if r.grad is not None:
                g = r.grad.to(p.device)
                p.grad = g if p.grad is None else p.grad + g
                r.grad = None


@dataclasses.dataclass
class _Replicas:
    mesh: Mesh
    axis: str
    copies: list[nn.Module]
    sig: list  # the module's tensors when last copied: (pointer, version)


_REPLICAS: "weakref.WeakKeyDictionary[nn.Module, _Replicas]" = weakref.WeakKeyDictionary()
_REPLICAS_LOCK = threading.Lock()  # an engine's callers may share its model
