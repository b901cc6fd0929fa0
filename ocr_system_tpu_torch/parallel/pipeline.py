"""Pipeline parallelism: GPipe-style microbatch pipelining over a ``pp``
mesh axis (port of ocr_system_tpu/parallel/pipeline.py).

A model's blocks are partitioned into P contiguous stages, one per device
along the axis, and microbatches stream through the GPipe schedule: at
tick t (of n_micro + P - 1) device d works on microbatch t - d, and each
stage's output moves to the next device (``core.mesh.ppermute``). Stage
parameters are stacked along a leading axis (``stack_stage_params``); each
device takes its own slice. The JAX package gets the backward pass from
``ppermute``'s transpose; here autograd runs back through the same moves,
so the pp train step is the gradient of ``pipeline_apply``. Ticks where a
device holds no microbatch (the bubble) compute nothing: the JAX schedule
computes them on zeros and discards the result.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from ocr_system_tpu_torch.core.mesh import Mesh

PIPE_AXIS = "pp"


def pipeline_apply(stage_fn: Callable, stacked_params: Mapping[str, torch.Tensor],
                   x_micro: torch.Tensor, mesh: Mesh, axis: str = PIPE_AXIS) -> torch.Tensor:
    """Run microbatches through the pipeline stages.

    stage_fn(stage_params, x) -> y applies one stage and keeps x's shape;
    stacked_params: a mapping of tensors with leading dim P (one slice per
    stage); x_micro: (n_micro, mb, ...). Returns (n_micro, mb, ...) on
    x_micro's device: microbatch i is stage_{P-1}(... stage_0(x_micro[i])).
    """
    devs = mesh.axis_devices(axis)
    n_pipe, n_micro = len(devs), x_micro.shape[0]
    for k, v in stacked_params.items():
        if v.shape[0] != n_pipe:
            raise ValueError(f"{k}: {v.shape[0]} stages for {axis}={n_pipe}")
    params = [{k: v[d].to(dev) for k, v in stacked_params.items()}
              for d, dev in enumerate(devs)]
    inbox: list[torch.Tensor | None] = [None] * n_pipe  # what each device reads next
    outs: list[torch.Tensor | None] = [None] * n_micro
    for t in range(n_micro + n_pipe - 1):
        sent: list[torch.Tensor | None] = [None] * n_pipe
        for d, dev in enumerate(devs):
            mb = t - d
            if not 0 <= mb < n_micro:
                continue
            inp = x_micro[mb].to(dev) if d == 0 else inbox[d]
            y = stage_fn(params[d], inp)
            if d == n_pipe - 1:
                outs[mb] = y.to(x_micro.device)
            else:
                sent[d] = y
        # the hop d -> d + 1 (the ring's wrap-around carries nothing)
        inbox = [None] + [None if y is None else y.to(devs[d + 1])
                          for d, y in enumerate(sent[:-1])]
    return torch.stack(outs)


def stack_stage_params(per_stage_params: list[Mapping[str, torch.Tensor]]) -> dict:
    """[stage0, stage1, ...] mappings of tensors -> one mapping whose
    tensors have a leading dim P. Stages must have the same keys and
    shapes."""
    return {k: torch.stack([p[k] for p in per_stage_params]) for k in per_stage_params[0]}


def serial_reference(stage_fn: Callable, per_stage_params: list, x: torch.Tensor) -> torch.Tensor:
    """What the pipeline must equal: the stages applied in order, no mesh."""
    for p in per_stage_params:
        x = stage_fn(p, x)
    return x
