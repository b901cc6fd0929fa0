"""Model checkpoints of the port (port of ocr_system_tpu/core/checkpoint.py).

The JAX package keeps orbax PyTree checkpoints; the port keeps a model's
state dict (parameters and BatchNorm statistics) as one ``.npz`` file
through ``core/weights.save_npz``/``load_npz``, the format its engines
read through the ``*_checkpoint`` settings (``Settings.det_checkpoint``,
``rec_checkpoint``, ``extract_checkpoint``). Training writes float32;
rounding a copy to bf16 for the repository is an export decision
(``core/weights.bf16_but_norms``).
"""

from __future__ import annotations

import logging
from pathlib import Path

import torch
from torch import nn

from ocr_system_tpu_torch.core.weights import drop_train_only, load_npz, save_npz

logger = logging.getLogger(__name__)


def save_checkpoint(path: str | Path, model_or_state: nn.Module | dict) -> Path:
    """Write a model's state dict (or a state dict) as a float32 ``.npz``;
    a model's weights split over tp are gathered into the unsharded
    model's keys."""
    if isinstance(model_or_state, nn.Module):
        from ocr_system_tpu_torch.parallel.sharding import dense_state_dict

        state = dense_state_dict(model_or_state)
    else:
        state = model_or_state
    path = Path(path).absolute()
    if path.suffix != ".npz":
        raise ValueError(f"checkpoint {path}: the port writes .npz files")
    return save_npz(path, {k: v.detach().float() for k, v in state.items()})


def load_checkpoint(path: str | Path, model: nn.Module | None = None) -> dict[str, torch.Tensor]:
    """Read a checkpoint's state dict; with ``model``, load it into the model
    too (strictly, bar the model's training-only entries)."""
    state = load_npz(Path(path))
    if model is not None:
        state = drop_train_only(model, state)
        model.load_state_dict(state)
    return state


def maybe_load(path: str | Path | None, model: nn.Module | None = None) -> dict | None:
    """Load if the path is set and exists; None otherwise, logged loudly (an
    empty path once served random weights unnoticed in the JAX package)."""
    if not path:
        logger.warning("no checkpoint path set; using RANDOM init")
        return None
    if not Path(path).exists():
        logger.warning("checkpoint %s not found; using random init", path)
        return None
    return load_checkpoint(path, model)


def init_or_load(model: nn.Module, path: str | Path | None,
                 generator: torch.Generator) -> nn.Module:
    """``model`` with the checkpoint at ``path`` when it exists, else with
    flax's from-scratch initializers drawn from ``generator``
    (``model.init_flax_``)."""
    if maybe_load(path, model) is None:
        model.init_flax_(generator)
    return model
