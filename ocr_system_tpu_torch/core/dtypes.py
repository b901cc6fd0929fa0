"""Dtype policy (port of ocr_system_tpu/core/dtypes.py) and device choice.

One place decides which dtype flows through convolutions and matmuls versus
which is stored: parameters stay float32 (``param_dtype``) and are cast to
``compute_dtype`` for the forward pass, as the flax modules of the JAX
package do with ``dtype=``/``param_dtype=``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32

    def cast_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    @classmethod
    def from_names(cls, compute: str, param: str = "float32") -> "DTypePolicy":
        policy = cls(
            compute_dtype=getattr(torch, compute),
            param_dtype=getattr(torch, param),
        )
        if policy.compute_dtype == torch.float32:
            # float32 means float32: cuDNN convolutions default to TF32
            # (about three decimal digits), which would break parity with
            # the JAX reference; matmuls are pinned too in case a caller
            # turned TF32 on
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        return policy


def widen(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, the dtype of the policy's float32 islands
    (statistics, the heads, the losses), or as it is when it is float64: a
    float64 run keeps them exact (the training phases' exact reference)."""
    return x if x.dtype == torch.float64 else x.float()


def default_policy() -> DTypePolicy:
    return DTypePolicy()


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's entry points run on the card: ``None`` means ``cuda``,
    and asking for it without a card raises rather than quietly running on
    the CPU. Tests pass ``device="cpu"`` explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev
