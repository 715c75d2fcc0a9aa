"""Small shared utilities (port of diffulab_tpu/utils.py), plus the device
and dtype rules every entry point of the port follows."""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port's device rule: ``None`` means the card, and a CUDA device
    raises where there is none. The CPU is used only when the caller asks
    for it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) to run on the CPU"
        )
    return device


def full_fp32_products() -> None:
    """The port's fp32 policy: float32 matmuls and convolutions run as full
    fp32 products, as the reference's do (PyTorch's default lets cuDNN, and
    may let cuBLAS, run them in TF32). Every CLI's ``main`` sets it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_dtype(dtype: str | torch.dtype | None) -> torch.dtype | None:
    """Accept a torch dtype, its name ("bfloat16", as YAML configs spell it) or None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` promoted to float32 (or kept wider).

    JAX promotes a bf16 array times a non-weak fp32 0-d array to fp32; torch
    keeps such a product in bf16. Where the reference multiplies by an fp32
    scalar (schedule steps, the CFG scale), the port promotes explicitly.
    """
    return x.to(torch.promote_types(x.dtype, torch.float32))


def batch_broadcast(values: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Reshape a per-sample vector ``[B]`` to ``[B, 1, 1, ...]`` for broadcasting."""
    return values.reshape(values.shape[0], *([1] * (target_ndim - 1)))


def flatten_nonbatch_mean(x: torch.Tensor) -> torch.Tensor:
    """Per-sample mean over all non-batch dims: ``[B, ...] -> [B]``."""
    return x.reshape(x.shape[0], -1).mean(dim=-1)
