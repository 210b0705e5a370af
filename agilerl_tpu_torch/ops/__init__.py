"""Hand-written Hopper kernels and the device rule that decides where they run.

Counterpart of ``agilerl_tpu/ops/__init__.py`` (``pallas_enabled``). There is
no switch here: a wrapper given CPU tensors runs its kernel's plain PyTorch
version, and a wrapper given CUDA tensors launches its kernel or raises. Each
wrapper keeps a plain ``launches`` count that goes up by one where it launches
its kernel and nowhere else.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card. Raises when no GPU is present, so an entry
    point never falls back to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev


def _kernel_wrappers():
    # imported here: the wrappers' modules import this one
    from agilerl_tpu_torch.ops import flash_attention_vjp as fa
    from agilerl_tpu_torch.ops import fused_loss as fl

    return (fa.flash_attention_fwd_cuda, fa.flash_attention_dq_cuda,
            fa.flash_attention_dkv_cuda, fl.fused_logprob_fwd_cuda,
            fl.fused_logprob_dh_cuda, fl.fused_logprob_dw_cuda)


def kernel_counters() -> dict:
    """``{name: launches}`` for every kernel wrapper of the port."""
    return {f.kernel_name: f.launches for f in _kernel_wrappers()}


def reset_kernel_counters() -> None:
    for f in _kernel_wrappers():
        f.launches = 0


def check_kernel_input(name: str, t: torch.Tensor, dtype: Optional[torch.dtype],
                       ndim: int, device: torch.device) -> None:
    """Shared argument check of the kernel wrappers: raises on what the
    kernel does not take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name} must be contiguous in its last dimension")


__all__ = ["resolve_device", "kernel_counters", "reset_kernel_counters",
           "check_kernel_input"]
