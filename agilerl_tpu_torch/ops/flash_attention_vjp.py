"""Flash attention forward with logsumexp: the port of
``agilerl_tpu/ops/flash_attention_vjp.py``.

Layout as in the JAX package: q, k, v ``[B, H, T, d]`` with an optional
``[B, T]`` key padding mask (1 = real token); the result is out
``[B, H, T, d]`` in q's dtype and lse ``[B, H, T]`` in float32. k and v may
carry fewer heads than q (GQA, ``H % Hkv == 0``): query head h reads KV head
``h // (H // Hkv)``, the head that ``jnp.repeat(k, rep, axis=heads)`` would
have placed at h, so callers may pass either the repeated or the unrepeated
tensors.

On CPU tensors the plain version ``flash_attention_reference`` runs. On CUDA
tensors the hand-written kernel ``csrc/flash_attention_fwd.cu`` runs (it
replaces the TPU kernel ``_fwd_kernel``), or the call raises. The backward
kernels (``_dq_kernel``, ``_dkv_kernel``) are the next slice's work: until
then a CUDA call that would need a gradient raises instead of quietly
differentiating the plain version.

Query rows whose visible keys are all masked (left padding) come out as
finite garbage in both versions, as in the TPU kernel; callers read real rows
only.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from agilerl_tpu_torch.ops import check_kernel_input
from agilerl_tpu_torch.ops._build import load_library

_NEG = -1e30
_SUPPORTED_HEAD_DIMS = (64, 128)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain masked softmax with the kernel's numerics: f32 scores, masked
    scores -1e30, p rounded to v's dtype before the P.V product,
    out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30))."""
    B, H, T, d = q.shape
    rep = H // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    visible = torch.ones((T, T), dtype=torch.bool, device=q.device)
    if causal:
        visible = torch.tril(visible)
    visible = visible[None, None]
    if padding_mask is not None:
        visible = visible & (padding_mask[:, None, None, :] > 0)
    s = torch.where(visible, s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


_ARGTYPES = (
    [ctypes.c_void_p] * 6          # q, k, v, mask, out, lse
    + [ctypes.c_int] * 5           # B, H, Hkv, T, d
    + [ctypes.c_longlong] * 9      # q, k, v strides over (b, h, t)
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)


def flash_attention_fwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attention_fwd.cu`` on the current stream.
    q/k/v may be strided views over (b, h, t) but must be contiguous in d."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_attention_fwd_cuda takes CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention kernel takes f32 or bf16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_input(name, t, q.dtype, 4, dev)
    B, H, T, d = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, T, d) or tuple(v.shape) != (B, Hkv, T, d):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"q heads {H} are not a multiple of kv heads {Hkv}")
    if d not in _SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {_SUPPORTED_HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid")
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)):
        raise ValueError("the bf16 kernel reads 16-byte rows: q/k/v need 16-byte aligned "
                         "data and (b, h, t) strides that are multiples of 8")
    mask = None
    if padding_mask is not None:
        if tuple(padding_mask.shape) != (B, T):
            raise ValueError(f"padding_mask must be [B, T] = {(B, T)}")
        mask = padding_mask.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, H, T, d), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    if T == 0:
        return out, lse
    lib = load_library("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 out.data_ptr(), lse.data_ptr(), B, H, Hkv, T, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), int(q.dtype == torch.bfloat16),
                 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0
flash_attention_fwd_cuda.kernel_name = "flash_attention_fwd"


def _fwd(q, k, v, padding_mask, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device rule: CPU tensors take the plain version, CUDA tensors the
    kernel (forward only in this slice)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, padding_mask, causal)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the flash attention backward kernels are not ported yet; call "
            "under torch.no_grad() or use the dense path (flash=False)")
    return flash_attention_fwd_cuda(q, k, v, padding_mask, causal)


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, T, d], lse [B, H, T]). The JAX function's block sizes
    are the TPU's; the kernel chooses its own tiles."""
    return _fwd(q, k, v, padding_mask, causal)


def flash_attention_diff(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """out [B, H, T, d]; the model's flash path calls this one. Forward
    only on CUDA tensors until the backward kernels are ported."""
    return _fwd(q, k, v, padding_mask, causal)[0]
