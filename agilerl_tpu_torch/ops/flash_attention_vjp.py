"""Differentiable flash attention with logsumexp: the port of
``agilerl_tpu/ops/flash_attention_vjp.py``.

Layout as in the JAX package: q, k, v ``[B, H, T, d]`` with an optional
``[B, T]`` key padding mask (1 = real token); the forward gives out
``[B, H, T, d]`` in q's dtype and lse ``[B, H, T]`` in float32. k and v may
carry fewer heads than q (GQA, ``H % Hkv == 0``): query head h reads KV head
``h // (H // Hkv)``, the head that ``jnp.repeat(k, rep, axis=heads)`` would
have placed at h, so callers may pass either the repeated or the unrepeated
tensors; dK/dV come back in k's and v's shape, summed over each group.

``flash_attention_with_lse`` and ``flash_attention_diff`` are one
``torch.autograd.Function`` whose two outputs are both differentiable. Its
backward is the FlashAttention-2 recomputation of the JAX package: with
``D = rowsum(dO * O)`` (minus the lse cotangent) computed as a torch op
before the launch, as ``_bwd_arrays`` does outside its kernels,
``p = exp(s - lse)`` over visible keys (0 elsewhere), ``dS = p (dO Vᵀ - D)``,
``dQ = dS K · scale``, ``dK = dSᵀ Q · scale``, ``dV = pᵀ dO``, with dS and p
rounded to the input dtype before each product.

Device rule: on CPU tensors the plain versions (``flash_attention_reference``
and ``flash_attention_bwd_reference``) run. On CUDA tensors the hand-written
kernels run, or the call raises: ``csrc/flash_attention_fwd.cu`` (replaces
the TPU kernel ``_fwd_kernel``) and ``csrc/flash_attention_bwd.cu``
(``_dq_kernel`` and ``_dkv_kernel``).

Head dims: the TPU kernels take any d (their blocks span the whole head
dim), and so do the CUDA kernels. They are built for d = 64, 128 and 256,
and past 256 for every multiple of 64 (the wide kernels: a block owns a
column group of its output, at most 256 columns, and accumulates the scores
over 64-column chunks of the whole d). In bf16 past 256 the scores are
computed once a tile: the forward up to 512 runs each q tile as one block
of two warpgroups that split d by 64-column boxes (ceil(d / 128) boxes of
out for the first, the rest for the second, up to 128 f32 accumulator
registers a thread and no spill), keeps Q in shared memory and streams K
and V, a whole tile a unit, through a ring of two units (140-214 KB of
shared memory, one block an SM); the two warpgroups add their partial
scores through 16 KB of shared memory and overlap the previous tile's P V
with the softmax. The dQ up to 512 runs each q tile as one block of two
warpgroups that own 256 columns of dQ each, and the dK/dV up to 1,024 each
kv tile as one cluster of ceil(d / 128) blocks that split d and add their
partial scores through distributed shared memory. The CUDA sources alone
hold these limits (``FWD_SPLIT_MAX_D``, ``DQ_SPLIT_MAX_D``, ``CL_MAX_D``);
``flash_fwd_last_launch`` and ``flash_bwd_last_launch`` read back what a
launch ran. The wrappers run any other d at the
head dim ``flash_head_dim_plan`` gives (the smallest of 64, 128 and 256
that holds d, else d rounded up to a multiple of 64), on copies of q, k, v
(and dO) zero-padded along d, with the scale 1/sqrt(d) of the true d, and
slice the padded columns off out, dq, dk and dv. Zero columns add nothing
to a score, and the outputs' padded columns come out zero. No head dim has
an upper limit.

Query rows with no visible key (left padding under causal masking, a batch
row of padding only) come out of the forward finite, and callers read the
other rows only. The bf16 kernel gives them out = 0 and lse = -1e30 +
log(1e-30): it skips the tiles without a visible key, and a masked score
adds p = 0. The f32 kernel and the plain version, like the TPU kernel, give
them the mean of v over the masked keys they visit (so the JAX kernel and
the plain version may differ there). The backward gives them p = 0, as the
TPU kernels' ``where(mask, exp(s - lse), 0)`` does, so they send no gradient
anywhere.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from agilerl_tpu_torch.ops import check_kernel_input
from agilerl_tpu_torch.ops._build import load_library

_NEG = -1e30
_KERNEL_HEAD_DIMS = (64, 128, 256)


def flash_head_dim_plan(d: int) -> int:
    """The head dim the CUDA kernels run a head dim ``d`` at: the smallest
    of 64, 128 and 256 that is at least ``d``, and past 256 ``d`` rounded up
    to a multiple of 64 (the wide kernels). Raises ``ValueError`` for a
    ``d`` below 1."""
    if d < 1:
        raise ValueError(f"head_dim {d} must be positive")
    for hd in _KERNEL_HEAD_DIMS:
        if d <= hd:
            return hd
    return -(-d // 64) * 64


def _pad_head(t: torch.Tensor, hd: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``hd`` (a contiguous copy)."""
    return t if t.shape[-1] == hd else torch.nn.functional.pad(t, (0, hd - t.shape[-1]))


def _visible(T: int, padding_mask: Optional[torch.Tensor], causal: bool,
             device: torch.device) -> torch.Tensor:
    """[1 or B, 1, T, T] bool: query row i may attend key j."""
    visible = torch.ones((T, T), dtype=torch.bool, device=device)
    if causal:
        visible = torch.tril(visible)
    visible = visible[None, None]
    if padding_mask is not None:
        visible = visible & (padding_mask[:, None, None, :] > 0)
    return visible


def _repeat_kv(x: torch.Tensor, rep: int) -> torch.Tensor:
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain masked softmax with the kernel's numerics: f32 scores, masked
    scores -1e30, p rounded to v's dtype before the P.V product,
    out = acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)). ``scale``
    defaults to 1/sqrt(d)."""
    B, H, T, d = q.shape
    rep = H // k.shape[1]
    k, v = _repeat_kv(k, rep), _repeat_kv(v, rep)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = torch.where(_visible(T, padding_mask, causal, q.device), s, _NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    dd: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the TPU kernels' formulas (``_dq_kernel``,
    ``_dkv_kernel``), not autograd through the forward: p is
    ``where(visible, exp(s - lse), 0)``, so rows with no visible key give
    p = 0 (the plain forward gives them p = 1 over the masked keys).
    ``dd`` is ``rowsum(dO * O)`` minus the lse cotangent, f32 [B, H, T];
    ``scale`` defaults to 1/sqrt(d)."""
    B, H, T, d = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    kr, vr = _repeat_kv(k, rep), _repeat_kv(v, rep)
    s = torch.matmul(q.float(), kr.float().transpose(-1, -2)) * scale
    visible = _visible(T, padding_mask, causal, q.device)
    p = torch.where(visible, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = torch.matmul(dout.float(), vr.float().transpose(-1, -2))
    ds = p * (dp - dd.float()[..., None])
    dq = torch.matmul(ds.to(k.dtype).float(), kr.float()) * scale
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dout.float())
    dk = dk.view(B, Hkv, rep, T, d).sum(dim=2)
    dv = dv.view(B, Hkv, rep, T, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------- #
# CUDA wrappers
# --------------------------------------------------------------------------- #


def _check_qkv(q, k, v, name: str) -> Tuple[int, int, int, int, int]:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention kernels take f32 or bf16, got {q.dtype}")
    for n, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_input(n, t, q.dtype, 4, dev)
    B, H, T, d = q.shape
    Hkv = k.shape[1]
    if tuple(k.shape) != (B, Hkv, T, d) or tuple(v.shape) != (B, Hkv, T, d):
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"q heads {H} are not a multiple of kv heads {Hkv}")
    if d != flash_head_dim_plan(d):
        raise ValueError(f"head_dim {d} is not one the kernels are built for "
                         f"({_KERNEL_HEAD_DIMS} or a multiple of 64 past 256)")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the kernel's grid")
    return B, H, Hkv, T, d


def _rows_16_byte_aligned(t: torch.Tensor) -> bool:
    return t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and all(
        st % 8 == 0 for st in t.stride()[:3])


def _check_bf16_rows(*tensors) -> None:
    if not all(_rows_16_byte_aligned(t) for t in tensors):
        raise ValueError("the bf16 kernels read 16-byte rows: q/k/v need 16-byte aligned "
                         "data and (b, h, t) strides that are multiples of 8")


def _mask_arg(padding_mask, B: int, T: int, dev: torch.device) -> Optional[torch.Tensor]:
    if padding_mask is None:
        return None
    if tuple(padding_mask.shape) != (B, T):
        raise ValueError(f"padding_mask must be [B, T] = {(B, T)}")
    return padding_mask.to(device=dev, dtype=torch.int32).contiguous()


def _bind(lib_name: str, fn_name: str, argtypes):
    fn = getattr(load_library(lib_name), fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


_FWD_ARGTYPES = (
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
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/flash_attention_fwd.cu`` on the current stream.
    q/k/v may be strided views over (b, h, t) but must be contiguous in d.
    A head dim the kernel is not built for runs zero-padded
    (``flash_head_dim_plan``); ``scale`` defaults to 1/sqrt(d)."""
    d = q.shape[-1]
    hd = flash_head_dim_plan(d)  # raises for d < 1 before the scale divides by it
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if hd != d:
        out, lse = flash_attention_fwd_cuda(
            _pad_head(q, hd), _pad_head(k, hd), _pad_head(v, hd), padding_mask, causal, scale)
        return out[..., :d], lse
    B, H, Hkv, T, d = _check_qkv(q, k, v, "flash_attention_fwd_cuda")
    dev = q.device
    if q.dtype == torch.bfloat16:
        _check_bf16_rows(q, k, v)
    mask = _mask_arg(padding_mask, B, T, dev)
    out = torch.empty((B, H, T, d), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    if T == 0:
        return out, lse
    fn = _bind("flash_attention_fwd", "flash_attention_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 out.data_ptr(), lse.data_ptr(), B, H, Hkv, T, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 int(causal), int(q.dtype == torch.bfloat16), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    flash_attention_fwd_cuda.launches += 1
    return out, lse


flash_attention_fwd_cuda.launches = 0
flash_attention_fwd_cuda.kernel_name = "flash_attention_fwd"
flash_attention_fwd_cuda.source = "flash_attention_fwd"


def flash_fwd_last_launch() -> dict:
    """What the last accepted launch of ``flash_attention_fwd_cuda`` in this
    process ran, as ``csrc/flash_attention_fwd.cu``'s launcher configured
    it: ``kind`` ("wgmma", "f32", "fwd_split", "column_groups",
    "column_groups_f32"; "none" before the first) and ``threads`` a block."""
    fn = _bind("flash_attention_fwd", "flash_attention_fwd_last_launch",
               [ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int)])
    kind, threads = ctypes.c_char_p(), ctypes.c_int()
    err = fn(ctypes.byref(kind), ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd_last_launch failed: CUDA error {err}")
    return dict(kind=kind.value.decode(), threads=threads.value)


_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 7          # q, k, v, dout, lse, dd, mask
    + [ctypes.c_void_p]            # dq  (dkv: dk, dv; see _launch_bwd)
    + [ctypes.c_int] * 5           # B, H, Hkv, T, d
    + [ctypes.c_void_p]            # 12 strides: q, k, v, dout over (b, h, t)
    + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
)


def _bwd_inputs(q, k, v, dout, lse, dd, padding_mask, name):
    """Checks shared by the two backward wrappers. Returns the shapes
    (B, H, Hkv, T, d), dO (made contiguous where the kernel cannot read it as
    it is), the int32 mask or None, and the 12 strides as a host tensor."""
    B, H, Hkv, T, d = _check_qkv(q, k, v, name)
    dev = q.device
    if q.dtype == torch.bfloat16:
        _check_bf16_rows(q, k, v)
        # the bf16 kernels' tensor maps take no zero stride (an expanded dO)
        if not _rows_16_byte_aligned(dout) or 0 in dout.stride():
            dout = dout.contiguous()
    elif dout.stride(-1) != 1:
        dout = dout.contiguous()
    check_kernel_input("dout", dout, q.dtype, 4, dev)
    if tuple(dout.shape) != (B, H, T, d):
        raise ValueError(f"dout shape {tuple(dout.shape)} does not match q {tuple(q.shape)}")
    for n, t in (("lse", lse), ("dd", dd)):
        check_kernel_input(n, t, torch.float32, 3, dev)
        if tuple(t.shape) != (B, H, T) or not t.is_contiguous():
            raise ValueError(f"{n} must be contiguous [B, H, T] = {(B, H, T)}")
    mask = _mask_arg(padding_mask, B, T, dev)
    strides = torch.tensor([*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                            *dout.stride()[:3]], dtype=torch.int64)
    return (B, H, Hkv, T, d), dout, mask, strides


def _launch_bwd(fn_name, outs, q, k, v, dout, lse, dd, mask, strides, shape, causal, scale):
    B, H, Hkv, T, d = shape
    argtypes = list(_BWD_ARGTYPES)
    argtypes[7:8] = [ctypes.c_void_p] * len(outs)
    fn = _bind("flash_attention_bwd", fn_name, argtypes)
    dev = q.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), dd.data_ptr(),
                 mask.data_ptr() if mask is not None else None,
                 *(o.data_ptr() for o in outs), B, H, Hkv, T, d,
                 strides.data_ptr(), int(causal), int(q.dtype == torch.bfloat16), scale,
                 stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")


def flash_attention_dq_cuda(q, k, v, dout, lse, dd, padding_mask=None,
                            causal: bool = True, scale: Optional[float] = None) -> torch.Tensor:
    """Launch the dQ kernel of ``csrc/flash_attention_bwd.cu``: dq
    [B, H, T, d] in q's dtype. q/k/v/dout may be strided over (b, h, t); a
    head dim the kernel is not built for runs zero-padded."""
    d = q.shape[-1]
    hd = flash_head_dim_plan(d)  # raises for d < 1 before the scale divides by it
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if hd != d:
        return flash_attention_dq_cuda(*(_pad_head(t, hd) for t in (q, k, v, dout)), lse, dd,
                                       padding_mask, causal, scale)[..., :d]
    shape, dout, mask, strides = _bwd_inputs(q, k, v, dout, lse, dd, padding_mask,
                                             "flash_attention_dq_cuda")
    B, H, _, T, d = shape
    dq = torch.empty((B, H, T, d), dtype=q.dtype, device=q.device)
    if T == 0:
        return dq
    _launch_bwd("flash_attention_dq", (dq,), q, k, v, dout, lse, dd, mask, strides, shape,
                causal, scale)
    flash_attention_dq_cuda.launches += 1
    return dq


flash_attention_dq_cuda.launches = 0
flash_attention_dq_cuda.kernel_name = "flash_attention_dq"
flash_attention_dq_cuda.source = "flash_attention_bwd"


def flash_attention_dkv_cuda(q, k, v, dout, lse, dd, padding_mask=None, causal: bool = True,
                             scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel of ``csrc/flash_attention_bwd.cu``: (dk, dv)
    [B, Hkv, T, d] in k's dtype, summed over each GQA group in the kernel; a
    head dim the kernel is not built for runs zero-padded."""
    d = q.shape[-1]
    hd = flash_head_dim_plan(d)  # raises for d < 1 before the scale divides by it
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    if hd != d:
        dk, dv = flash_attention_dkv_cuda(*(_pad_head(t, hd) for t in (q, k, v, dout)), lse,
                                          dd, padding_mask, causal, scale)
        return dk[..., :d], dv[..., :d]
    shape, dout, mask, strides = _bwd_inputs(q, k, v, dout, lse, dd, padding_mask,
                                             "flash_attention_dkv_cuda")
    B, H, Hkv, T, d = shape
    dk = torch.empty((B, Hkv, T, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Hkv, T, d), dtype=v.dtype, device=q.device)
    if T == 0:
        return dk, dv
    _launch_bwd("flash_attention_dkv", (dk, dv), q, k, v, dout, lse, dd, mask, strides, shape,
                causal, scale)
    flash_attention_dkv_cuda.launches += 1
    return dk, dv


flash_attention_dkv_cuda.launches = 0
flash_attention_dkv_cuda.kernel_name = "flash_attention_dkv"
flash_attention_dkv_cuda.source = "flash_attention_bwd"


def flash_bwd_last_launch(which: str) -> dict:
    """What the last accepted launch of ``flash_attention_dq_cuda``
    (``which="dq"``) or ``flash_attention_dkv_cuda`` (``"dkv"``) in this
    process ran, as ``csrc/flash_attention_bwd.cu``'s launcher configured
    it: ``kind`` ("wgmma", "f32", "column_groups", "column_groups_f32",
    "dq_split", "dkv_cluster"; "none" before the first), ``cluster`` (blocks
    in a cluster, 1 for none) and ``threads`` a block."""
    if which not in ("dq", "dkv"):
        raise ValueError(f"which must be 'dq' or 'dkv', not {which!r}")
    fn = _bind("flash_attention_bwd", "flash_attention_bwd_last_launch",
               [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)] + [ctypes.POINTER(ctypes.c_int)] * 2)
    kind, cluster, threads = ctypes.c_char_p(), ctypes.c_int(), ctypes.c_int()
    err = fn(int(which == "dkv"), ctypes.byref(kind), ctypes.byref(cluster), ctypes.byref(threads))
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_last_launch failed: CUDA error {err}")
    return dict(kind=kind.value.decode(), cluster=cluster.value, threads=threads.value)


# --------------------------------------------------------------------------- #
# Device rule + autograd
# --------------------------------------------------------------------------- #


def _fwd(q, k, v, padding_mask, causal) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device rule: CPU tensors take the plain version, CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, padding_mask, causal)
    return flash_attention_fwd_cuda(q, k, v, padding_mask, causal)


def _bwd(q, k, v, dout, lse, dd, padding_mask, causal):
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, dout, lse, dd, padding_mask, causal)
    # one zero-padded copy of q, k, v and dO serves both kernels
    d = q.shape[-1]
    hd = flash_head_dim_plan(d)
    q, k, v, dout = (_pad_head(t, hd) for t in (q, k, v, dout))
    scale = 1.0 / math.sqrt(d)
    dq = flash_attention_dq_cuda(q, k, v, dout, lse, dd, padding_mask, causal, scale)
    dk, dv = flash_attention_dkv_cuda(q, k, v, dout, lse, dd, padding_mask, causal, scale)
    return dq[..., :d], dk[..., :d], dv[..., :d]


class _FlashAttention(torch.autograd.Function):
    """(out, lse), both differentiable (the JAX package's two custom VJPs)."""

    @staticmethod
    def forward(ctx, q, k, v, padding_mask, causal):
        out, lse = _fwd(q, k, v, padding_mask, causal)
        ctx.save_for_backward(q, k, v, padding_mask, out, lse)
        ctx.causal = causal
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, padding_mask, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        # D = rowsum(dO * O) outside the kernels, as _bwd_arrays; an lse
        # cotangent enters as D - dlse
        dd = (dout.float() * out.float()).sum(dim=-1)
        if dlse is not None:
            dd = dd - dlse.float()
        dq, dk, dv = _bwd(q, k, v, dout, lse, dd.contiguous(), padding_mask, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [B, H, T, d], lse [B, H, T]), both differentiable. The JAX
    function's block sizes are the TPU's; the kernels choose their own tiles."""
    return _FlashAttention.apply(q, k, v, padding_mask, causal)


def flash_attention_diff(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """out [B, H, T, d], differentiable; the model's flash path calls this."""
    return _FlashAttention.apply(q, k, v, padding_mask, causal)[0]
