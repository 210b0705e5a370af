"""Fused lm-head + log-softmax: the port of ``agilerl_tpu/ops/fused_loss.py``.

Per row ``log softmax(hidden @ head / temperature)[target]`` without writing
the ``[N, V]`` logits. ``fused_token_logprob_diff`` is a
``torch.autograd.Function`` whose backward recomputes the logits from
(hidden, head, lse), as the JAX package's custom VJP does:
``coef = g (onehot(t) - p)``, ``dH = coef headᵀ / T``, ``dW = hiddenᵀ coef / T``;
dW is skipped when the head needs no gradient (a frozen head under LoRA).

Device rule: on CPU tensors the plain versions run; on CUDA tensors the
hand-written kernels run, or the call raises: ``csrc/fused_logprob_fwd.cu``
(replaces the TPU kernel ``_make_kernel``) and ``csrc/fused_logprob_bwd.cu``
(``_make_dh_kernel`` and ``_make_dw_kernel``). Operands are f32 x f32 and the
kernels do f32 arithmetic (no TF32). ``_fit_blocks``/``_VMEM_BUDGET`` size
tiles for the TPU's VMEM and have no counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from agilerl_tpu_torch.ops import check_kernel_input
from agilerl_tpu_torch.ops._build import load_library

_ROWS_PER_TILE = 128   # BN in the forward kernel
_COLS_PER_TILE = 128   # BV in the forward kernel
_BLOCKS_PER_SM = 2     # resident blocks the vocab split aims for
_BWD_CHUNK = 8192      # vocab columns whose coefficient the backward stages at once


def _plain_fwd(hidden, head, targets, temperature) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = (hidden.float() @ head.float()) / temperature
    lse = torch.logsumexp(logits, dim=-1)
    chosen = logits.gather(1, targets.long()[:, None])[:, 0]
    return chosen - lse, lse


def reference_token_logprob(hidden, head, targets, temperature: float = 1.0):
    """Dense reference: materialises the [N, V] f32 logits."""
    return _plain_fwd(hidden, head, targets, temperature)[0]


def _plain_coef(hidden, head, targets, lse, g, temperature) -> torch.Tensor:
    """``_bwd_coef``: g * (onehot(t) - p), p recomputed from lse; [N, V]."""
    logits = (hidden.float() @ head.float()) / temperature
    coef = -torch.exp(logits - lse.float()[:, None])
    coef.scatter_add_(1, targets.long()[:, None],
                      torch.ones((coef.shape[0], 1), dtype=coef.dtype, device=coef.device))
    return coef * g.float()[:, None]


def plain_dh(hidden, head, targets, lse, g, temperature: float = 1.0) -> torch.Tensor:
    """dH [N, D] = coef headᵀ / T (the plain version of the dH kernel)."""
    coef = _plain_coef(hidden, head, targets, lse, g, temperature)
    return (coef @ head.float().t()) / temperature


def plain_dw(hidden, head, targets, lse, g, temperature: float = 1.0) -> torch.Tensor:
    """dW [D, V] = hiddenᵀ coef / T (the plain version of the dW kernel)."""
    coef = _plain_coef(hidden, head, targets, lse, g, temperature)
    return (hidden.float().t() @ coef) / temperature


# forward: hidden, head, targets, out, lse, scratch; N, D, V, n_split, per
_FWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                 + [ctypes.c_float, ctypes.c_void_p])
# backward: hidden, head, targets, lse, g, out, scratch; N, D, V, chunk
_BWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                 + [ctypes.c_float, ctypes.c_void_p])


def vocab_split(n_rows: int, vocab: int, n_sms: int) -> Tuple[int, int]:
    """(n_split, tiles_per_split) for the grid (row tiles, vocab splits).

    Every block walks ``tiles_per_split`` vocab tiles, and the card runs
    ``_BLOCKS_PER_SM * n_sms`` blocks at a time, so the kernel takes about
    waves x tiles_per_split tile-times: pick the split that minimises it. A
    split that leaves a nearly empty last wave costs a whole block-time (at
    the scoring shapes, 7 splits give 280 blocks for 264 slots: two waves).
    Within 3 % of the least cost, the fewest splits win: fewer partial
    triples to merge."""
    n_rt = -(-n_rows // _ROWS_PER_TILE)
    n_vt = -(-vocab // _COLS_PER_TILE)
    slots = _BLOCKS_PER_SM * n_sms
    options = {}
    for want in range(1, n_vt + 1):
        per = -(-n_vt // want)
        n_split = -(-n_vt // per)
        options[n_split] = (-(-n_rt * n_split // slots) * per, per)
    least = min(cost for cost, _ in options.values())
    n_split = min(k for k, (cost, _) in options.items() if cost <= 1.03 * least)
    return n_split, options[n_split][1]


def _check_operands(hidden, head, name: str) -> Tuple[int, int, int]:
    dev = hidden.device
    if dev.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors")
    check_kernel_input("hidden", hidden, torch.float32, 2, dev)
    check_kernel_input("head", head, torch.float32, 2, dev)
    if not (hidden.is_contiguous() and head.is_contiguous()):
        raise ValueError("hidden and head must be contiguous")
    N, D = hidden.shape
    if head.shape[0] != D:
        raise ValueError(f"head {tuple(head.shape)} does not match hidden D={D}")
    if D % 8 or hidden.data_ptr() % 16 or head.data_ptr() % 16:
        raise ValueError("the fused kernels take D % 8 == 0 and 16-byte aligned operands")
    return N, D, head.shape[1]


def _row_vector(name, t, N, dtype, dev) -> torch.Tensor:
    if tuple(t.shape) != (N,):
        raise ValueError(f"{name} must be [N] = [{N}]")
    return t.to(device=dev, dtype=dtype).contiguous()


def _bind(lib_name: str, fn_name: str, argtypes):
    fn = getattr(load_library(lib_name), fn_name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def fused_logprob_fwd_cuda(hidden, head, targets, temperature: float = 1.0):
    """Launch ``csrc/fused_logprob_fwd.cu``; returns (logprob [N], lse [N])."""
    N, D, V = _check_operands(hidden, head, "fused_logprob_fwd_cuda")
    dev = hidden.device
    t32 = _row_vector("targets", targets, N, torch.int32, dev)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out, lse
    n_split, per = vocab_split(
        N, V, torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = torch.empty((3, n_split, N), dtype=torch.float32, device=dev)
    fn = _bind("fused_logprob_fwd", "fused_logprob_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(hidden.data_ptr(), head.data_ptr(), t32.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
                 N, D, V, n_split, per, 1.0 / temperature, stream)
    if err != 0:
        raise RuntimeError(f"fused_logprob_fwd launch failed: CUDA error {err}")
    fused_logprob_fwd_cuda.launches += 1
    return out, lse


fused_logprob_fwd_cuda.launches = 0
fused_logprob_fwd_cuda.kernel_name = "fused_logprob_fwd"
fused_logprob_fwd_cuda.source = "fused_logprob_fwd"


def _launch_bwd(fn_name, out, hidden, head, targets, lse, g, temperature):
    N, D, V = _check_operands(hidden, head, f"{fn_name}_cuda")
    dev = hidden.device
    t32 = _row_vector("targets", targets, N, torch.int32, dev)
    lse = _row_vector("lse", lse, N, torch.float32, dev)
    g = _row_vector("g", g, N, torch.float32, dev)
    if N == 0:
        return False
    chunk = min(_BWD_CHUNK, -(-V // _COLS_PER_TILE) * _COLS_PER_TILE)
    scratch = torch.empty((N, chunk), dtype=torch.float32, device=dev)
    fn = _bind("fused_logprob_bwd", fn_name, _BWD_ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(hidden.data_ptr(), head.data_ptr(), t32.data_ptr(), lse.data_ptr(),
                 g.data_ptr(), out.data_ptr(), scratch.data_ptr(), N, D, V, chunk,
                 1.0 / temperature, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    return True


def fused_logprob_dh_cuda(hidden, head, targets, lse, g, temperature: float = 1.0):
    """Launch the dH kernels of ``csrc/fused_logprob_bwd.cu``: dH [N, D] f32.
    The coefficient is staged one vocab chunk at a time (``_BWD_CHUNK``)."""
    dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device)
    if _launch_bwd("fused_logprob_dh", dh, hidden, head, targets, lse, g, temperature):
        fused_logprob_dh_cuda.launches += 1
    return dh


fused_logprob_dh_cuda.launches = 0
fused_logprob_dh_cuda.kernel_name = "fused_logprob_dh"
fused_logprob_dh_cuda.source = "fused_logprob_bwd"


def fused_logprob_dw_cuda(hidden, head, targets, lse, g, temperature: float = 1.0):
    """Launch the dW kernels of ``csrc/fused_logprob_bwd.cu``: dW [D, V] f32."""
    dw = torch.zeros(head.shape, dtype=torch.float32, device=head.device)
    if _launch_bwd("fused_logprob_dw", dw, hidden, head, targets, lse, g, temperature):
        fused_logprob_dw_cuda.launches += 1
    return dw


fused_logprob_dw_cuda.launches = 0
fused_logprob_dw_cuda.kernel_name = "fused_logprob_dw"
fused_logprob_dw_cuda.source = "fused_logprob_bwd"


# --------------------------------------------------------------------------- #
# Device rule + autograd
# --------------------------------------------------------------------------- #


def _fwd_call(hidden, head, targets, temperature) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device rule: CPU tensors take the plain version, CUDA tensors the kernel."""
    if hidden.device.type == "cpu":
        return _plain_fwd(hidden, head, targets, temperature)
    return fused_logprob_fwd_cuda(hidden, head, targets, temperature)


class _FusedLogprob(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, head, targets, temperature):
        out, lse = _fwd_call(hidden, head, targets, temperature)
        ctx.save_for_backward(hidden, head, targets, lse)
        ctx.temperature = temperature
        return out

    @staticmethod
    def backward(ctx, g):
        hidden, head, targets, lse = ctx.saved_tensors
        cpu = hidden.device.type == "cpu"
        dh = dw = None
        if ctx.needs_input_grad[0]:
            fn = plain_dh if cpu else fused_logprob_dh_cuda
            dh = fn(hidden, head, targets, lse, g, ctx.temperature).to(hidden.dtype)
        if ctx.needs_input_grad[1]:
            fn = plain_dw if cpu else fused_logprob_dw_cuda
            dw = fn(hidden, head, targets, lse, g, ctx.temperature).to(head.dtype)
        return dh, dw, None, None


def fused_token_logprob(
    hidden: torch.Tensor,   # [N, D]
    head: torch.Tensor,     # [D, V]
    targets: torch.Tensor,  # [N] int
    temperature: float = 1.0,
) -> torch.Tensor:
    """Per-row log softmax(hidden @ head / T)[target]. Returns [N] float32.
    Differentiable: the backward recomputes the logits per vocab chunk from
    (hidden, head, lse), so the [N, V] logits never materialise on the card.
    The JAX function's block sizes are the TPU's; the kernels pick their own."""
    return _FusedLogprob.apply(hidden, head, targets, temperature)


# the JAX package's name for the differentiable entry point
fused_token_logprob_diff = fused_token_logprob
