"""Fused lm-head + log-softmax: the port of ``agilerl_tpu/ops/fused_loss.py``.

Per row ``log softmax(hidden @ head / temperature)[target]`` without writing
the ``[N, V]`` logits. On CPU tensors the plain version runs; on CUDA tensors
the hand-written kernel ``csrc/fused_logprob_fwd.cu`` runs (it replaces the
TPU kernel ``_make_kernel``), or the call raises. Operands are f32 x f32 and
the kernel does f32 arithmetic (no TF32).

The backward kernels (``_make_dh_kernel``, ``_make_dw_kernel``) are the next
slice's work: until then a CUDA call that would need a gradient raises.
``_fit_blocks``/``_VMEM_BUDGET`` size tiles for the TPU's VMEM and have no
counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from agilerl_tpu_torch.ops import check_kernel_input
from agilerl_tpu_torch.ops._build import load_library

_ROWS_PER_TILE = 128   # BN in the kernel
_COLS_PER_TILE = 128   # BV in the kernel
_BLOCKS_PER_SM = 2     # resident blocks the vocab split aims for


def _plain_fwd(hidden, head, targets, temperature) -> Tuple[torch.Tensor, torch.Tensor]:
    logits = (hidden.float() @ head.float()) / temperature
    lse = torch.logsumexp(logits, dim=-1)
    chosen = logits.gather(1, targets.long()[:, None])[:, 0]
    return chosen - lse, lse


def reference_token_logprob(hidden, head, targets, temperature: float = 1.0):
    """Dense reference: materialises the [N, V] f32 logits."""
    return _plain_fwd(hidden, head, targets, temperature)[0]


_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
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


def fused_logprob_fwd_cuda(hidden, head, targets, temperature: float = 1.0):
    """Launch ``csrc/fused_logprob_fwd.cu``; returns (logprob [N], lse [N])."""
    dev = hidden.device
    if dev.type != "cuda":
        raise ValueError("fused_logprob_fwd_cuda takes CUDA tensors")
    check_kernel_input("hidden", hidden, torch.float32, 2, dev)
    check_kernel_input("head", head, torch.float32, 2, dev)
    if not (hidden.is_contiguous() and head.is_contiguous()):
        raise ValueError("hidden and head must be contiguous")
    N, D = hidden.shape
    if head.shape[0] != D:
        raise ValueError(f"head {tuple(head.shape)} does not match hidden D={D}")
    V = head.shape[1]
    if D % 8 or hidden.data_ptr() % 16 or head.data_ptr() % 16:
        raise ValueError("the fused kernel takes D % 8 == 0 and 16-byte aligned operands")
    if tuple(targets.shape) != (N,):
        raise ValueError(f"targets must be [N] = [{N}]")
    t32 = targets.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out, lse
    n_split, per = vocab_split(
        N, V, torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = torch.empty((3, n_split, N), dtype=torch.float32, device=dev)
    lib = load_library("fused_logprob_fwd")
    fn = lib.fused_logprob_fwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
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


def _fwd_call(hidden, head, targets, temperature) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device rule: CPU tensors take the plain version, CUDA tensors the
    kernel (forward only in this slice)."""
    if hidden.device.type == "cpu":
        return _plain_fwd(hidden, head, targets, temperature)
    if torch.is_grad_enabled() and (hidden.requires_grad or head.requires_grad):
        raise NotImplementedError(
            "the fused logprob backward kernels are not ported yet; call "
            "under torch.no_grad() or use the chunked path (use_fused=False)")
    return fused_logprob_fwd_cuda(hidden, head, targets, temperature)


def fused_token_logprob(
    hidden: torch.Tensor,   # [N, D]
    head: torch.Tensor,     # [D, V]
    targets: torch.Tensor,  # [N] int
    temperature: float = 1.0,
) -> torch.Tensor:
    """Per-row log softmax(hidden @ head / T)[target]. Returns [N] float32.
    The JAX function's block sizes are the TPU's; the kernel picks its own."""
    return _fwd_call(hidden, head, targets, temperature)[0]
