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
(``_make_dh_kernel`` and ``_make_dw_kernel``). Operands are f32 x f32. The
forward, dH and dW run on the tensor cores in 3xTF32: each f32 operand is
split into two TF32 numbers, hi + lo (``split_tf32``; ``tf32x3_split`` on the
card, once per call), and the products hi·hi + hi·lo + lo·hi accumulate in
f32, which agrees with an f32 product to f32 summation order.
``_fit_blocks``/``_VMEM_BUDGET`` size tiles for the TPU's VMEM and have no
counterpart here.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from agilerl_tpu_torch.ops import check_kernel_input
from agilerl_tpu_torch.ops._build import load_library

_COLS_PER_TILE = 128   # tc::BN: the kernels' vocab (forward, coefficient) and D (dH) tile
_BWD_CHUNK = 8192      # vocab columns whose coefficient the backward stages at once
_TMA_ALIGN = 4         # floats: a TMA row stride is a multiple of 16 bytes


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


def split_tf32(x: torch.Tensor, transpose: bool = False,
               ld: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``tf32x3_split``: x = hi + (x - hi) with
    hi = x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``) and lo = x - hi (exact in f32) rounded the
    same way, which is how the tensor cores read it. ``transpose`` splits
    xᵀ; ``ld`` > the last dimension pads it with zero columns."""
    def rna(t):
        bits = t.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.float()
    if transpose:
        x = x.t()
    hi = rna(x)
    lo = rna(x - hi)
    pad = ld - x.shape[-1]
    if pad > 0:
        hi, lo = (torch.nn.functional.pad(t, (0, pad)) for t in (hi, lo))
    return hi, lo


def tma_ld(n: int) -> int:
    """A row stride of at least n floats that TMA takes (16-byte multiple)."""
    return -(-n // _TMA_ALIGN) * _TMA_ALIGN


# split: src, hi, lo; rows, cols, ld_dst, transpose
_SPLIT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
# forward: hidden hi/lo, head^T hi/lo, targets, out, lse, scratch; N, D, V
_FWD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                 + [ctypes.c_float, ctypes.c_void_p])
# dH and dW: hidden hi/lo, head^T hi/lo, a third operand hi/lo (dH: head;
# dW: hidden^T); its row stride; targets, lse, g, out, coef hi/lo; N, D, V, chunk
_BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 6
                 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


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


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _split_cuda(x, transpose: bool = False, ld: int = 0):
    """Launch ``tf32x3_split``: (hi, lo) of x [R, C] as [R, ld] or,
    transposed, as [C, ld] (ld defaults to the source's row length; columns
    past it are 0)."""
    R, C = x.shape
    shape = (C, ld or R) if transpose else (R, ld or C)
    hi = torch.empty(shape, dtype=torch.float32, device=x.device)
    lo = torch.empty(shape, dtype=torch.float32, device=x.device)
    fn = _bind("fused_logprob_fwd", "tf32x3_split", _SPLIT_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), hi.data_ptr(), lo.data_ptr(), R, C, shape[1], int(transpose),
                 _stream(x.device))
    if err != 0:
        raise RuntimeError(f"tf32x3_split launch failed: CUDA error {err}")
    _split_cuda.launches += 1
    return hi, lo


_split_cuda.launches = 0


def prepare_operands(hidden, head, for_dh: bool = False, for_dw: bool = False):
    """The 3xTF32 kernels' operands, made once per call: hidden hi/lo [N, D]
    and head^T hi/lo [V, D]; for dH also head hi/lo [D, V], for dW hidden^T
    hi/lo [D, N], each with its row stride padded to ``_TMA_ALIGN`` floats."""
    ops = {"hid": _split_cuda(hidden), "head_t": _split_cuda(head, transpose=True)}
    if for_dh:
        ops["head"] = _split_cuda(head, ld=tma_ld(head.shape[1]))
    if for_dw:
        ops["hid_t"] = _split_cuda(hidden, transpose=True, ld=tma_ld(hidden.shape[0]))
    return ops


def fused_logprob_fwd_cuda(hidden, head, targets, temperature: float = 1.0):
    """Launch ``csrc/fused_logprob_fwd.cu``; returns (logprob [N], lse [N])."""
    N, D, V = _check_operands(hidden, head, "fused_logprob_fwd_cuda")
    dev = hidden.device
    t32 = _row_vector("targets", targets, N, torch.int32, dev)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    lse = torch.empty((N,), dtype=torch.float32, device=dev)
    if N == 0:
        return out, lse
    ops = prepare_operands(hidden, head)
    # one partial (max, sum-exp, chosen) per row and vocab tile
    scratch = torch.empty((3, -(-V // _COLS_PER_TILE), N), dtype=torch.float32, device=dev)
    fn = _bind("fused_logprob_fwd", "fused_logprob_fwd", _FWD_ARGTYPES)
    with torch.cuda.device(dev):
        err = fn(*(t.data_ptr() for t in (*ops["hid"], *ops["head_t"], t32, out, lse, scratch)),
                 N, D, V, 1.0 / temperature, _stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_logprob_fwd launch failed: CUDA error {err}")
    fused_logprob_fwd_cuda.launches += 1
    return out, lse


fused_logprob_fwd_cuda.launches = 0
fused_logprob_fwd_cuda.kernel_name = "fused_logprob_fwd"
fused_logprob_fwd_cuda.source = "fused_logprob_fwd"


def _bwd_inputs(name, hidden, head, targets, lse, g):
    N, D, V = _check_operands(hidden, head, name)
    dev = hidden.device
    rows = (_row_vector("targets", targets, N, torch.int32, dev),
            _row_vector("lse", lse, N, torch.float32, dev),
            _row_vector("g", g, N, torch.float32, dev))
    return (N, D, V), rows


def _bwd_cuda(wrapper, wrt_head: bool, hidden, head, targets, lse, g, temperature):
    """Launch the kernel of one backward wrapper (``csrc/fused_logprob_bwd.cu``):
    dW [D, V] when ``wrt_head``, else dH [N, D], f32 in 3xTF32. The
    coefficient is staged one vocab chunk at a time (``_BWD_CHUNK``), split
    into hi/lo, as [N, chunk] for dH and transposed, [chunk, ld ≥ N], for dW."""
    fn_name = wrapper.kernel_name
    (N, D, V), (t32, lse, g) = _bwd_inputs(fn_name + "_cuda", hidden, head, targets, lse, g)
    dev = hidden.device
    out_shape = head.shape if wrt_head else hidden.shape
    if N == 0:
        return torch.zeros(out_shape, dtype=torch.float32, device=dev)
    ops = prepare_operands(hidden, head, for_dh=not wrt_head, for_dw=wrt_head)
    third = ops["hid_t"] if wrt_head else ops["head"]
    ld = third[0].shape[1]
    chunk = min(_BWD_CHUNK, -(-V // _COLS_PER_TILE) * _COLS_PER_TILE)
    out = torch.empty(out_shape, dtype=torch.float32, device=dev)
    coef = torch.empty((2, chunk, ld) if wrt_head else (2, N, chunk), dtype=torch.float32,
                       device=dev)
    fn = _bind("fused_logprob_bwd", fn_name, _BWD_ARGTYPES)
    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    with torch.cuda.device(dev):
        err = fn(*ptr(*ops["hid"], *ops["head_t"], *third), ld,
                 *ptr(t32, lse, g, out, coef[0], coef[1]), N, D, V, chunk, 1.0 / temperature,
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    wrapper.launches += 1
    return out


def fused_logprob_dh_cuda(hidden, head, targets, lse, g, temperature: float = 1.0):
    """dH [N, D] = coef headᵀ / T on the card (``csrc/fused_logprob_bwd.cu``)."""
    return _bwd_cuda(fused_logprob_dh_cuda, False, hidden, head, targets, lse, g, temperature)


fused_logprob_dh_cuda.launches = 0
fused_logprob_dh_cuda.kernel_name = "fused_logprob_dh"
fused_logprob_dh_cuda.source = "fused_logprob_bwd"


def fused_logprob_dw_cuda(hidden, head, targets, lse, g, temperature: float = 1.0):
    """dW [D, V] = hiddenᵀ coef / T on the card (``csrc/fused_logprob_bwd.cu``)."""
    return _bwd_cuda(fused_logprob_dw_cuda, True, hidden, head, targets, lse, g, temperature)


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
