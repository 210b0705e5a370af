"""The collectives the port runs by hand over a mesh axis's process group:
a ring shift (``lax.ppermute`` by one place, with its transpose as the
backward), a tiled all-gather, and an in-place sum; and the differentiable
pairs a staged program needs where every rank computes the same loss
(``sum_to_all``: sum forward, gradient as it is; ``sum_grads``: identity
forward, summed gradient; ``gather_shards``: all-gather forward,
reduce-scatter backward). ``collective_log`` records what a region sends.

A gloo group moves host tensors, so a card tensor on a gloo group is staged
through a host buffer (two ranks on one card share it over gloo: NCCL takes
one rank per card); an NCCL group moves card tensors. The group's backend
decides, and ``staged_bytes`` counts what went through the host.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

#: bytes staged through host buffers by the helpers here (sent + received)
staged_bytes = 0
#: where ``all_gather_cat`` records its calls inside a ``collective_log``
_gather_log: Optional[list] = None


def group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def group_rank(group) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def _staged(group, t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend(group) == dist.Backend.GLOO


def _to_wire(group, t: torch.Tensor) -> torch.Tensor:
    t = t.detach().contiguous()
    return t.cpu() if _staged(group, t) else t


def shift(tensors: Sequence[torch.Tensor], group, offset: int = 1) -> List[torch.Tensor]:
    """Send every tensor to rank ``(r + offset) % P`` of ``group`` and return
    the ones received from ``(r - offset) % P``, in one
    ``batch_isend_irecv`` (no pair of ranks waits on the other)."""
    global staged_bytes
    P = group_size(group)
    if P == 1:
        return [t for t in tensors]
    r = group_rank(group)
    dst = dist.get_global_rank(group, (r + offset) % P)
    src = dist.get_global_rank(group, (r - offset) % P)
    sends = [_to_wire(group, t) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    ops = [dist.P2POp(dist.isend, s, dst, group) for s in sends]
    ops += [dist.P2POp(dist.irecv, b, src, group) for b in recvs]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    out = []
    for t, b in zip(tensors, recvs):
        if b.device != t.device:
            staged_bytes += 2 * b.numel() * b.element_size()
            b = b.to(t.device)
        out.append(b)
    return out


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    global staged_bytes
    P = group_size(group)
    if P == 1:
        return t
    if _gather_log is not None:
        _gather_log.append(("comm.all_gather_cat", tuple(t.shape)))
    w = _to_wire(group, t)
    parts = [torch.empty_like(w) for _ in range(P)]
    dist.all_gather(parts, w, group=group)
    out = torch.cat(parts, dim=dim)
    if out.device != t.device:
        staged_bytes += (P + 1) * w.numel() * w.element_size()
        out = out.to(t.device)
    return out


class collective_log:
    """``with collective_log() as log``: ``log`` lists ``(op, input shape)``
    for every collective run inside the block, DTensor's functional
    collectives (seen by a ``TorchDispatchMode``) and ``all_gather_cat``:
    what a path sends, e.g. that a decode step gathers no weight."""

    def __enter__(self) -> list:
        from torch.utils._python_dispatch import TorchDispatchMode

        global _gather_log
        log: list = []

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace in ("_c10d_functional", "c10d") and args \
                        and isinstance(args[0], torch.Tensor):
                    log.append((str(func), tuple(args[0].shape)))
                return func(*args, **(kwargs or {}))

        self._outer, _gather_log = _gather_log, log
        self._mode = _Mode()
        self._mode.__enter__()
        return log

    def __exit__(self, *exc) -> bool:
        global _gather_log
        self._mode.__exit__(*exc)
        _gather_log = self._outer
        return False


def all_reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place; returns ``t``."""
    global staged_bytes
    if group_size(group) == 1:
        return t
    if _staged(group, t):
        host = t.detach().cpu()
        dist.all_reduce(host, group=group)
        staged_bytes += 2 * host.numel() * host.element_size()
        t.copy_(host)
    else:
        dist.all_reduce(t, group=group)
    return t


class _Shift(torch.autograd.Function):
    """``shift`` of one differentiable tensor plus riders without gradient;
    the backward shifts the gradient back the other way."""

    @staticmethod
    def forward(ctx, x, group, offset, *riders):
        ctx.group, ctx.offset = group, offset
        out = shift((x,) + tuple(r for r in riders if r is not None), group, offset)
        it = iter(out[1:])
        riders_out = tuple(next(it) if r is not None else None for r in riders)
        ctx.mark_non_differentiable(*(r for r in riders_out if r is not None))
        return (out[0],) + riders_out

    @staticmethod
    def backward(ctx, g, *riders):
        # grads are materialised (zeros for an unused output), so every rank
        # sends and receives here
        (back,) = shift((g,), ctx.group, -ctx.offset)
        return (back, None, None) + (None,) * len(riders)


def ring_shift(x: torch.Tensor, group, offset: int = 1,
               riders: Sequence[Optional[torch.Tensor]] = ()):
    """Differentiable ``shift``: ``(x', *riders')``. A caller that needs the
    same backward on every rank keeps every shifted ``x'`` in its graph."""
    return _Shift.apply(x, group, offset, *riders)


class _GatherCat(torch.autograd.Function):
    """All-gather along ``dim`` for a loss that every rank computes alike:
    the backward keeps this rank's slice of the (identical) gradient. With
    ``size``, the ranks hold ``torch.chunk``'s pieces of a dim of that size
    (DTensor's ``Shard``: ceil(size / P) each, the last ones shorter or
    empty); each is padded to the chunk for the gather."""

    @staticmethod
    def forward(ctx, x, group, dim, size=None):
        n = x.shape[dim]
        chunk = n if size is None else -(-size // group_size(group))
        ctx.group, ctx.dim, ctx.n = group, dim, n
        ctx.at = group_rank(group) * chunk if size is None else min(
            group_rank(group) * chunk, size)
        if n < chunk:
            pad = list(x.shape)
            pad[dim] = chunk - n
            x = torch.cat([x, x.new_zeros(pad)], dim=dim)
        out = all_gather_cat(x, group, dim)
        return out if size is None else out.narrow(dim, 0, size)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.at, ctx.n), None, None, None


class _SumToAll(torch.autograd.Function):
    """All-reduce sum whose every rank then computes the same loss from the
    sum: the gradient of each rank's part is the gradient of the sum, so the
    backward passes it through (summing it again would count the loss once
    per rank)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum_(x.detach().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    """Identity for a replicated input of which each rank uses a part (or
    none): the backward sums the ranks' gradients, so every rank holds the
    whole gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.contiguous().clone(), ctx.group), None


class _GatherShards(torch.autograd.Function):
    """All-gather of a weight sharded along ``dim`` that ranks use on rows
    of their own: the backward sums the ranks' gradients and keeps this
    rank's slice (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        summed = all_reduce_sum_(g.contiguous().clone(), ctx.group)
        r = group_rank(ctx.group)
        return summed.narrow(ctx.dim, r * ctx.n, ctx.n), None, None


def sum_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce sum for a loss that every rank computes
    alike from the result (backward: the gradient as it is)."""
    return x if group_size(group) == 1 else _SumToAll.apply(x, group)


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward sums the gradient over the group."""
    return x if group_size(group) == 1 else _SumGrads.apply(x, group)


def gather_shards(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim`` whose backward is a reduce-scatter: for a
    sharded weight used on each rank's own rows."""
    return x if group_size(group) == 1 else _GatherShards.apply(x, group, dim)


def gather_dtensor(x, keep: Sequence[str] = ()):
    """A DTensor with its pending sums all-reduced (DTensor's functional
    all-reduce) and its shards gathered over every mesh dim not named in
    ``keep`` (their placements stay), innermost first, through
    :func:`gather_replicated_loss`: plain c10d all-gathers, whose backward
    keeps each rank's slice of the gradient that DTensor has summed into
    the replicated placement. DTensor's own functional all-gather is never
    called: it crashes on a gloo group of card tensors (torch 2.11)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
    pl = list(x.placements)
    todo = [md for md, p in enumerate(pl) if p.is_shard() and mesh.mesh_dim_names[md] not in keep]
    if not todo:
        return x
    t = x.to_local()
    for md in reversed(todo):
        dim = pl[md].dim
        alone = sum(p.is_shard(dim) for p in pl) == 1
        t = gather_replicated_loss(t, mesh.get_group(md), dim, x.shape[dim] if alone else None)
        pl[md] = Replicate()
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=x.shape, stride=x.stride())


def gather_replicated_loss(x: torch.Tensor, group, dim: int,
                           size: Optional[int] = None) -> torch.Tensor:
    """``all_gather_cat`` whose gradient is this rank's slice only: every
    rank then holds its own part of the gradient, and the parameters'
    gradients are summed over the group after the backward (or, under a
    DTensor made from the result, by DTensor as it turns the gradient
    into the replicated placement). ``size``: the whole dim, when the ranks
    hold ``torch.chunk``'s (possibly uneven) pieces of it."""
    if group_size(group) == 1:
        return x
    return _GatherCat.apply(x, group, dim, size)
