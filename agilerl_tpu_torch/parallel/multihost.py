"""Several hosts: the port of ``agilerl_tpu/parallel/multihost.py``.

The JAX package joins hosts with one ``jax.distributed.initialize`` call;
here that is ``torch.distributed.init_process_group`` over
``tcp://<coordinator>``. The patterns the JAX module keeps from the
reference stay:

- rank 0 decides and every rank replays the same seeded RNG
  (``broadcast_seed`` once, then identical tournaments everywhere);
- ``barrier()`` for wait-for-everyone;
- metric means over hosts through ``utils.utils.aggregate_metrics_across_hosts``.

**Backend rule.** gloo wherever ranks share a card or run on the CPU:
NCCL takes one rank per card, so two ranks on one card (and every CPU
rank) use gloo, and ``parallel/comm.py`` stages card tensors through host
buffers on a gloo group. NCCL only where each rank has a card of its own.

A lost participant shows in two ways: a collective that stops completing
(bounded by ``call_with_collective_timeout``'s watchdog: gloo's own timeout
is 30 minutes by default), or gloo's immediate ``RuntimeError`` when the
peer's process died and closed its sockets. Both count under
``resilience/collective_timeouts_total`` and raise
:class:`~agilerl_tpu_torch.resilience.membership.MembershipChange`.
"""

from __future__ import annotations

import datetime
import os
import threading
from typing import Callable, Optional, TypeVar

import torch
import torch.distributed as dist

from agilerl_tpu_torch.utils.rng import global_seed

T = TypeVar("T")

# how gloo words a peer whose process ended (its sockets closed or reset)
# and its own timeout
_PEER_LOSS_WORDS = ("closed by peer", "reset by peer", "broken pipe", "connection refused",
                    "timed out", "timeout")


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str = "gloo",
    timeout: float = 300.0,
) -> None:
    """Join the process group (nothing if one exists). With
    ``coordinator_address`` (``host:port``) the caller describes a concrete
    cluster, and failing to join it within ``timeout`` seconds raises. With
    no arguments the launcher's environment (``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``) is used when it is set; without it the
    process stays single-process. ``backend``: see the module's rule."""
    if dist.is_initialized():
        return
    wait = datetime.timedelta(seconds=float(timeout))
    if coordinator_address is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return  # single process: nothing to join
        dist.init_process_group(backend, init_method="env://", timeout=wait)
        return
    if num_processes is None or process_id is None:
        raise ValueError("an explicit coordinator_address needs num_processes and process_id")
    host, sep, port = str(coordinator_address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator_address {coordinator_address!r} is not host:port")
    dist.init_process_group(backend, init_method=f"tcp://{host}:{port}",
                            world_size=int(num_processes), rank=int(process_id), timeout=wait)


def broadcast_seed(seed: Optional[int] = None) -> int:
    """Agree on one RNG seed across hosts: rank 0's proposal (``seed``, or
    one drawn from the global numpy stream) is every rank's result. With
    this seed the tournament and mutation decisions are computed identically
    everywhere: no object broadcast per generation."""
    local = seed if seed is not None else global_seed()
    if _world() == 1:
        return int(local)
    dev = "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"
    t = torch.tensor([int(local)], dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    return int(t.item())


def _timeout_registry():
    from agilerl_tpu_torch.observability import get_registry

    return get_registry()


def is_peer_loss(exc: BaseException) -> bool:
    """Whether ``exc`` is how the backend reports a participant that is gone:
    a ``torch.distributed.DistError``, or a ``RuntimeError`` naming a closed,
    reset or refused connection or a timeout (gloo raises these plain)."""
    dist_error = getattr(dist, "DistError", None)
    if dist_error is not None and isinstance(exc, dist_error):
        return True
    text = str(exc).lower()
    return isinstance(exc, RuntimeError) and any(w in text for w in _PEER_LOSS_WORDS)


def _lost(reg, name: str, timeout: Optional[float], why: str, cause=None):
    from agilerl_tpu_torch.resilience.membership import MembershipChange

    reg = reg if reg is not None else _timeout_registry()
    reg.counter("resilience/collective_timeouts_total").inc()
    reg.emit("collective_timeout", name=str(name),
             timeout_s=None if timeout is None else float(timeout))
    return MembershipChange(f"collective {name!r} {why} — a participant host is likely gone; "
                            "recover via snapshot-resume" + (f" ({cause})" if cause else ""))


def call_with_collective_timeout(
    fn: Callable[[], T],
    timeout: Optional[float],
    name: str = "collective",
    registry=None,
) -> T:
    """Run a host-side dispatch that contains cross-host collectives (a
    barrier, the population fitness all-gather) under a bounded timeout.

    With ``timeout=None`` this is a plain call. Otherwise ``fn`` runs in a
    daemon thread; if it does not complete in ``timeout`` seconds the
    ``resilience/collective_timeouts_total`` counter is bumped, a
    ``collective_timeout`` event is emitted and a
    :class:`~agilerl_tpu_torch.resilience.membership.MembershipChange` is
    raised: a lost host is a detectable event instead of a hung all-gather.
    The hung thread cannot be cancelled (a collective is not interruptible);
    it is left behind, and the caller recovers through snapshot-resume and a
    new process group. Either way, an error by which the backend reports a
    lost peer (``is_peer_loss``) is counted and raised the same way."""
    if timeout is None:
        try:
            return fn()
        except RuntimeError as e:
            if is_peer_loss(e):
                raise _lost(registry, name, None, "failed", e) from e
            raise
    result: list = []
    error: list = []

    def target():
        try:
            result.append(fn())
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller
            error.append(e)

    t = threading.Thread(target=target, daemon=True, name=f"collective-{name}")
    t.start()
    t.join(float(timeout))
    if t.is_alive():
        raise _lost(registry, name, timeout, f"timed out after {timeout}s")
    if error:
        if is_peer_loss(error[0]):
            raise _lost(registry, name, timeout, "failed", error[0]) from error[0]
        raise error[0]
    return result[0]


def barrier(name: str = "barrier", timeout: Optional[float] = None) -> None:
    """Cross-host sync point (the reference's ``wait_for_everyone``).
    ``timeout`` (seconds) bounds the wait: instead of hanging on a host that
    is gone, the barrier raises ``MembershipChange`` and counts
    ``resilience/collective_timeouts_total``."""
    if _world() == 1:
        return
    call_with_collective_timeout(dist.barrier, timeout, name=f"barrier:{name}")
