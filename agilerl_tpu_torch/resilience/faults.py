"""Deterministic fault-injection harness: the port of
``agilerl_tpu/resilience/faults.py`` (whole; pure Python), on the port's
``resilience/atomic.set_fault_hook``.

Crash consistency is only real if it is exercised: the :class:`FaultInjector`
attaches to the atomic layer's fault hook (:mod:`agilerl_tpu_torch.resilience.atomic`)
and, at scheduled operation indices, kills the process mid-commit
(:class:`InjectedCrash`) or silently truncates the file just written —
simulating SIGKILL-torn writes and disk corruption in ordinary CPU
tests. :class:`ScheduledFailureEnv` plays the same role for the flaky
host-side env edge, raising scheduled exceptions from ``reset``/``step`` so
the retry policies are testable without a flaky network.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

from agilerl_tpu_torch.resilience.atomic import set_fault_hook


class InjectedCrash(BaseException):
    """Simulated hard kill (SIGKILL analogue).

    Derives from ``BaseException`` deliberately: recovery code written as
    ``except Exception`` must NOT be able to swallow it, exactly as no
    handler can swallow a real SIGKILL. Tests catch it explicitly.
    """


class FaultInjector:
    """Count durability operations and fault at scheduled indices.

    Ops (fired by the atomic layer, in commit order) are:
    ``write`` (before a file write), ``wrote`` (file durably in place) and
    ``commit`` (before a snapshot directory is published). The injector
    counts only ops in ``match`` — e.g. ``match=("wrote",)`` with
    ``kill_at_op=2`` kills the process after the third file of a snapshot
    landed but before the manifest/commit, the canonical torn-snapshot
    scenario.

    - ``kill_at_op``: raise :class:`InjectedCrash` when the matched-op
      counter reaches this index (0-based).
    - ``truncate_at_ops``: at these matched-op indices, truncate the file
      involved to ``truncate_to`` of its size and continue silently —
      simulating corruption that only validation (content hashes) can catch.
    - ``path_match``: when set, only ops whose path contains this substring
      count — the **torn-island-export mode** is
      ``FaultInjector(truncate_at_ops=[0], match=("wrote",),
      path_match="members.pkl")``, which corrupts exactly the first island
      export payload so refusal-safe import (hash validation +
      skip-and-warn) is exercisable in CPU tests.
    - ``kill_host_at``: the **host-loss mode** — a ``{generation: host_id}``
      schedule consumed by the elastic controller at generation boundaries
      via :meth:`host_to_kill`: the named emulated host is killed (stops
      heartbeating, its lease expires) at that boundary, exercising
      membership-change detection and snapshot-restore recovery.

    Use as a context manager (or ``arm()``/``disarm()``); it installs itself
    as the process-wide fault hook and restores the previous hook on exit.
    The counter is deterministic: same save sequence, same ops, same kill
    point.
    """

    def __init__(
        self,
        kill_at_op: Optional[int] = None,
        truncate_at_ops: Iterable[int] = (),
        truncate_to: float = 0.5,
        match: Tuple[str, ...] = ("write", "wrote", "commit"),
        path_match: Optional[str] = None,
        kill_host_at: Optional[Mapping[int, int]] = None,
    ):
        self.kill_at_op = kill_at_op
        self.truncate_at_ops = frozenset(int(i) for i in truncate_at_ops)
        self.truncate_to = float(truncate_to)
        self.match = tuple(match)
        self.path_match = path_match
        self.kill_host_at: Dict[int, int] = {
            int(g): int(h) for g, h in (kill_host_at or {}).items()
        }
        self.hosts_killed: List[Tuple[int, int]] = []  # (generation, host)
        self.op_count = 0
        self.log: List[Tuple[int, str, str]] = []
        self._prev_hook = None
        self._armed = False

    # -- host-loss schedule (consumed by the elastic controller) --------- #
    def host_to_kill(self, generation: int) -> Optional[int]:
        """The host scheduled to die at this generation boundary (once:
        the schedule entry is consumed), else None."""
        host = self.kill_host_at.pop(int(generation), None)
        if host is not None:
            self.hosts_killed.append((int(generation), int(host)))
        return host

    # -- hook ----------------------------------------------------------- #
    def __call__(self, op: str, path: Path) -> None:
        if op not in self.match:
            return
        if self.path_match is not None and self.path_match not in str(path):
            return
        idx = self.op_count
        self.op_count += 1
        self.log.append((idx, op, str(path)))
        if idx in self.truncate_at_ops:
            self._truncate(path)
        if self.kill_at_op is not None and idx >= self.kill_at_op:
            raise InjectedCrash(
                f"injected kill at op {idx} ({op} {path})"
            )

    def _truncate(self, path: Path) -> None:
        if not path.is_file():
            return
        size = path.stat().st_size
        keep = int(size * self.truncate_to)
        with open(path, "rb+") as fh:
            fh.truncate(keep)
            fh.flush()
            os.fsync(fh.fileno())

    # -- lifecycle ------------------------------------------------------- #
    def arm(self) -> "FaultInjector":
        if not self._armed:
            self._prev_hook = set_fault_hook(self)
            self._armed = True
        return self

    def disarm(self) -> None:
        if self._armed:
            set_fault_hook(self._prev_hook)
            self._prev_hook = None
            self._armed = False

    def __enter__(self) -> "FaultInjector":
        return self.arm()

    def __exit__(self, *exc) -> None:
        self.disarm()


class ScheduledFailureEnv:
    """Env proxy that raises scheduled exceptions from ``reset``/``step``.

    ``fail_resets`` / ``fail_steps`` are 0-based call indices that raise
    ``exc_type`` once each; every other call passes through to the wrapped
    env. Deterministic by construction — the retry tests schedule exactly
    which host-side edge flakes and assert the policy recovers.
    """

    def __init__(self, env, fail_resets: Iterable[int] = (),
                 fail_steps: Iterable[int] = (),
                 exc_type=ConnectionError):
        self.env = env
        self._fail_resets = set(int(i) for i in fail_resets)
        self._fail_steps = set(int(i) for i in fail_steps)
        self._exc_type = exc_type
        self.reset_calls = 0
        self.step_calls = 0

    def reset(self, *args, **kwargs):
        idx = self.reset_calls
        self.reset_calls += 1
        if idx in self._fail_resets:
            raise self._exc_type(f"injected env.reset failure (call {idx})")
        return self.env.reset(*args, **kwargs)

    def step(self, *args, **kwargs):
        idx = self.step_calls
        self.step_calls += 1
        if idx in self._fail_steps:
            raise self._exc_type(f"injected env.step failure (call {idx})")
        return self.env.step(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self.env, name)
