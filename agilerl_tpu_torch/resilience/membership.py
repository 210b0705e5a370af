"""Heartbeat/lease membership: the port of
``agilerl_tpu/resilience/membership.py`` (whole).

On spot/preemptible capacity, hosts *will* disappear mid-run — and a
vanished host must surface as a **bounded, detectable event**, never as a
fitness all-gather that hangs forever (the Podracer deployment problem,
Hessel et al. 2021). The serving fleet (``llm/fleet.py``) detects lost
replicas with it:

- every live host periodically writes a **lease file** into a directory on
  a shared store (no extra coordination service is needed);
- a host whose lease goes stale past ``lease_timeout`` — or that wrote a
  tombstone on graceful shutdown — drops out of the live set;
- :meth:`HeartbeatStore.poll` diffs the live set against the last
  observation and reports a :class:`MembershipEvent` (lost/joined hosts +
  the new leader) while feeding the ``resilience/*`` membership counters;
- the **leader** is simply the lowest live host id (deterministic on every
  observer, no election protocol): leader-only duties are snapshot commits
  and island exports, so a split-brain during a lease-expiry window can at
  worst produce an extra atomic snapshot, never a torn one.

Lease writes deliberately do NOT go through the atomic/fault-hook layer:
leases are ephemeral liveness signals, not durability-critical state — an
fsync per heartbeat would hammer the shared store, and routing beats through
the fault hook would make a fault injector's scheduled op indices
timing-dependent. A torn lease read
is treated as a missed beat (the next beat rewrites it).
"""

from __future__ import annotations

import json
import os
import socket
import time
import types
from pathlib import Path
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union


def _registry():
    from agilerl_tpu_torch.observability import get_registry

    return get_registry()


def pid_alive(pid: int) -> bool:
    """Cheap same-host liveness probe: does ``pid`` still exist?

    ``os.kill(pid, 0)`` performs permission checks but delivers nothing.
    ``PermissionError`` means the pid exists but belongs to another user —
    alive for our purposes. A zombie (exited, unreaped) still probes alive;
    the process supervisor reaps its children promptly, so that window is
    the supervisor's poll interval, not the lease window.
    """
    if pid is None or int(pid) <= 0:
        return False
    try:
        os.kill(int(pid), 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except OSError:
        return False
    return True


class MembershipChange(RuntimeError):
    """The live host set changed (lease expiry, tombstone, or a collective
    that timed out because a participant vanished).

    Raised by :meth:`HeartbeatStore.wait_for` on a join deadline; an
    elastic controller catches it and routes recovery through
    snapshot-resume."""

    def __init__(
        self,
        message: str,
        lost: Sequence[int] = (),
        joined: Sequence[int] = (),
        alive: Sequence[int] = (),
    ):
        super().__init__(message)
        self.lost: Tuple[int, ...] = tuple(int(h) for h in lost)
        self.joined: Tuple[int, ...] = tuple(int(h) for h in joined)
        self.alive: Tuple[int, ...] = tuple(int(h) for h in alive)


class MembershipEvent(NamedTuple):
    """One observed change of the live host set.

    ``meta`` carries lease payload metadata (the small JSON dict passed to
    :meth:`HeartbeatStore.beat` — e.g. ``{"role": "decode", "replica": 3}``
    for a serving-fleet member) for every ALIVE and every LOST host — a
    lost host's last (stale) lease is still readable, so observers can
    tell a lost decode replica from a lost prefill worker. Hosts whose
    lease is torn/unreadable map to ``{}``. The no-meta default is an
    immutable empty mapping (a shared plain-dict default would let one
    consumer's in-place annotation leak into every other default-
    constructed event)."""

    alive: Tuple[int, ...]
    lost: Tuple[int, ...]
    joined: Tuple[int, ...]
    leader: Optional[int]
    meta: Mapping[int, dict] = types.MappingProxyType({})


class HeartbeatStore:
    """Filesystem lease files as the membership substrate.

    Layout: ``<directory>/host_<id>.json`` holding ``{"host", "time",
    "incarnation"}`` (or ``{"dead": true}`` as a graceful tombstone). Time
    comes from the injectable ``clock`` (default ``time.time`` — leases are
    compared across processes, so a wall clock is required; tests inject a
    fake one).

    ``incarnation`` distinguishes a host that died and came back from one
    that never left: a rejoin after an observed loss is reported as
    ``joined`` even if the id is the same.

    **Fast same-host failure detection** (``probe_pids``, default on): every
    beat records the writer's pid and node name, and :meth:`alive` probes
    the pid of any lease written from *this* node via :func:`pid_alive`. A
    crashed local process therefore drops out of the live set on the very
    next observation instead of after ``lease_timeout`` — the MTTR path the
    single-machine process launcher rides. Leases from other nodes (or
    pre-probe leases without a pid) still age out by lease timeout only.
    """

    def __init__(
        self,
        directory: Union[str, Path],
        lease_timeout: float = 5.0,
        registry=None,
        clock=time.time,
        probe_pids: bool = True,
    ):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.lease_timeout = float(lease_timeout)
        self._registry_override = registry
        self.clock = clock
        self.probe_pids = bool(probe_pids)
        self.node = socket.gethostname()
        #: last observed view: host id -> incarnation (None until baselined)
        self._last_view: Optional[Dict[int, int]] = None

    @property
    def registry(self):
        return self._registry_override if self._registry_override is not None \
            else _registry()

    # -- lease I/O --------------------------------------------------------- #
    def _lease_path(self, host_id: int) -> Path:
        return self.directory / f"host_{int(host_id):04d}.json"

    def _write(self, host_id: int, payload: dict) -> None:
        # plain tmp+rename (no fsync, no fault hook): liveness signal, not
        # durable state — see module docstring
        path = self._lease_path(host_id)
        tmp = path.with_name(path.name + f".{os.getpid()}.beat")
        # leases are liveness, not durability: atomic.py's fsync+fault-hook
        # path would skew FaultInjector op indices and add an fsync per
        # heartbeat; a torn lease reads as a missed beat, which is the
        # correct failure semantics here
        tmp.write_bytes(json.dumps(payload).encode())  # graftcheck: disable=GX004
        os.replace(tmp, path)  # graftcheck: disable=GX004 — see above

    def beat(
        self,
        host_id: int,
        incarnation: int = 0,
        meta: Optional[dict] = None,
        pid: Optional[int] = None,
        node: Optional[str] = None,
    ) -> None:
        """Renew ``host_id``'s lease (call once per generation/heartbeat
        interval; must beat faster than ``lease_timeout`` to stay live).
        ``meta`` is a small JSON payload recorded in the lease — the serving
        fleet writes ``{"role": "prefill"|"decode"|"unified", "replica": id}``
        so :meth:`poll`/:meth:`roles` surface the topology, not just
        liveness. ``pid``/``node`` default to the writing process and this
        node; tests override them to fabricate a crashed-process lease."""
        payload = {
            "host": int(host_id),
            "time": float(self.clock()),
            "incarnation": int(incarnation),
            "pid": int(os.getpid() if pid is None else pid),
            "node": self.node if node is None else str(node),
        }
        if meta:
            payload["meta"] = meta
        self._write(host_id, payload)

    def mark_dead(self, host_id: int) -> None:
        """Graceful tombstone: the host drops out of the live set immediately
        instead of after a lease timeout (SIGTERM/shutdown path)."""
        self._write(host_id, {"host": int(host_id), "dead": True,
                              "time": float(self.clock())})

    # -- observation ------------------------------------------------------- #
    def leases(self) -> Dict[int, dict]:
        """All readable, non-tombstoned lease payloads (fresh or stale)."""
        out: Dict[int, dict] = {}
        for p in sorted(self.directory.glob("host_*.json")):
            try:
                payload = json.loads(p.read_text())
            except (OSError, ValueError):
                continue  # torn/concurrent lease write == missed beat
            if payload.get("dead"):
                continue
            try:
                out[int(payload["host"])] = payload
            except (KeyError, TypeError, ValueError):
                continue
        return out

    def _probed_dead(self, payload: dict) -> bool:
        """True when a lease was written by a process on THIS node whose pid
        no longer exists — a crashed local process whose lease is still
        fresh. Cross-node leases (or pre-probe leases without a pid) are
        never probed; they age out by lease timeout only."""
        if not self.probe_pids:
            return False
        pid = payload.get("pid")
        if pid is None or payload.get("node") != self.node:
            return False
        try:
            return not pid_alive(int(pid))
        except (TypeError, ValueError):
            return False

    def alive(self, now: Optional[float] = None) -> Dict[int, dict]:
        """Hosts with a fresh lease (age ≤ ``lease_timeout``) whose writer —
        when it lives on this node and the probe is enabled — still exists.
        The pid probe turns a same-host crash into an immediate loss instead
        of a lease-window wait."""
        now = float(self.clock()) if now is None else float(now)
        return {
            h: payload for h, payload in self.leases().items()
            if now - float(payload.get("time", -float("inf"))) <= self.lease_timeout
            and not self._probed_dead(payload)
        }

    def leader(self, alive: Optional[Dict[int, dict]] = None) -> Optional[int]:
        """Lowest live host id — deterministic on every observer."""
        a = self.alive() if alive is None else alive
        return min(a) if a else None

    def roles(self, alive: Optional[Dict[int, dict]] = None) -> Dict[int, Optional[str]]:
        """Role recorded in each live host's lease metadata (None when a
        host beats without one) — the serving fleet's prefill/decode/unified
        topology readout."""
        a = self.alive() if alive is None else alive
        return {int(h): (p.get("meta") or {}).get("role")
                for h, p in a.items()}

    def expect(self, host_ids: Sequence[int]) -> None:
        """Baseline the observed set explicitly (e.g. right after the join
        barrier) so the first :meth:`poll` diffs against the real roster
        rather than treating everyone as newly joined. Incarnations come
        from the hosts' current leases (0 when a host has not beat yet)."""
        leases = self.leases()
        self._last_view = {
            int(h): int(leases.get(int(h), {}).get("incarnation", 0))
            for h in host_ids
        }

    def poll(self) -> Optional[MembershipEvent]:
        """Diff the live view against the last observation. Returns ``None``
        when nothing changed (the first poll baselines and reports nothing);
        otherwise records membership metrics, emits a ``membership`` event
        and returns the :class:`MembershipEvent`. A host whose lease carries
        a NEW incarnation — it died and rejoined inside one lease window —
        is reported in both ``lost`` and ``joined``. Lease metadata (role,
        replica id — whatever :meth:`beat` was given) rides on the event's
        ``meta`` for alive AND lost hosts (a lost host's stale lease is
        still readable) so fleet observers can tell a lost decode replica
        from a lost prefill worker."""
        live = self.alive()
        view = {h: int(p.get("incarnation", 0)) for h, p in live.items()}
        if self._last_view is None:
            self._last_view = view
            return None
        if view == self._last_view:
            return None
        lost = tuple(sorted(
            h for h, inc in self._last_view.items() if view.get(h) != inc
        ))
        joined = tuple(sorted(
            h for h, inc in view.items() if self._last_view.get(h) != inc
        ))
        alive = tuple(sorted(view))
        self._last_view = view
        leader = min(alive) if alive else None
        # lost hosts' STALE leases are still readable — their meta rides on
        # the event too, so observers can classify WHAT was lost (a torn or
        # tombstoned lease degrades to {})
        stale = self.leases()
        meta = {int(h): dict(live[h].get("meta") or {}) for h in alive}
        meta.update({
            int(h): dict(stale.get(int(h), {}).get("meta") or {})
            for h in lost
        })
        reg = self.registry
        reg.counter("resilience/membership_changes_total").inc()
        if lost:
            reg.counter("resilience/hosts_lost_total").inc(len(lost))
        if joined:
            reg.counter("resilience/hosts_joined_total").inc(len(joined))
        reg.emit(
            "membership",
            alive=[int(h) for h in alive],
            lost=[int(h) for h in lost],
            joined=[int(h) for h in joined],
            leader=leader,
            roles={int(h): m.get("role") for h, m in meta.items()
                   if m.get("role") is not None},
        )
        return MembershipEvent(alive, lost, joined, leader, meta)

    def wait_for(
        self,
        n_hosts: int,
        timeout: float = 30.0,
        interval: float = 0.05,
        beat_as: Optional[Tuple[int, int]] = None,
    ) -> Dict[int, dict]:
        """Join barrier: block until ``n_hosts`` leases are live (optionally
        renewing our own lease as ``(host_id, incarnation)`` while waiting).
        Raises :class:`MembershipChange` on deadline — a bounded startup
        instead of an indefinite wait for capacity that may never come."""
        deadline = time.monotonic() + float(timeout)
        while True:
            if beat_as is not None:
                self.beat(*beat_as)
            a = self.alive()
            if len(a) >= int(n_hosts):
                return a
            if time.monotonic() >= deadline:
                raise MembershipChange(
                    f"membership join timed out after {timeout}s: "
                    f"{len(a)}/{n_hosts} hosts live ({sorted(a)})",
                    alive=sorted(a),
                )
            time.sleep(interval)
