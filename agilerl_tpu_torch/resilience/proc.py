"""Process supervision for the multi-process pod launcher: the port of
``agilerl_tpu/resilience/proc.py`` (whole; the same store layout, status
states and ``EXIT_*`` codes, so either package's launcher reads the other's
spec and status files).

Every pod-to-pod interaction of the serving fleet and the GRPO flywheel
already goes through commit-dir stores on one filesystem root. This module
runs each pod as a **real OS process** and supervises it. Three layers:

- **Role harness** (:func:`run_role`): the child-side driver. The child's
  command installs a :class:`~agilerl_tpu_torch.resilience.preemption
  .PreemptionGuard` FIRST, from ``preemption.py`` loaded alone (so even a
  SIGTERM during the seconds-long torch import and CUDA start-up drains
  cleanly), then imports the package, beats a :class:`~agilerl_tpu_torch
  .resilience.membership.HeartbeatStore` lease tagged with the role, resolves
  the spec's ``module:function`` entry point to build the role object, and
  runs the poll-cadence tick loop. Exit is always through a final telemetry
  flush and an atomic status file: ``done`` (tick returned complete),
  ``preempted`` (guard latched, final drain ran) or ``crashed`` (exception,
  traceback recorded). Exit codes mirror the states, so the supervisor never
  parses a status file to decide on a restart.

- :class:`SupervisedProcess`: one spawned role. Children are exec'd (a new
  interpreter, never a fork, so no CUDA context is inherited) in their OWN
  session (``start_new_session=True``), so the launcher signals the child's
  whole process group without ever signalling itself. Termination is
  double-delivered on purpose (group signal + direct signal): the guard's
  latch is idempotent, and a real pod sees exactly that race between an
  external preemption notice and the launcher's forward.

- :class:`ProcessSupervisor`: the fleet of children over one root.
  ``poll()`` reaps exits and restarts crashed roles with a bumped
  incarnation (bounded by ``max_restarts``); ``shutdown()`` drains every
  child through SIGTERM within a grace window, escalates to SIGKILL, and
  verifies that nothing is left running (the no-orphans contract).

Nothing here touches pod payloads: weights, trajectories, KV pages and
telemetry keep flowing through the existing stores. The supervisor moves
only signals, liveness and exit status. Each status file also records
whether ``jax`` was ever imported in the child (``jax_loaded``) and which of
``torch`` / ``agilerl_tpu_torch`` were loaded when the guard went in
(``loaded_at_guard``).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from agilerl_tpu_torch.resilience.atomic import atomic_write_bytes
from agilerl_tpu_torch.resilience.membership import HeartbeatStore, pid_alive
from agilerl_tpu_torch.resilience.preemption import PreemptionGuard

#: harness exit codes: the supervisor's restart policy keys off these
EXIT_DONE = 0        #: role tick loop reported completion
EXIT_CRASH = 1       #: unhandled exception (restartable)
EXIT_PREEMPTED = 3   #: guard latched; drained gracefully (NOT restartable)
EXIT_ESCALATED = 130  #: double ^C: immediate stop, no drain

#: root-relative layout the launcher and every role agree on
SPECS_DIR = "specs"
STATUS_DIR = "status"
LOGS_DIR = "logs"
MEMBERSHIP_DIR = "membership"
TELEMETRY_DIR = "telemetry"

#: modules whose presence at guard time the status records
_HEAVY = ("torch", "agilerl_tpu_torch")


@dataclasses.dataclass
class RoleSpec:
    """Everything a child process needs to run one role, JSON-round-trip
    (the spec file IS the process's argv). ``target`` is a
    ``module:function`` entry point called with the :class:`RoleContext`; it
    returns either an object with ``tick()`` (optional ``drain()``) or a bare
    zero-arg tick callable. ``kwargs`` must be JSON-able: object graphs are
    rebuilt child-side from entry points, never pickled across the exec."""

    name: str
    target: str
    root: str
    member_id: int
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    replica: int = 0
    incarnation: int = 0
    lease_timeout: float = 5.0
    beat_interval: Optional[float] = None  # default: lease_timeout / 4
    poll_interval: float = 0.0
    env: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RoleSpec":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})


class RoleContext:
    """The harness-side plumbing handed to a role's entry point: the spec,
    the shared root, the lease store (already beating), the preemption guard
    and the process registry. Roles read ``should_stop`` at their own step
    boundaries when one tick spans several store interactions."""

    def __init__(self, spec: RoleSpec, root: Path, heartbeat: HeartbeatStore,
                 guard: PreemptionGuard, metrics) -> None:
        self.spec = spec
        self.root = root
        self.heartbeat = heartbeat
        self.guard = guard
        self.metrics = metrics

    @property
    def should_stop(self) -> bool:
        return self.guard.requested


def resolve_target(target: str):
    """``module:function`` -> the callable (no eval, no pickling)."""
    mod, sep, fn = target.partition(":")
    if not sep or not mod or not fn:
        raise ValueError(f"role target must be 'module:function', got {target!r}")
    return getattr(importlib.import_module(mod), fn)


def _status_path(root: Path, name: str) -> Path:
    return root / STATUS_DIR / f"{name}.json"


def _write_status(root: Path, spec: RoleSpec, state: str, ticks: int = 0,
                  error: Optional[str] = None, loaded_at_guard=()) -> None:
    payload = {
        "role": spec.name,
        "pid": os.getpid(),
        "incarnation": int(spec.incarnation),
        "state": state,
        "ticks": int(ticks),
        "time": time.time(),
        "jax_loaded": "jax" in sys.modules,
        "loaded_at_guard": list(loaded_at_guard),
    }
    if error:
        payload["error"] = error
    atomic_write_bytes(_status_path(root, spec.name), json.dumps(payload, indent=2).encode())


def read_statuses(root: Union[str, Path]) -> Dict[str, Dict[str, Any]]:
    """All readable role status files under ``root`` (atomic writes mean an
    unreadable one is external damage, not a crash artifact)."""
    out: Dict[str, Dict[str, Any]] = {}
    status_dir = Path(root) / STATUS_DIR
    if not status_dir.is_dir():
        return out
    for p in sorted(status_dir.glob("*.json")):
        try:
            out[p.stem] = json.loads(p.read_text())
        except (OSError, ValueError):
            continue
    return out


def run_role(spec_path: Union[str, Path], guard: Optional[PreemptionGuard] = None,
             loaded_at_guard=()) -> int:
    """Child-side harness: guard -> lease -> build role -> tick loop ->
    drain -> status. Returns the process exit code (see ``EXIT_*``).

    ``guard`` is the one the child's command installed before importing
    torch or this package (``loaded_at_guard`` names what was loaded then);
    without one (an in-process call) a guard is installed here. Any
    loop-level guard a role installs later chains back to it."""
    spec = RoleSpec.from_json(Path(spec_path).read_text())
    root = Path(spec.root)
    if guard is None:
        loaded_at_guard = [m for m in _HEAVY if m in sys.modules]
        guard = PreemptionGuard().install()

    from agilerl_tpu_torch import observability

    reg = observability.get_registry()
    sink_path = root / LOGS_DIR / f"{spec.name}.events.jsonl"
    sink_path.parent.mkdir(parents=True, exist_ok=True)
    reg.attach_sink(observability.JsonlSink(str(sink_path)))
    guard._registry = reg  # the deferred preemption record lands in OUR sink

    heartbeat = HeartbeatStore(root / MEMBERSHIP_DIR, lease_timeout=spec.lease_timeout,
                               registry=reg)
    meta = {"role": spec.name, "replica": int(spec.replica)}
    heartbeat.beat(spec.member_id, spec.incarnation, meta=meta)
    _write_status(root, spec, "running", loaded_at_guard=loaded_at_guard)

    publisher = observability.TelemetryPublisher(
        root / TELEMETRY_DIR, spec.name, reg,
        interval_s=max(spec.lease_timeout / 2.0, 0.25), metrics=reg)

    beat_interval = (spec.beat_interval if spec.beat_interval is not None
                     else spec.lease_timeout / 4.0)
    ctx = RoleContext(spec, root, heartbeat, guard, reg)
    ticks = 0
    state, code, error = "done", EXIT_DONE, None
    try:
        role = resolve_target(spec.target)(ctx)
        tick = role if callable(role) and not hasattr(role, "tick") else role.tick
        drain = getattr(role, "drain", None)
        last_beat = time.monotonic()
        while True:
            if guard.requested:
                state, code = "preempted", EXIT_PREEMPTED
                break
            done = tick()
            ticks += 1
            now = time.monotonic()
            if now - last_beat >= beat_interval:
                heartbeat.beat(spec.member_id, spec.incarnation, meta=meta)
                last_beat = now
            publisher.publish()  # self-throttled by interval_s
            if done:
                break
            if spec.poll_interval > 0:
                time.sleep(spec.poll_interval)
        # graceful paths drain: the role's final snapshot / flush hook runs
        # for completion AND preemption (the guard's grace window)
        if callable(drain):
            drain()
    except KeyboardInterrupt:
        # double ^C escalation: the user means NOW, no drain
        state, code, error = "escalated", EXIT_ESCALATED, "KeyboardInterrupt"
    except Exception:
        state, code = "crashed", EXIT_CRASH
        error = traceback.format_exc()
    finally:
        try:
            publisher.publish(force=True)
        except Exception:
            pass
        if state in ("done", "preempted"):
            # graceful exits tombstone the lease so observers drop us at
            # once; a crash leaves the stale lease for the pid probe / lease
            # timeout to surface (truthful failure telemetry)
            heartbeat.mark_dead(spec.member_id)
        _write_status(root, spec, state, ticks=ticks, error=error,
                      loaded_at_guard=loaded_at_guard)
        flush = getattr(getattr(reg, "sink", None), "flush", None)
        if callable(flush):
            try:
                flush()
            except Exception:
                pass
    return code


#: the child's command: load ``preemption.py`` alone (stdlib imports only)
#: and install the guard, THEN import the package (whose import pulls in
#: torch) and run the harness. An import, not ``-m``, so runpy never runs a
#: second ``__main__`` copy of this module. argv: spec path, preemption.py.
_CHILD_CMD = (
    "import importlib.util, sys; "
    "s = importlib.util.spec_from_file_location("
    "'agilerl_tpu_torch.resilience.preemption', sys.argv[2]); "
    "m = importlib.util.module_from_spec(s); sys.modules[s.name] = m; "
    "s.loader.exec_module(m); "
    "loaded = [n for n in ('torch', 'agilerl_tpu_torch') if n in sys.modules]; "
    "g = m.PreemptionGuard().install(); "
    "from agilerl_tpu_torch.resilience.proc import run_role; "
    "sys.exit(run_role(sys.argv[1], guard=g, loaded_at_guard=loaded))"
)
_PREEMPTION_PY = str(Path(__file__).with_name("preemption.py"))


class SupervisedProcess:
    """One spawned role: the Popen handle plus the signal plumbing.

    The child gets its OWN session / process group, so group-wide signals
    from the supervisor never loop back into the launcher, and any
    grandchildren the role spawns die with it on escalation."""

    def __init__(self, spec: RoleSpec, popen: subprocess.Popen, spec_path: Path,
                 log_path: Path) -> None:
        self.spec = spec
        self.popen = popen
        self.spec_path = spec_path
        self.log_path = log_path

    @classmethod
    def spawn(cls, spec: RoleSpec,
              extra_env: Optional[Dict[str, str]] = None) -> "SupervisedProcess":
        root = Path(spec.root)
        for sub in (SPECS_DIR, STATUS_DIR, LOGS_DIR, MEMBERSHIP_DIR, TELEMETRY_DIR):
            (root / sub).mkdir(parents=True, exist_ok=True)
        spec_path = root / SPECS_DIR / f"{spec.name}.{int(spec.incarnation):03d}.json"
        atomic_write_bytes(spec_path, spec.to_json().encode())
        log_path = root / LOGS_DIR / f"{spec.name}.log"
        env = dict(os.environ)
        env.update(spec.env or {})
        env.update(extra_env or {})
        # append-mode log: restarts of the same role continue one file, and
        # a torn tail line on SIGKILL is harmless
        log = open(log_path, "ab")
        try:
            popen = subprocess.Popen(
                [sys.executable, "-u", "-c", _CHILD_CMD, str(spec_path), _PREEMPTION_PY],
                stdout=log, stderr=subprocess.STDOUT, env=env, start_new_session=True)
        finally:
            log.close()  # the child holds its own descriptor now
        return cls(spec, popen, spec_path, log_path)

    @property
    def pid(self) -> int:
        return self.popen.pid

    @property
    def alive(self) -> bool:
        return self.popen.poll() is None

    def poll(self) -> Optional[int]:
        return self.popen.poll()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            return self.popen.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def _signal(self, signum: int) -> None:
        """Double delivery ON PURPOSE: the group signal covers any
        grandchildren, the direct signal covers a child that moved itself out
        of the group. The guard's latch is idempotent."""
        try:
            os.killpg(os.getpgid(self.pid), signum)
        except (ProcessLookupError, PermissionError, OSError):
            pass
        try:
            os.kill(self.pid, signum)
        except (ProcessLookupError, PermissionError, OSError):
            pass

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)


class ProcessSupervisor:
    """The launcher's fleet of supervised role processes over one root.

    ``poll()`` is the supervision step: reap exits, classify them, respawn
    crashes with a bumped incarnation (so membership reports the rejoin) up
    to ``max_restarts`` per role. ``shutdown()`` is the graceful drain:
    SIGTERM everyone, give the grace window, SIGKILL stragglers, verify no
    orphans."""

    def __init__(self, root: Union[str, Path], lease_timeout: float = 5.0,
                 grace_s: float = 10.0, max_restarts: int = 2, registry=None,
                 probe_pids: bool = True) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.lease_timeout = float(lease_timeout)
        self.grace_s = float(grace_s)
        self.max_restarts = int(max_restarts)
        self._registry_override = registry
        self.heartbeat = HeartbeatStore(self.root / MEMBERSHIP_DIR, lease_timeout=lease_timeout,
                                        registry=registry, probe_pids=probe_pids)
        self.procs: Dict[str, SupervisedProcess] = {}
        self.exits: Dict[str, int] = {}
        self.restarts: Dict[str, int] = {}
        self._shutting_down = False

    @property
    def metrics(self):
        if self._registry_override is not None:
            return self._registry_override
        from agilerl_tpu_torch.observability import get_registry

        return get_registry()

    # -- lifecycle --------------------------------------------------------- #
    def spawn(self, spec: RoleSpec) -> SupervisedProcess:
        spec = dataclasses.replace(spec, root=str(self.root), lease_timeout=self.lease_timeout)
        proc = SupervisedProcess.spawn(spec)
        self.procs[spec.name] = proc
        self.exits.pop(spec.name, None)
        self.metrics.counter("resilience/proc_spawns_total",
                             help="supervised role processes spawned").inc()
        self.metrics.emit("proc_spawn", role=spec.name, pid=proc.pid,
                          incarnation=int(spec.incarnation))
        return proc

    def poll(self) -> List[Dict[str, Any]]:
        """One supervision step. Returns the exit events observed this call
        (``role``, ``code``, ``action``: done | drained | restarted |
        gave_up)."""
        events: List[Dict[str, Any]] = []
        for name, proc in list(self.procs.items()):
            if name in self.exits:
                continue
            code = proc.poll()
            if code is None:
                continue
            self.exits[name] = code
            self.metrics.counter("resilience/proc_exits_total",
                                 help="supervised role process exits observed").inc()
            if code == EXIT_DONE:
                action = "done"
            elif code == EXIT_PREEMPTED:
                action = "drained"
            elif not self._shutting_down and self.restarts.get(name, 0) < self.max_restarts:
                self.restarts[name] = self.restarts.get(name, 0) + 1
                self.metrics.counter("resilience/proc_restarts_total",
                                     help="crashed role processes respawned").inc()
                self.spawn(dataclasses.replace(proc.spec,
                                               incarnation=proc.spec.incarnation + 1))
                action = "restarted"
            else:
                action = "gave_up"
            self.metrics.emit("proc_exit", role=name, code=code, action=action)
            events.append({"role": name, "code": code, "action": action})
        return events

    def running(self) -> List[str]:
        return [n for n, p in self.procs.items() if n not in self.exits and p.alive]

    def all_done(self) -> bool:
        self.poll()
        return not self.running()

    def wait(self, timeout: float = 60.0, poll_interval: float = 0.05) -> bool:
        """Supervise until every role exits (restarts included) or the
        deadline passes. Returns True when the fleet fully drained."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            if self.all_done():
                return True
            time.sleep(poll_interval)
        return self.all_done()

    def statuses(self) -> Dict[str, Dict[str, Any]]:
        return read_statuses(self.root)

    # -- shutdown ---------------------------------------------------------- #
    def shutdown(self, grace_s: Optional[float] = None) -> Dict[str, Any]:
        """Graceful fleet drain: forward SIGTERM (double-delivered) to every
        live child, wait out the grace window, SIGKILL stragglers, reap
        everything and verify that no orphan survived. Returns a summary with
        per-role exit codes and the roles that needed escalation."""
        self._shutting_down = True
        grace = self.grace_s if grace_s is None else float(grace_s)
        live = [p for p in self.procs.values() if p.alive]
        for p in live:
            p.terminate()
        deadline = time.monotonic() + grace
        escalated: List[str] = []
        for p in live:
            remaining = deadline - time.monotonic()
            if p.wait(timeout=max(remaining, 0.01)) is None:
                escalated.append(p.spec.name)
                p.kill()
                p.wait(timeout=5.0)
        for name, p in self.procs.items():
            code = p.poll()
            if code is not None:
                self.exits[name] = code
        orphans = [p.spec.name for p in self.procs.values() if pid_alive(p.pid)]
        if escalated:
            self.metrics.counter(
                "resilience/proc_escalations_total",
                help="children that outlived the SIGTERM grace window and were "
                     "SIGKILLed").inc(len(escalated))
        self.metrics.emit("proc_shutdown", exits=dict(self.exits), escalated=escalated,
                          orphans=orphans)
        return {"exits": dict(self.exits), "escalated": escalated, "orphans": orphans,
                "statuses": self.statuses()}


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(run_role(sys.argv[1]))
