"""Multi-process pod launcher, the whole stack as real OS processes: the
port of ``agilerl_tpu/training/launch.py`` (whole).

Every pod-to-pod interaction of the serving / training stack already flows
through commit-dir stores on one filesystem root: weights
(:class:`~agilerl_tpu_torch.llm.flywheel.WeightStore`), trajectories
(:class:`~agilerl_tpu_torch.llm.flywheel.TrajectoryStore`), KV transfers and
telemetry snapshots. This module spawns the roles as **separate OS
processes** and supervises them: the Podracer / Sebulba deployment shape
(decoupled actor and learner pods on cheap preemptible hosts) and
DistServe-style role disaggregation.

Layers:

- :class:`PodLauncher`: the launcher-side composition root. Declare roles
  (:meth:`~PodLauncher.add_role`), :meth:`~PodLauncher.start` the fleet
  (with a join barrier), :meth:`~PodLauncher.run` the supervision loop
  (restart crashed roles, honour SIGTERM by draining the whole fleet through
  each child's :class:`~agilerl_tpu_torch.resilience.preemption
  .PreemptionGuard`), :meth:`~PodLauncher.shutdown` explicitly. Liveness and
  leadership ride :class:`~agilerl_tpu_torch.resilience.membership
  .HeartbeatStore` leases with the same-host pid probe, so a killed local
  role surfaces on the next poll, not after the lease window.

- Child-side **role entry points** (named in a spec as
  ``agilerl_tpu_torch.training.launch:<fn>``): :func:`rollout_role` /
  :func:`learner_role` wrap the GRPO flywheel pods in poll-cadence tick
  loops; :func:`driver_role` is the generic adapter for anything with a step
  method (``ServingFleet.step``); :func:`idle_role` is the trivial role the
  tests drive. Role objects are REBUILT inside the child from
  ``module:function`` entry points: nothing is pickled across the exec, and
  each child makes its own CUDA context on the card (the kernels' libraries,
  built once under ``ops/_build``, are loaded, not rebuilt).

- :func:`launch_flywheel`: one learner + N rollout processes over one root
  (declared by :func:`flywheel_launcher`), supervised to completion. With
  ``max_staleness_epochs=0`` and one actor the lockstep gate reproduces the
  in-process
  :class:`~agilerl_tpu_torch.llm.flywheel.OnlineGRPOFlywheel` loss / adapter
  stream exactly. A killed learner warm-restarts through
  :meth:`~agilerl_tpu_torch.llm.flywheel.LearnerPod.restore_from_store`.

Store layout under the launch root::

    root/
      specs/        role spec JSON (argv of each child)
      status/       per-role exit status (atomic)
      logs/         per-role stdout/stderr + JSONL event streams
      membership/   HeartbeatStore leases (pid-probed)
      telemetry/    per-pod TelemetryPublisher snapshots
      weights/      WeightStore epochs (launch_flywheel)
      trajectories/ TrajectoryStore batches (launch_flywheel)
      cursors/      per-actor rollout seq cursors (respawn-safe)

Children inherit the launcher's environment and working directory; pass
``env={"PYTHONPATH": <root of the checkout>}`` when a factory lives outside
an installed package.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

from agilerl_tpu_torch.resilience.preemption import PreemptionGuard
from agilerl_tpu_torch.resilience.proc import (
    TELEMETRY_DIR,
    ProcessSupervisor,
    RoleContext,
    RoleSpec,
    read_statuses,
    resolve_target,
)

#: launch-root store layout shared by the launcher and the flywheel roles
WEIGHTS_DIR = "weights"
TRAJECTORIES_DIR = "trajectories"
CURSORS_DIR = "cursors"

_ROLES = "agilerl_tpu_torch.training.launch"


class PodLauncher:
    """Compose and supervise a fleet of role processes over one root.

    Usage::

        launcher = PodLauncher(root, lease_timeout=2.0)
        launcher.add_role("learner", "agilerl_tpu_torch.training.launch:learner_role",
                          kwargs={...})
        launcher.add_role("rollout_0", "agilerl_tpu_torch.training.launch:rollout_role",
                          kwargs={...})
        launcher.start()
        summary = launcher.run(timeout=120.0)

    The launcher installs its own :class:`PreemptionGuard` for the
    supervision loop (from :meth:`start` to :meth:`shutdown`): a SIGTERM to
    the launcher drains the WHOLE fleet (forwarded termination, per-role
    final snapshots, telemetry flushes) before the launcher itself
    returns."""

    def __init__(self, root: Union[str, Path], lease_timeout: float = 5.0,
                 grace_s: float = 10.0, max_restarts: int = 2, poll_interval: float = 0.05,
                 registry=None, probe_pids: bool = True):
        self.root = Path(root)
        self.supervisor = ProcessSupervisor(
            self.root, lease_timeout=lease_timeout, grace_s=grace_s,
            max_restarts=max_restarts, registry=registry, probe_pids=probe_pids)
        self.poll_interval = float(poll_interval)
        self.guard = PreemptionGuard(registry=registry)
        self._specs: List[RoleSpec] = []
        self._started = False
        self._telemetry_agg = None
        self._telemetry_next = 0.0

    @property
    def heartbeat(self):
        return self.supervisor.heartbeat

    @property
    def metrics(self):
        return self.supervisor.metrics

    # -- composition ------------------------------------------------------- #
    def add_role(self, name: str, target: str, kwargs: Optional[Dict[str, Any]] = None,
                 replica: int = 0, member_id: Optional[int] = None,
                 poll_interval: float = 0.0, beat_interval: Optional[float] = None,
                 env: Optional[Dict[str, str]] = None) -> RoleSpec:
        """Declare one role. ``member_id`` defaults to the declaration index:
        the first-declared role is the membership leader (lowest live id), so
        declare the learner / controller first."""
        if any(s.name == name for s in self._specs):
            raise ValueError(f"duplicate role name {name!r}")
        spec = RoleSpec(
            name=name, target=target, root=str(self.root),
            member_id=len(self._specs) if member_id is None else int(member_id),
            kwargs=dict(kwargs or {}), replica=int(replica),
            lease_timeout=self.supervisor.lease_timeout, beat_interval=beat_interval,
            poll_interval=float(poll_interval), env=dict(env or {}))
        self._specs.append(spec)
        return spec

    # -- lifecycle --------------------------------------------------------- #
    def start(self, wait_for_members: bool = True, join_timeout: float = 60.0) -> None:
        """Spawn every declared role; optionally block until every member
        has a live lease or a completed exit (a very fast role can finish and
        tombstone its lease before the first poll: that is a join, not
        missing capacity). Bounded, so missing capacity raises instead of
        waiting forever."""
        if not self._specs:
            raise ValueError("no roles declared: add_role() first")
        self.guard.install()
        for spec in self._specs:
            self.supervisor.spawn(spec)
        self._started = True
        if wait_for_members:
            self._join_barrier(join_timeout)
            self.heartbeat.expect([s.member_id for s in self._specs])

    def _join_barrier(self, timeout: float) -> None:
        from agilerl_tpu_torch.resilience.membership import MembershipChange

        deadline = time.monotonic() + float(timeout)
        while True:
            live = set(self.heartbeat.alive())
            joined = [s for s in self._specs
                      if s.member_id in live or self.supervisor.procs[s.name].poll() is not None]
            if len(joined) == len(self._specs):
                return
            if time.monotonic() >= deadline:
                missing = [s.name for s in self._specs if s not in joined]
                raise MembershipChange(f"launch join timed out after {timeout}s: roles never "
                                       f"came up: {missing}", alive=sorted(live))
            time.sleep(self.poll_interval)

    def poll(self) -> List[Dict[str, Any]]:
        """One supervision step: reap / restart role exits and surface
        membership changes (the pid probe makes a killed local role show up
        here at once)."""
        events = self.supervisor.poll()
        self.heartbeat.poll()
        # fold telemetry continuously (rate-limited): counter rebasing is
        # stateful, a restarted role's pre-crash high-water mark is banked
        # only if the aggregator saw it before the fresh incarnation's
        # near-zero snapshot replaced it as the newest entry
        now = time.monotonic()
        if now >= self._telemetry_next:
            self._telemetry().poll()
            self._telemetry_next = now + max(self.supervisor.lease_timeout / 4.0, 0.25)
        return events

    def run(self, timeout: float = 300.0,
            until: Optional[Callable[[], bool]] = None) -> Dict[str, Any]:
        """Supervise until every role exits, ``until()`` turns true, the
        launcher is preempted or the deadline passes; then drain the fleet
        and return the shutdown summary."""
        if not self._started:
            self.start()
        deadline = time.monotonic() + float(timeout)
        timed_out = False
        while True:
            self.poll()
            if self.guard.requested:
                break
            if until is not None and until():
                break
            if not self.supervisor.running():
                break
            if time.monotonic() >= deadline:
                timed_out = True
                break
            time.sleep(self.poll_interval)
        summary = self.shutdown()
        summary["preempted"] = bool(self.guard.requested)
        summary["timed_out"] = timed_out
        return summary

    def shutdown(self, grace_s: Optional[float] = None) -> Dict[str, Any]:
        """Drain the fleet (see :meth:`ProcessSupervisor.shutdown`), then
        give the launcher's signals back to the handlers it found."""
        summary = self.supervisor.shutdown(grace_s)
        self.guard.uninstall()
        return summary

    def statuses(self) -> Dict[str, Dict[str, Any]]:
        return read_statuses(self.root)

    def _telemetry(self):
        if self._telemetry_agg is None:
            from agilerl_tpu_torch.observability import TelemetryAggregator

            self._telemetry_agg = TelemetryAggregator(self.root / TELEMETRY_DIR,
                                                      metrics=self.metrics)
        return self._telemetry_agg

    def aggregate_telemetry(self) -> Dict[str, Any]:
        """Fleet-wide metrics view (``registry.dump()`` form) merged from
        every role's published telemetry snapshots. The aggregator is the
        launcher's own long-lived one, folded on every :meth:`poll`, so
        counters survive role restarts (rebased, not reset)."""
        agg = self._telemetry()
        agg.poll()
        return agg.merged_dump()


# --------------------------------------------------------------------------- #
# child-side role entry points
# --------------------------------------------------------------------------- #
def _flywheel_stores(ctx: RoleContext, keep_last: int):
    from agilerl_tpu_torch.llm.flywheel import TrajectoryStore, WeightStore

    weights = WeightStore(ctx.root / WEIGHTS_DIR, keep_last=keep_last, metrics=ctx.metrics)
    trajectories = TrajectoryStore(ctx.root / TRAJECTORIES_DIR, metrics=ctx.metrics)
    return weights, trajectories


def _build(entry: str, kwargs: Optional[Dict[str, Any]]):
    return resolve_target(entry)(**(kwargs or {}))


class _RolloutRole:
    """Poll-cadence driver around :class:`RolloutPod`: adopt the freshest
    published epoch, roll out when the flow-control gate opens, finish after
    ``max_seqs`` published batches. The per-actor cursor file makes a
    respawned actor continue its seq line instead of replaying it."""

    def __init__(self, ctx: RoleContext):
        kw = ctx.spec.kwargs
        from agilerl_tpu_torch.llm.flywheel import RolloutPod

        agent = _build(kw["make_agent"], kw.get("agent_kwargs"))
        env = _build(kw["make_env"], kw.get("env_kwargs"))
        weights, trajectories = _flywheel_stores(ctx, int(kw.get("keep_last", 4)))
        actor_id = int(kw.get("actor_id", 0))
        cursor = ctx.root / CURSORS_DIR / f"actor_{actor_id:03d}.json"
        cursor.parent.mkdir(parents=True, exist_ok=True)
        self.pod = RolloutPod(agent, env, weights, trajectories, actor_id=actor_id,
                              metrics=ctx.metrics, cursor_path=cursor)
        self.ctx = ctx
        self.max_seqs = int(kw["max_seqs"])
        self.max_staleness = int(kw.get("max_staleness_epochs", 0))
        self.max_inflight = int(kw.get("max_inflight", self.max_staleness + 1))
        self.greedy = bool(kw.get("greedy", False))
        #: single-actor lockstep gate: only produce seq k once epoch
        #: >= k - max_staleness is published; at staleness 0 this is the
        #: in-process driver's interleave, so the stream matches bit for bit
        self.lockstep = bool(kw.get("lockstep", False))

    def tick(self) -> bool:
        if self.pod.seq >= self.max_seqs:
            return True
        self.pod.poll_weights()
        if self.pod.weight_epoch < 0:
            return False  # nothing published yet: idle, stay live
        if self.pod.traj_store.pending() >= self.max_inflight:
            return False  # flow control: anything more would be stale
        if self.lockstep and self.pod.weight_epoch < self.pod.seq - self.max_staleness:
            return False  # the learner has not caught up to our seq line
        self.pod.rollout_once(greedy=self.greedy)
        return self.pod.seq >= self.max_seqs


class _LearnerRole:
    """Poll-cadence driver around :class:`LearnerPod` with warm restart: a
    respawned learner process restores the optimizer / reference / RNG state
    that rides every published weight epoch (``carry_state``) and resumes the
    exact loss stream; a fresh root publishes epoch 0 so actors can adopt
    before the first learn."""

    def __init__(self, ctx: RoleContext):
        kw = ctx.spec.kwargs
        from agilerl_tpu_torch.llm.flywheel import LearnerPod

        agent = _build(kw["make_agent"], kw.get("agent_kwargs"))
        weights, trajectories = _flywheel_stores(ctx, int(kw.get("keep_last", 4)))
        self.pod = LearnerPod(agent, weights, trajectories,
                              max_staleness_epochs=int(kw.get("max_staleness_epochs", 0)),
                              metrics=ctx.metrics, publish_initial=False,
                              carry_state=bool(kw.get("carry_state", True)))
        if not self.pod.restore_from_store():
            self.pod.publish()  # fresh root: epoch 0 = the initial adapter
        self.max_epochs = int(kw["max_epochs"])

    def tick(self) -> bool:
        if self.pod.epoch >= self.max_epochs:
            return True
        # cap the per-tick batch budget so a backlog (several actors ahead of
        # the learner) never trains PAST max_epochs inside one step
        self.pod.step(max_batches=self.max_epochs - self.pod.epoch)
        return self.pod.epoch >= self.max_epochs


def rollout_role(ctx: RoleContext) -> _RolloutRole:
    """Entry point: GRPO rollout pod as a supervised process.

    kwargs: ``make_agent`` / ``make_env`` (``module:function`` entry points,
    with optional ``agent_kwargs`` / ``env_kwargs``), ``actor_id``,
    ``max_seqs``, ``max_staleness_epochs``, ``max_inflight``, ``greedy``,
    ``lockstep``, ``keep_last``."""
    return _RolloutRole(ctx)


def learner_role(ctx: RoleContext) -> _LearnerRole:
    """Entry point: GRPO learner pod as a supervised process.

    kwargs: ``make_agent`` (+ ``agent_kwargs``), ``max_epochs``,
    ``max_staleness_epochs``, ``carry_state``, ``keep_last``."""
    return _LearnerRole(ctx)


class _DriverRole:
    """Generic poll-cadence adapter: build an object from an entry point and
    call one bounded method per tick. This is how serving-fleet steps
    (``method="step"``) run as processes without bespoke drivers; the
    object's own store wiring (KV transfers, telemetry) is untouched."""

    def __init__(self, ctx: RoleContext):
        kw = ctx.spec.kwargs
        self.obj = _build(kw["make"], kw.get("make_kwargs"))
        self._method = getattr(self.obj, str(kw.get("method", "step")))
        self._method_kwargs = dict(kw.get("method_kwargs") or {})
        self.max_ticks = kw.get("max_ticks")
        self.ticks = 0

    def tick(self) -> bool:
        self._method(**self._method_kwargs)
        self.ticks += 1
        return self.max_ticks is not None and self.ticks >= int(self.max_ticks)

    def drain(self) -> None:
        final = getattr(self.obj, "drain", None)
        if callable(final):
            final()


def driver_role(ctx: RoleContext) -> _DriverRole:
    """Entry point: generic step-method driver (serving fleet).

    kwargs: ``make`` (+ ``make_kwargs``), ``method`` (default ``"step"``, +
    ``method_kwargs``), ``max_ticks`` (None = run until preempted)."""
    return _DriverRole(ctx)


class _IdleRole:
    """Trivial role for tests and docs: counts ticks (optionally forever)
    and records a drain marker on graceful exit, the smallest thing that
    exercises the whole harness contract."""

    def __init__(self, ctx: RoleContext):
        self.ctx = ctx
        self.max_ticks = ctx.spec.kwargs.get("max_ticks")
        self.ticks = 0

    def tick(self) -> bool:
        self.ticks += 1
        self.ctx.metrics.counter("launch/idle_ticks_total").inc()
        return self.max_ticks is not None and self.ticks >= int(self.max_ticks)

    def drain(self) -> None:
        from agilerl_tpu_torch.resilience.atomic import atomic_write_bytes

        atomic_write_bytes(self.ctx.root / f"drain_{self.ctx.spec.name}.json",
                           json.dumps({"role": self.ctx.spec.name,
                                       "ticks": self.ticks}).encode())


def idle_role(ctx: RoleContext) -> _IdleRole:
    """Entry point: the trivial tick-counting role (tests and docs).

    kwargs: ``max_ticks`` (None = tick until preempted)."""
    return _IdleRole(ctx)


# --------------------------------------------------------------------------- #
# flywheel composition
# --------------------------------------------------------------------------- #
def read_loss_stream(root: Union[str, Path]) -> List[float]:
    """The learner's per-epoch loss stream, read from the weight-epoch
    MANIFESTS (no payload unpickling). Bounded by the store's ``keep_last``:
    pass a large ``keep_last`` to :func:`launch_flywheel` when the whole
    stream matters."""
    from agilerl_tpu_torch.resilience.store import committed_entries, read_manifest

    losses: List[float] = []
    for entry in committed_entries(Path(root) / WEIGHTS_DIR, "epoch_"):
        try:
            manifest = read_manifest(entry)
        except Exception:
            continue
        if "loss" in manifest:
            losses.append(manifest["loss"])  # a JSON scalar
    return losses


def flywheel_launcher(
    root: Union[str, Path],
    make_agent: str,
    make_env: str,
    max_epochs: int,
    num_rollouts: int = 1,
    max_staleness_epochs: int = 0,
    agent_kwargs: Optional[Dict[str, Any]] = None,
    env_kwargs: Optional[Dict[str, Any]] = None,
    rollout_seqs: Optional[int] = None,
    keep_last: Optional[int] = None,
    lease_timeout: float = 5.0,
    grace_s: float = 15.0,
    max_restarts: int = 2,
    greedy: bool = False,
    env: Optional[Dict[str, str]] = None,
    registry=None,
    learner_target: str = f"{_ROLES}:learner_role",
    rollout_target: str = f"{_ROLES}:rollout_role",
) -> PodLauncher:
    """The :class:`PodLauncher` that :func:`launch_flywheel` runs, declared
    and not started: one learner + ``num_rollouts`` rollout roles over
    ``root`` (a caller that kills or drains a role mid-run starts it
    itself). The arguments are :func:`launch_flywheel`'s."""
    max_epochs = int(max_epochs)
    staleness = int(max_staleness_epochs)
    total_seqs = max_epochs if rollout_seqs is None else int(rollout_seqs)
    per_actor = [total_seqs // num_rollouts] * num_rollouts
    for i in range(total_seqs % num_rollouts):
        per_actor[i] += 1
    keep = int(keep_last) if keep_last is not None else max(4, max_epochs + 1)
    launcher = PodLauncher(root, lease_timeout=lease_timeout, grace_s=grace_s,
                           max_restarts=max_restarts, registry=registry)
    launcher.add_role(
        "learner", learner_target,
        kwargs={"make_agent": make_agent, "agent_kwargs": agent_kwargs,
                "max_epochs": max_epochs, "max_staleness_epochs": staleness,
                "keep_last": keep},
        env=env)
    lockstep = num_rollouts == 1
    for i in range(num_rollouts):
        launcher.add_role(
            f"rollout_{i}", rollout_target,
            kwargs={"make_agent": make_agent, "agent_kwargs": agent_kwargs,
                    "make_env": make_env, "env_kwargs": env_kwargs, "actor_id": i,
                    "max_seqs": per_actor[i], "max_staleness_epochs": staleness,
                    "greedy": bool(greedy), "lockstep": lockstep, "keep_last": keep},
            replica=i, poll_interval=0.01, env=env)
    return launcher


def launch_flywheel(
    root: Union[str, Path],
    make_agent: str,
    make_env: str,
    max_epochs: int,
    num_rollouts: int = 1,
    max_staleness_epochs: int = 0,
    agent_kwargs: Optional[Dict[str, Any]] = None,
    env_kwargs: Optional[Dict[str, Any]] = None,
    rollout_seqs: Optional[int] = None,
    keep_last: Optional[int] = None,
    lease_timeout: float = 5.0,
    grace_s: float = 15.0,
    max_restarts: int = 2,
    timeout: float = 300.0,
    greedy: bool = False,
    env: Optional[Dict[str, str]] = None,
    registry=None,
    learner_target: str = f"{_ROLES}:learner_role",
    rollout_target: str = f"{_ROLES}:rollout_role",
) -> Dict[str, Any]:
    """One learner + ``num_rollouts`` rollout processes over ``root``,
    supervised to ``max_epochs`` published weight epochs.

    ``make_agent`` / ``make_env`` are ``module:function`` entry points; the
    SAME construction must give RNG-identical agents in every process, so
    pass the seed through ``agent_kwargs``. With one rollout and staleness 0
    the lockstep gate reproduces the in-process driver's stream exactly.
    ``learner_target`` / ``rollout_target`` name the roles' entry points (a
    wrapper of :func:`learner_role` that adds instrumentation, say). Returns
    the shutdown summary plus the loss stream read back from the weight-epoch
    manifests and (``telemetry``) the roles' merged metrics
    (:meth:`PodLauncher.aggregate_telemetry`)."""
    launcher = flywheel_launcher(
        root, make_agent, make_env, max_epochs, num_rollouts=num_rollouts,
        max_staleness_epochs=max_staleness_epochs, agent_kwargs=agent_kwargs,
        env_kwargs=env_kwargs, rollout_seqs=rollout_seqs, keep_last=keep_last,
        lease_timeout=lease_timeout, grace_s=grace_s, max_restarts=max_restarts, greedy=greedy,
        env=env, registry=registry, learner_target=learner_target,
        rollout_target=rollout_target)
    launcher.start()
    summary = launcher.run(timeout=timeout)
    summary["losses"] = read_loss_stream(root)
    summary["telemetry"] = launcher.aggregate_telemetry()
    summary["root"] = str(root)
    return summary
