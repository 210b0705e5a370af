"""Elastic preemption-native PBT: the port of ``agilerl_tpu/parallel/elastic.py``.

The :class:`ElasticPBTController` runs a population engine (``EvoPPO``, the
``ScanOffPolicy`` family, ``EvoIPPO``) across hosts that can disappear and
treats capacity as a dynamic quantity. The four pieces of the JAX module
stay: **membership** (leases in the shared store's
:class:`~agilerl_tpu_torch.resilience.membership.HeartbeatStore`, the leader
the lowest live host), **recovery** (a plan for the new slot count from the
plan registry, the lost members' rows spliced back from a
:class:`~agilerl_tpu_torch.resilience.snapshot.CheckpointManager` snapshot),
**elastic resize** (shrink by evicting the worst members, grow by cloning
and mutating tournament winners, every change a lineage event; the
population always a multiple of the live slot count: zero idle slots) and
**island migration** (top-k exports through the commit-dir store,
hash-validated imports, torn exports skipped and counted).

The port's decisions:

- **Emulation in one process.** A torch process holds one device, so an
  emulated host owns *slots*: distinct :class:`Slot` values
  ``(device, index)`` (``device_slots``). The layout counts slots exactly as
  the JAX package counts devices (``_target_pop_for``, the plan from
  ``plans_for_device_count`` / ``make_population_plan``), and a slot is
  tested for membership by its value, so a host's slots never match
  another's. The generation over an emulated layout is the engine's
  ``make_vmap_generation`` over all live members: only the bookkeeping
  depends on the layout, so a recovery that restores every lost member from
  the boundary's snapshot continues the stream bit for bit.
- **Real ranks (pod mode).** When a process group of world size > 1 is up,
  each controller is one rank's, with ``hosts=[EmulatedHost(rank,
  [slot])]``. The generation is the engine's ``make_pod_generation`` over
  the plan's mesh (each rank runs its members; fitness and the evolved
  subtree are all-gathered), dispatched under
  ``multihost.call_with_collective_timeout``. A lost rank (a dispatch that
  times out, or gloo's immediate error on a closed connection) counts under
  ``resilience/collective_timeouts_total`` and raises ``MembershipChange``:
  the group is broken, so recovery is a new process group and
  :meth:`ElasticPBTController.resume`. Replay rings and env states never
  cross ranks during a generation, so a snapshot all-gathers every rank's
  rows and the leader (rank 0) commits the whole population: a snapshot of
  rank 0's rows alone could not bring back rank 1's members. Pod mode runs
  no in-process recovery, resize or island exchange (the ranks could read
  the exchange directory at different moments and decide differently);
  capacity changes come through a restart at the new world size.
- **Random streams.** The JAX controller's key becomes one
  ``torch.Generator`` on the engine's device, seeded as ``ScanRun`` seeds
  its own (the initial population from a CPU generator of the same seed),
  so an unkilled controller's stream is ``ScanRun``'s. Snapshots carry its
  state (``utils/rng.generator_to_host``). The resize / tournament RNG
  stays ``np.random.default_rng(seed)``, so shrink and grow decisions replay
  the JAX package's for the same fitness. A clone is mutated with
  ``generation.mutation_noise`` / ``gaussian_mutate`` from the generator.
- **The dispatch changes nothing on the controller.** It runs on a copy of
  the boundary state (the off-policy engines write their rings and targets
  in place) and of the generator; the caller commits the population, the
  generator's state and the fitness only after a successful join, so a
  dispatch abandoned by the watchdog cannot race the retry.
- ``compile_cache=`` other than None raises: the port runs eagerly, there
  is no ahead-of-time program to store.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from agilerl_tpu_torch.ops import resolve_device
from agilerl_tpu_torch.parallel.generation import (
    gaussian_mutate,
    member_slice,
    mutation_noise,
    population_load_state_dict,
    population_state_dict,
)
from agilerl_tpu_torch.parallel.multihost import call_with_collective_timeout
from agilerl_tpu_torch.resilience.atomic import (
    TMP_DIR_SUFFIX,
    CorruptSnapshotError,
    load_validated_pickle,
)
from agilerl_tpu_torch.resilience.membership import (
    HeartbeatStore,
    MembershipChange,
    MembershipEvent,
)
from agilerl_tpu_torch.resilience.snapshot import CheckpointManager, restore_np_generator
from agilerl_tpu_torch.resilience.store import entry_seq, gc_entries, publish_entry, read_manifest
from agilerl_tpu_torch.utils.rng import generator_from_host, generator_to_host
from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

PyTree = Any

_EXPORT_PREFIX = "export_"


class Slot(NamedTuple):
    """One place for a block of members on an emulated host: a device and
    an index (many slots share the one device of a torch process)."""

    device: str
    index: int


def device_slots(n: int, device=None) -> List[Slot]:
    """``n`` distinct slots on ``device`` (the card when None)."""
    dev = str(resolve_device(device))
    return [Slot(dev, i) for i in range(int(n))]


class EmulatedHost:
    """One logical host: an id plus the slots it owns. In one-process
    emulation a process holds several; in pod mode each rank holds exactly
    one (its rank and its one slot)."""

    __slots__ = ("host_id", "devices", "alive", "incarnation")

    def __init__(self, host_id: int, devices: Sequence[Any], alive: bool = True):
        self.host_id = int(host_id)
        self.devices = tuple(devices)
        self.alive = bool(alive)
        self.incarnation = 0

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        state = "up" if self.alive else "DOWN"
        return f"EmulatedHost({self.host_id}, {len(self.devices)} slots, {state})"


def make_emulated_hosts(
    n_hosts: int,
    devices: Optional[Sequence[Any]] = None,
    devices_per_host: Optional[int] = None,
) -> List[EmulatedHost]:
    """Split the slots (default: one per host on the card) into ``n_hosts``
    contiguous groups."""
    n_hosts = int(n_hosts)
    devices = list(devices) if devices is not None else device_slots(n_hosts)
    if devices_per_host is None:
        if len(devices) % n_hosts != 0:
            raise ValueError(f"{len(devices)} devices do not split evenly over "
                             f"{n_hosts} hosts; pass devices_per_host")
        devices_per_host = len(devices) // n_hosts
    need = n_hosts * int(devices_per_host)
    if need > len(devices):
        raise ValueError(f"need {need} devices for {n_hosts}x{devices_per_host}, "
                         f"have {len(devices)}")
    return [EmulatedHost(h, devices[h * devices_per_host:(h + 1) * devices_per_host])
            for h in range(n_hosts)]


class IslandConfig:
    """Island-model migration settings: this pod's identity in the shared
    exchange directory, how many members to export, and the cadence (in
    generations; 0 disables exchange)."""

    def __init__(self, island_id: str, exchange_dir: Union[str, Path], top_k: int = 1,
                 every: int = 1, keep_exports: int = 2):
        self.island_id = str(island_id)
        self.exchange_dir = Path(exchange_dir)
        self.top_k = max(int(top_k), 1)
        self.every = int(every)
        self.keep_exports = max(int(keep_exports), 1)


def _copy_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _copy_tree(tree: PyTree) -> PyTree:
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def _rows(tree: PyTree, idx: Sequence[int]) -> PyTree:
    """Members ``idx`` of every tensor leaf; other leaves are kept."""
    return tree_map(lambda x: x[torch.as_tensor(list(idx), device=x.device)]
                    if isinstance(x, torch.Tensor) else x, tree)


def _concat(tree: PyTree, *more: PyTree) -> PyTree:
    return tree_map(lambda x, *ys: torch.cat((x,) + ys) if isinstance(x, torch.Tensor) else x,
                    tree, *more)


class ElasticPBTController:
    """Drive a population engine across hosts that can disappear.

    engine:
        Any population engine exposing ``init_population(gen, pop_size)``,
        ``make_vmap_generation()`` and ``make_pod_generation(mesh=, plan=)``
        (``EvoPPO``, the ``ScanOffPolicy`` family, ``EvoIPPO``).
    store_dir:
        The shared store: ``snapshots/`` (CheckpointManager) and
        ``membership/`` (lease files) live under it.
    hosts / n_hosts / devices:
        The host topology: an explicit :class:`EmulatedHost` list, or a
        count to split ``devices`` (slots) evenly.
    heartbeat_timeout:
        Lease timeout: a host whose lease is older drops out of the live
        set. Detection latency is bounded by this.
    generation_timeout:
        Wall-clock budget for one generation dispatch (the fitness
        all-gather path); ``None`` disables the watchdog.
    snapshot_every:
        Cadence (generations) of leader snapshots, each recording the
        per-member fitness and member ids at manifest level.
    fault_injector:
        A :class:`~agilerl_tpu_torch.resilience.faults.FaultInjector` whose
        ``kill_host_at`` schedule is consulted at each generation boundary.
    restore_from:
        ``"best"`` (lost members come back as their best-fitness selves) or
        ``"latest"`` (the exact boundary state: with the kill on a snapshot
        boundary the whole stream equals an unkilled run's).
    """

    def __init__(
        self,
        engine,
        pop_size: int,
        store_dir: Union[str, Path],
        *,
        seed: int = 0,
        hosts: Optional[List[EmulatedHost]] = None,
        n_hosts: Optional[int] = None,
        devices: Optional[Sequence[Any]] = None,
        heartbeat_timeout: float = 2.0,
        membership_poll_interval: float = 0.02,
        generation_timeout: Optional[float] = None,
        snapshot_every: int = 1,
        keep_last: int = 3,
        keep_best: bool = True,
        max_dispatch_retries: int = 3,
        island: Optional[IslandConfig] = None,
        telemetry=None,
        fault_injector=None,
        max_members_per_device: Optional[int] = None,
        resize_tournament_size: int = 2,
        restore_from: str = "best",
        registry=None,
        clock=time.time,
        manager: Optional[CheckpointManager] = None,
        tracer=None,
        compile_cache=None,
    ):
        if restore_from not in ("best", "latest"):
            raise ValueError(f"restore_from must be 'best' or 'latest', got {restore_from!r}")
        if compile_cache is not None:
            raise NotImplementedError("compile_cache= is not ported yet: the port runs eagerly")
        self.engine = engine
        self.target_pop = int(pop_size)
        self.store_dir = Path(store_dir)
        self.telemetry = telemetry
        self.fault_injector = fault_injector
        self.island = island
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.membership_poll_interval = float(membership_poll_interval)
        self.generation_timeout = generation_timeout
        self.snapshot_every = int(snapshot_every)
        #: bound on recover-and-retry rounds within ONE generation: a
        #: generation_timeout below the real generation time must surface as
        #: an error, not livelock (each abandoned dispatch leaks its thread)
        self.max_dispatch_retries = max(int(max_dispatch_retries), 1)
        self.max_members_per_device = (None if max_members_per_device is None
                                       else int(max_members_per_device))
        self.resize_tournament_size = int(resize_tournament_size)
        self.restore_from = restore_from
        self._registry_override = registry
        self._tracer = tracer

        if hosts is None:
            hosts = make_emulated_hosts(n_hosts if n_hosts is not None else 1, devices)
        self.hosts = list(hosts)
        if not self.hosts or not any(h.alive for h in self.hosts):
            raise ValueError("need at least one live host")
        self._world = dist.get_world_size() if dist.is_available() and dist.is_initialized() \
            else 1
        self._pod = self._world > 1
        if self._pod:
            rank = dist.get_rank()
            if len(self.hosts) != 1 or self.hosts[0].host_id != rank or \
                    len(self.hosts[0].devices) != 1:
                raise ValueError("with a process group of several ranks each controller is one "
                                 f"rank's: hosts=[EmulatedHost({rank}, [slot])]")
            if island is not None:
                raise ValueError("island exchange runs on one-process controllers, not across "
                                 "the ranks of a process group")

        self.manager = manager or CheckpointManager(
            self.store_dir / "snapshots", keep_last=keep_last, keep_best=keep_best,
            registry=registry)
        self.membership = HeartbeatStore(
            self.store_dir / "membership", lease_timeout=self.heartbeat_timeout,
            registry=registry, clock=clock)
        self._heartbeat()
        self.membership.expect([h.host_id for h in self.hosts if h.alive])

        D = len(self._layout_slots())
        if self.target_pop % D != 0:
            raise ValueError(f"pop_size {self.target_pop} must be a multiple of the initial live "
                             f"device count {D} (zero-idle-devices layout)")

        dev = getattr(engine, "device", torch.device("cpu"))
        self._gen = torch.Generator(device=dev).manual_seed(int(seed))
        #: resize/tournament RNG: captured and restored by snapshots so
        #: shrink/grow decisions replay deterministically
        self._np_rng: np.random.Generator = np.random.default_rng(int(seed))
        self.pop: PyTree = self._local(engine.init_population(
            torch.Generator().manual_seed(int(seed)), self.target_pop))
        self.member_ids: List[int] = list(range(self.target_pop))
        self._next_member_id = self.target_pop
        self.fitness = np.full(self.target_pop, np.nan)
        self.generation = 0
        self.fitness_history: List[List[float]] = []
        self.member_id_history: List[List[int]] = []
        self._imported: Set[Tuple[str, str]] = set()
        self._gen_fn = None
        self._layout_devices: Tuple[Any, ...] = tuple(self._layout_slots())
        self._mesh = None
        self._plan = None
        self._mttr_started_at: Optional[float] = None
        self._mttr_pending = False

    # ------------------------------------------------------------------ #
    # topology / membership
    # ------------------------------------------------------------------ #
    @property
    def registry(self):
        if self._registry_override is not None:
            return self._registry_override
        from agilerl_tpu_torch.observability import get_registry

        return get_registry()

    @property
    def tracer(self):
        """Distributed tracer (construction-time override, else the process
        default, read lazily so late configuration still takes effect)."""
        if self._tracer is not None:
            return self._tracer
        from agilerl_tpu_torch.observability import get_tracer

        return get_tracer()

    def live_hosts(self) -> List[EmulatedHost]:
        return [h for h in self.hosts if h.alive]

    def live_devices(self) -> List[Any]:
        return [d for h in self.live_hosts() for d in h.devices]

    def _layout_slots(self) -> List[Any]:
        """The slots the population is laid over: the live ones, or in pod
        mode one per rank."""
        if self._pod:
            return [(r, 0) for r in range(self._world)]
        return self.live_devices()

    def layout(self) -> Dict[str, int]:
        """The current placement: live slots, population size and members
        per slot. ``pop % devices == 0`` always holds: zero idle slots."""
        D = max(len(self._layout_devices), 1)
        P = len(self.member_ids)
        return {"devices": D, "pop": P, "members_per_device": P // D}

    def _host(self, host_id: int) -> EmulatedHost:
        for h in self.hosts:
            if h.host_id == int(host_id):
                return h
        raise KeyError(f"unknown host {host_id}")

    def _heartbeat(self) -> None:
        for h in self.hosts:
            if h.alive:
                self.membership.beat(h.host_id, incarnation=h.incarnation)

    def _is_leader(self) -> bool:
        if self._pod:
            return dist.get_rank() == 0  # every rank of a live group is live
        leader = self.membership.leader()
        if leader is None:
            return True  # degenerate (all leases stale): act rather than wedge
        return any(h.host_id == leader for h in self.live_hosts())

    def kill_host(self, host_id: int, graceful: bool = False) -> None:
        """Emulate losing a host: it stops heartbeating (its lease expires
        within ``heartbeat_timeout``) and its slots leave the next layout.
        ``graceful=True`` also writes a tombstone so detection is immediate
        (the SIGTERM path)."""
        h = self._host(host_id)
        if not h.alive:
            return
        h.alive = False
        if graceful:
            self.membership.mark_dead(h.host_id)
        if self._mttr_started_at is None:
            self._mttr_started_at = time.perf_counter()
        self.registry.emit("host_killed", host=h.host_id, graceful=bool(graceful),
                           generation=self.generation)

    def revive_host(self, host_id: int) -> None:
        """Capacity returns: the host rejoins with a new incarnation; the
        next membership poll reports it as ``joined`` and the population
        grows back onto it."""
        h = self._host(host_id)
        if h.alive:
            return
        h.alive = True
        h.incarnation += 1
        self.membership.beat(h.host_id, incarnation=h.incarnation)

    # ------------------------------------------------------------------ #
    # the whole population and this rank's members
    # ------------------------------------------------------------------ #
    def _local(self, whole: PyTree) -> PyTree:
        """This rank's members of a whole population (pod mode), each leaf a
        tensor of its own; in one process the whole population."""
        if not self._pod:
            return whole
        P = int(tree_leaves(whole)[0].shape[0])
        if P % self._world != 0:
            raise ValueError(f"population {P} does not split over {self._world} ranks")
        n, r = P // self._world, dist.get_rank()
        return _copy_tree(member_slice(whole, r * n, (r + 1) * n))

    def _whole(self, local: PyTree) -> PyTree:
        """Every rank's members (a collective in pod mode, under the
        watchdog); in one process the population itself."""
        if not self._pod:
            return local
        from agilerl_tpu_torch.parallel.comm import all_gather_cat

        return call_with_collective_timeout(
            lambda: tree_map(lambda x: all_gather_cat(x, None, 0)
                             if isinstance(x, torch.Tensor) else x, local),
            self.generation_timeout, name="population-gather", registry=self.registry)

    # ------------------------------------------------------------------ #
    # plan re-layout
    # ------------------------------------------------------------------ #
    def _plan_for(self, n_devices: int):
        """A population plan for ``n_devices`` slots from the plan registry:
        recovery selects a smaller plan rather than hand-building specs; a
        missing size is registered once and reused."""
        from agilerl_tpu_torch.parallel import plan as PL

        candidates = [p for p in PL.plans_for_device_count(int(n_devices)) if "member" in p.rules]
        if candidates:
            return candidates[0]
        new = PL.make_population_plan(int(n_devices))
        try:
            return PL.register_plan(new)
        except ValueError:
            return PL.get_plan(new.name)

    def _rebuild_generation(self) -> None:
        slots = self._layout_slots()
        if not slots:
            raise MembershipChange("no live devices left — cannot re-form mesh")
        plan = self._plan_for(len(slots))
        if self._pod:
            from agilerl_tpu_torch.parallel.plan import resolve_plan_and_mesh

            plan, self._mesh = resolve_plan_and_mesh(plan, None, device=self.engine.device)
            gen_fn = self.engine.make_pod_generation(mesh=self._mesh, plan=plan)
        else:
            gen_fn = self.engine.make_vmap_generation()
        self._plan = plan
        self._layout_devices = tuple(slots)
        self._gen_fn = gen_fn
        reg = self.registry
        reg.gauge("elastic/live_hosts").set(len(self.live_hosts()) if not self._pod
                                            else self._world)
        reg.gauge("elastic/live_devices").set(len(slots))
        reg.gauge("elastic/members_per_device").set(len(self.member_ids) // len(slots))

    def _target_pop_for(self, n_devices: int) -> int:
        """Elastic layout policy: the largest multiple of the live slot
        count that does not exceed ``max(target_pop, D)`` (optionally capped
        by ``max_members_per_device``): capacity loss packs members tighter
        or shrinks the population; returned capacity grows it back."""
        D = int(n_devices)
        target = max(self.target_pop, D)
        if self.max_members_per_device is not None:
            target = min(target, D * self.max_members_per_device)
        return max((target // D) * D, D)

    # ------------------------------------------------------------------ #
    # recovery (one-process emulation)
    # ------------------------------------------------------------------ #
    def _await_stable_membership(self) -> MembershipEvent:
        """Wait (bounded) until the lease view agrees with the surviving
        hosts (dead leases expire within ``heartbeat_timeout``). Returns the
        accumulated membership diff."""
        want = tuple(sorted(h.host_id for h in self.live_hosts()))
        lost: Set[int] = set()
        joined: Set[int] = set()
        deadline = time.monotonic() + 3.0 * self.heartbeat_timeout + 5.0
        while True:
            self._heartbeat()
            event = self.membership.poll()
            if event is not None:
                lost.update(event.lost)
                joined.update(event.joined)
            alive_now = tuple(sorted(self.membership.alive()))
            if alive_now == want:
                break
            if time.monotonic() >= deadline:
                self.registry.warn_once(
                    "elastic:membership_settle_timeout",
                    f"membership did not settle to {want} within the deadline (saw "
                    f"{alive_now}) — recovering anyway")
                break
            time.sleep(self.membership_poll_interval)
        leader = min(want) if want else None
        return MembershipEvent(want, tuple(sorted(lost)), tuple(sorted(joined)), leader, {})

    def _dead_slots(self) -> List[int]:
        """Member rows that lived on now-dead slots under the layout the
        population was last placed with: with ``m`` members per slot, slot
        ``d`` owns rows ``[d*m, (d+1)*m)``."""
        old = self._layout_devices
        if not old:
            return []
        live = set(self.live_devices())
        P = len(self.member_ids)
        m = max(P // len(old), 1)
        return [i for i in range(P) if old[min(i // m, len(old) - 1)] not in live]

    def _handle_membership_change(self, dispatch_failed: bool = False) -> None:
        if self._mttr_started_at is None:
            self._mttr_started_at = time.perf_counter()
        event = self._await_stable_membership()
        if dispatch_failed:
            # the generation in flight was abandoned: its outputs are
            # discarded (the dispatch is pure). Roll back to the last
            # committed snapshot so every survivor restarts from the same
            # bytes; with none, continue from the in-memory boundary state
            if not self.resume():
                self.registry.warn_once(
                    "elastic:dispatch_failed_no_snapshot",
                    "generation dispatch timed out before any snapshot was committed — "
                    "continuing from the in-memory boundary state")
        self._recover(event)

    def _recover(self, event: MembershipEvent) -> None:
        t0 = time.perf_counter()
        reg = self.registry
        # always traced (force): host loss is recorded as an error-status
        # span although the recovery itself succeeds
        with self.tracer.span("elastic.recovery", force=True, generation=self.generation,
                              lost=list(event.lost), joined=list(event.joined)) as rsp:
            if event.lost:
                rsp.set_error(f"host loss: {sorted(event.lost)}")
            if not self.live_devices():
                raise MembershipChange("all hosts lost — no live devices to re-form the mesh",
                                       lost=event.lost, alive=event.alive)
            dead_slots = self._dead_slots()
            restored = self._restore_slots(dead_slots) if dead_slots else 0
            P = len(self.member_ids)
            target = self._target_pop_for(len(self.live_devices()))
            if target < P:
                self._shrink_to(target)
            elif target > P:
                self._grow_to(target)
            self._rebuild_generation()
            dt = time.perf_counter() - t0
            rsp.set_attributes(restored=restored, recovery_time_s=dt)
        reg.counter("resilience/recoveries_total").inc()
        reg.gauge("resilience/recovery_time_s").set(dt)
        reg.counter("elastic/members_restored_total").inc(restored)
        reg.emit("elastic_recovery", generation=self.generation, lost=list(event.lost),
                 joined=list(event.joined), leader=event.leader, dead_slots=dead_slots,
                 restored=restored, layout=self.layout(), recovery_time_s=dt)
        self._mttr_pending = True

    def _restore_slots(self, dead_slots: List[int]) -> int:
        """Splice the lost members' rows back from a snapshot (manifest-level
        member ids locate each row; a member born after the snapshot gets the
        snapshot's best member instead)."""
        reg = self.registry
        loaded = None
        if self.restore_from == "best":
            # best() does not validate and load(info) tries only that one: a
            # corrupt best snapshot falls through to the validated walk
            best = self.manager.best()
            if best is not None:
                loaded = self.manager.load(best)
        if loaded is None:
            loaded = self.manager.load()  # newest-first, hash-validated walk
        if loaded is None:
            reg.warn_once(
                "elastic:no_snapshot_for_restore",
                "host loss before any committed snapshot — lost members are re-initialized "
                "fresh, not restored")
            seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=self._gen,
                                     device=self._gen.device).item())
            fresh = self.engine.init_population(seed, len(dead_slots))
            rows = {slot: row for row, slot in enumerate(dead_slots)}
            self.pop = _splice_rows(self.pop, population_state_dict(fresh)["leaves"], rows)
            for slot in dead_slots:
                self.member_ids[slot] = self._new_member_id()
                self.fitness[slot] = np.nan
            reg.counter("elastic/members_reinitialized_total").inc(len(dead_slots))
            return 0
        info, entries = loaded
        blob = entries["population"]
        snap_state = entries.get("elastic", {})
        snap_ids = info.member_ids or snap_state.get("member_ids") or []
        snap_fit = info.member_fitness or snap_state.get("fitness") or []
        row_of = {int(mid): row for row, mid in enumerate(snap_ids)}
        best_row = info.best_member_index()
        slot_to_row: Dict[int, int] = {}
        for slot in dead_slots:
            row = row_of.get(self.member_ids[slot])
            if row is None:
                # unknown lineage (clone/import born after the snapshot):
                # the snapshot's best member takes its place
                row = best_row if best_row is not None else 0
                old_id = self.member_ids[slot]
                self.member_ids[slot] = self._new_member_id()
                reg.emit("elastic_lineage", op="restore_best", slot=slot,
                         previous_member=old_id, member=self.member_ids[slot],
                         snapshot=str(info.path.name), row=row)
            slot_to_row[slot] = int(row)
        self.pop = _splice_rows(self.pop, blob["leaves"], slot_to_row)
        for slot, row in slot_to_row.items():
            f = snap_fit[row] if row < len(snap_fit) else None
            self.fitness[slot] = np.nan if f is None else float(f)
        reg.emit("elastic_restore", snapshot=str(info.path.name), step=info.step,
                 slots={s: r for s, r in slot_to_row.items()})
        return len(slot_to_row)

    # ------------------------------------------------------------------ #
    # elastic resize
    # ------------------------------------------------------------------ #
    def _new_member_id(self) -> int:
        mid = self._next_member_id
        self._next_member_id += 1
        return mid

    def _lineage(self):
        if self.telemetry is not None:
            return getattr(self.telemetry, "lineage", None)
        return None

    def _shrink_to(self, n: int) -> None:
        with self.tracer.span("elastic.resize", op="shrink", generation=self.generation):
            self._shrink_to_impl(n)

    def _shrink_to_impl(self, n: int) -> None:
        P = len(self.member_ids)
        k = P - int(n)
        fit = np.nan_to_num(self.fitness, nan=-np.inf)
        # evict the k worst; ties evict the YOUNGER slot (higher index)
        order = np.lexsort((-np.arange(P), fit))
        evict = sorted(int(i) for i in order[:k])
        keep = [i for i in range(P) if i not in set(evict)]
        evicted_ids = [self.member_ids[i] for i in evict]
        evicted_fit = [float(self.fitness[i]) for i in evict]
        self.pop = _rows(self.pop, keep)
        self.member_ids = [self.member_ids[i] for i in keep]
        self.fitness = self.fitness[np.asarray(keep)]
        reg = self.registry
        reg.counter("elastic/members_evicted_total").inc(k)
        for mid, f in zip(evicted_ids, evicted_fit):
            reg.emit("elastic_lineage", op="evict", member=mid,
                     fitness=None if not np.isfinite(f) else f, generation=self.generation)
        reg.emit("elastic_resize", op="shrink", generation=self.generation,
                 evicted=evicted_ids, pop=len(self.member_ids))

    def _grow_to(self, n: int) -> None:
        with self.tracer.span("elastic.resize", op="grow", generation=self.generation):
            self._grow_to_impl(n)

    def _grow_to_impl(self, n: int) -> None:
        P = len(self.member_ids)
        k = int(n) - P
        fit = np.nan_to_num(self.fitness, nan=-np.inf)
        reg = self.registry
        lineage = self._lineage()
        tr = self.tracer
        clones: List[PyTree] = []
        clone_records = []
        for _ in range(k):
            with tr.span("elastic.tournament", size=min(self.resize_tournament_size, P)):
                entrants = self._np_rng.choice(P, size=min(self.resize_tournament_size, P),
                                               replace=False)
                parent = int(entrants[int(np.argmax(fit[entrants]))])
            with tr.span("elastic.mutation", parent_member=self.member_ids[parent]):
                clones.append(self._mutate_clone(_rows(self.pop, [parent])))
            child_id = self._new_member_id()
            clone_records.append((self.member_ids[parent], child_id,
                                  float(self.fitness[parent])))
            self.member_ids.append(child_id)
        if clones:
            self.pop = _concat(self.pop, *clones)
            self.fitness = np.concatenate([self.fitness, [pf for _, _, pf in clone_records]])
        reg.counter("elastic/members_cloned_total").inc(k)
        for parent_id, child_id, parent_fit in clone_records:
            if lineage is not None:
                lineage.record_selection(parent_id, child_id, parent_fit)
                lineage.record_mutation(child_id, "elastic_clone")
            reg.emit("elastic_lineage", op="clone", parent=parent_id, member=child_id,
                     generation=self.generation)
        reg.emit("elastic_resize", op="grow", generation=self.generation,
                 cloned=[c for _, c, _ in clone_records], pop=len(self.member_ids))

    def _mutate_clone(self, member: PyTree) -> PyTree:
        """Gaussian-mutate a cloned member (engine-aware: the scan tier
        mutates its learner's ``_mutate_fields`` and starts a fresh
        fitness segment, actor-critic members mutate the actor), with the
        noise drawn from the controller's generator."""
        sd = float(getattr(self.engine, "mutation_sd", 0.02))

        def mutate(tree):
            on = torch.ones(1, device=tree_leaves(tree)[0].device)
            return gaussian_mutate(tree, mutation_noise(tree, self._gen), on, sd)

        if hasattr(member, "learner"):
            fields = getattr(self.engine, "_mutate_fields", ("params",))
            member = member._replace(learner=member.learner._replace(
                **{f: mutate(getattr(member.learner, f)) for f in fields}))
            if hasattr(member, "ep_ret"):
                # scan-tier fitness is segmented at evolution boundaries: a
                # clone must not inherit the parent's partial returns
                member = member._replace(ep_ret=torch.zeros_like(member.ep_ret))
        elif hasattr(member, "actor"):
            member = member._replace(actor=mutate(member.actor))
        return member

    # ------------------------------------------------------------------ #
    # snapshots
    # ------------------------------------------------------------------ #
    def save_snapshot(self, kind: str = "cadence") -> Optional[Path]:
        """Commit the whole population and the controller's state. In pod
        mode every rank joins the rows' all-gather and the leader commits
        (the others return None)."""
        whole = self._whole(self.pop)
        if self._pod and not self._is_leader():
            return None
        entries = {
            "population": population_state_dict(whole),
            "elastic": {
                "member_ids": list(self.member_ids),
                "next_member_id": self._next_member_id,
                "generation": self.generation,
                "fitness": [float(f) for f in self.fitness],
                "fitness_history": [list(r) for r in self.fitness_history],
                "member_id_history": [list(r) for r in self.member_id_history],
                "key": generator_to_host(self._gen),
                "np_rng": self._np_rng.bit_generator.state,
                "target_pop": self.target_pop,
                "imported": sorted(self._imported),
            },
        }
        return self.manager.save(entries, step=self.generation, kind=kind,
                                 member_fitness=self.fitness, member_ids=self.member_ids)

    def resume(self) -> bool:
        """Restore the controller (population, the generator, the resize
        RNG, histories) from the latest complete snapshot. Returns False
        when none exists (fresh start). In pod mode each rank keeps its
        members of the snapshot's population."""
        loaded = self.manager.load()
        if loaded is None:
            return False
        info, entries = loaded
        st = entries["elastic"]
        P = len(st["member_ids"])
        # a template of the snapshot's whole population (its values are
        # overwritten by the restore)
        template = self.pop if (P == len(self.member_ids) and not self._pod) else \
            self.engine.init_population(torch.Generator().manual_seed(0), P)
        self.pop = self._local(population_load_state_dict(template, entries["population"]))
        self.member_ids = [int(i) for i in st["member_ids"]]
        self._next_member_id = int(st["next_member_id"])
        self.generation = int(st["generation"])
        self.fitness = np.asarray(st["fitness"], dtype=float)
        self.fitness_history = [list(r) for r in st["fitness_history"]]
        self.member_id_history = [list(r) for r in st["member_id_history"]]
        generator_from_host(self._gen, st["key"])
        self._np_rng = restore_np_generator(st["np_rng"])
        self.target_pop = int(st.get("target_pop", self.target_pop))
        self._imported = {tuple(t) for t in st.get("imported", [])}
        self._gen_fn = None  # the slot set may differ: rebuilt lazily
        self.registry.emit("elastic_resume", step=info.step, snapshot=str(info.path.name), pop=P)
        return True

    # ------------------------------------------------------------------ #
    # island migration
    # ------------------------------------------------------------------ #
    def _island_dir(self, island_id: str) -> Path:
        return self.island.exchange_dir / f"island_{island_id}"

    def _export_island(self) -> Optional[Path]:
        cfg = self.island
        P = len(self.member_ids)
        k = min(cfg.top_k, P)
        fit = np.nan_to_num(self.fitness, nan=-np.inf)
        idx = np.argsort(fit)[::-1][:k]
        leaves = [np.asarray(s)[idx] if isinstance(live, torch.Tensor) else np.asarray(s)
                  for live, s in zip(tree_leaves(self.pop),
                                     population_state_dict(self.pop)["leaves"])]
        dest = publish_entry(
            self._island_dir(cfg.island_id), f"{_EXPORT_PREFIX}{self.generation:08d}",
            {"leaves": leaves}, payload_name="members.pkl", sha_key="sha256",
            manifest_extra={
                "island": cfg.island_id,
                "generation": self.generation,
                "members": int(k),
                "member_ids": [int(self.member_ids[i]) for i in idx],
                "fitness": [float(self.fitness[i]) if np.isfinite(self.fitness[i]) else None
                            for i in idx],
            })
        gc_entries(dest.parent, _EXPORT_PREFIX, cfg.keep_exports)
        reg = self.registry
        reg.counter("elastic/migrations_exported_total").inc()
        reg.emit("island_export", island=cfg.island_id, generation=self.generation,
                 members=int(k), path=str(dest))
        return dest

    def _import_islands(self) -> int:
        cfg = self.island
        root = cfg.exchange_dir
        if not root.is_dir():
            return 0
        reg = self.registry
        lineage = self._lineage()
        imported = 0
        my_dir = f"island_{cfg.island_id}"
        for d in sorted(root.iterdir()):
            if not d.is_dir() or d.name == my_dir or not d.name.startswith("island_"):
                continue
            exports = sorted(
                (e for e in d.iterdir()
                 if e.is_dir() and e.name.startswith(_EXPORT_PREFIX)
                 and not e.name.endswith(TMP_DIR_SUFFIX)),
                # the GC's parser: the GC and the import walk rank alike
                key=lambda e: -1 if entry_seq(e.name) is None else entry_seq(e.name))
            if not exports:
                continue
            latest = exports[-1]
            tag = (d.name, latest.name)
            if tag in self._imported:
                continue
            try:
                manifest = read_manifest(latest)
            except CorruptSnapshotError:
                continue  # unreadable manifest: treat as not yet committed
            try:
                payload = load_validated_pickle(latest / "members.pkl", manifest.get("sha256"))
            except CorruptSnapshotError as e:
                # refusal-safe import: a torn export is skipped with a warn
                self._imported.add(tag)
                reg.counter("elastic/torn_imports_total").inc()
                reg.warn_once(f"elastic:torn_island_export:{d.name}/{latest.name}",
                              f"island export {d.name}/{latest.name} failed hash validation "
                              f"({e}) — skipping it")
                continue
            self._imported.add(tag)
            local_leaves = tree_leaves(self.pop)
            foreign = payload.get("leaves", [])
            if len(foreign) != len(local_leaves) or any(
                    isinstance(l, torch.Tensor) and tuple(np.shape(f)[1:]) != tuple(l.shape[1:])
                    for f, l in zip(foreign, local_leaves)):
                reg.warn_once(f"elastic:island_shape_mismatch:{d.name}",
                              f"island {d.name} exports members of a different structure — "
                              "skipping (engines must match across islands)")
                continue
            fitness = manifest.get("fitness") or []
            ids = manifest.get("member_ids") or []
            order = sorted(range(len(fitness)),
                           key=lambda r: -np.inf if fitness[r] is None else fitness[r],
                           reverse=True)
            for row in order:
                f = fitness[row]
                if f is None:
                    continue
                local = np.nan_to_num(self.fitness, nan=-np.inf)
                worst = int(np.argmin(local))
                if not f > local[worst]:
                    break  # descending order: nothing further can beat us
                old_id = self.member_ids[worst]
                self.pop = _splice_rows(self.pop, foreign, {worst: row})
                self.fitness[worst] = float(f)
                child_id = self._new_member_id()
                self.member_ids[worst] = child_id
                parent_id = int(ids[row]) if row < len(ids) else -1
                if lineage is not None:
                    lineage.record_selection(parent_id, child_id, float(f))
                    lineage.record_mutation(child_id, f"migrate:{d.name}")
                reg.emit("elastic_lineage", op="migrate", member=child_id, evicted=old_id,
                         source_island=d.name, source_member=parent_id, fitness=float(f),
                         generation=self.generation)
                imported += 1
        if imported:
            reg.counter("elastic/migrations_imported_total").inc(imported)
        return imported

    # ------------------------------------------------------------------ #
    # the generation loop
    # ------------------------------------------------------------------ #
    def _dispatch(self):
        """Runs inside the collective watchdog thread: reads the boundary
        state and changes nothing on the controller (a copy of the members
        and of the generator go in). The caller commits the returned
        ``(pop, generator state, fitness)`` only after a successful join."""
        gen = _copy_generator(self._gen)
        pop, fitness = self._gen_fn(_copy_tree(self.pop), gen)
        return pop, gen.get_state(), fitness.detach().cpu().numpy()

    def step_generation(self) -> np.ndarray:
        """One elastic generation: scripted-fault check -> heartbeat ->
        membership detection (+ recovery) -> generation dispatch under the
        collective watchdog -> snapshot + island exchange. Each boundary is
        one ``elastic.generation`` trace with the dispatch / resize /
        tournament / mutation / snapshot / island phases as child spans and
        host-loss recovery as a forced error-status span."""
        with self.tracer.span("elastic.generation", generation=self.generation,
                              pop=len(self.member_ids)):
            return self._step_generation_impl()

    def _detect(self) -> None:
        """The one-process emulation's detection at a boundary."""
        reg = self.registry
        if self.fault_injector is not None:
            victim = self.fault_injector.host_to_kill(self.generation)
            if victim is not None:
                self.kill_host(victim)
        self._heartbeat()
        # a dead host still inside the current layout means the next fitness
        # all-gather would hang on a real pod: surface it as the bounded
        # collective timeout (the watchdog's counter) and recover
        dead_in_layout = [h for h in self.hosts
                          if not h.alive and any(d in self._layout_devices for d in h.devices)]
        if dead_in_layout:
            reg.counter("resilience/collective_timeouts_total").inc()
            reg.emit("collective_timeout", name="fitness-all-gather", emulated=True,
                     hosts=[h.host_id for h in dead_in_layout])
            self._handle_membership_change()
        else:
            event = self.membership.poll()
            if event is not None and (event.lost or event.joined):
                self._handle_membership_change()

    def _step_generation_impl(self) -> np.ndarray:
        reg = self.registry
        if self._pod:
            self._heartbeat()
        else:
            self._detect()
        t0 = time.perf_counter()
        for attempt in range(self.max_dispatch_retries + 1):
            if self._gen_fn is None:
                self._rebuild_generation()
            try:
                with self.tracer.span("elastic.dispatch", attempt=attempt):
                    pop, gen_state, fitness = call_with_collective_timeout(
                        self._dispatch, self.generation_timeout, name="fitness-all-gather",
                        registry=reg)
                self.pop = pop
                self._gen.set_state(gen_state)
                break
            except MembershipChange:
                if self._pod:
                    # the group is broken: a new one and resume() recover
                    raise
                if attempt >= self.max_dispatch_retries:
                    raise MembershipChange(
                        f"generation dispatch failed {self.max_dispatch_retries + 1} times in a "
                        "row — generation_timeout is likely below the real generation time, or "
                        "the pod cannot stabilize")
                self._handle_membership_change(dispatch_failed=True)
        dt = time.perf_counter() - t0
        self.generation += 1
        self.fitness = fitness.astype(float)
        self.fitness_history.append([float(f) for f in fitness])
        self.member_id_history.append(list(self.member_ids))
        reg.gauge("elastic/population_size").set(len(self.member_ids))
        if self._mttr_pending and self._mttr_started_at is not None:
            # MTTR: kill/detection -> first COMPLETED post-recovery generation
            mttr = time.perf_counter() - self._mttr_started_at
            reg.gauge("elastic/mttr_s").set(mttr)
            reg.emit("elastic_mttr", mttr_s=mttr, generation=self.generation)
            self._mttr_pending = False
            self._mttr_started_at = None
        if self.telemetry is not None:
            espg = getattr(self.engine, "env_steps_per_generation", None)
            if espg is None:
                espg = getattr(self.engine, "num_envs", 0) * getattr(self.engine, "rollout_len", 0)
            self.telemetry.step(env_steps=int(espg) * len(self.member_ids), metrics={
                "fitness_best": float(np.nanmax(self.fitness)),
                "fitness_mean": float(np.nanmean(self.fitness)),
                "generation_time_s": dt,
                "population_size": len(self.member_ids),
            })
        if self.snapshot_every and self.generation % self.snapshot_every == 0 and \
                (self._pod or self._is_leader()):
            with self.tracer.span("elastic.snapshot", generation=self.generation):
                self.save_snapshot()
        if self.island is not None and self.island.every and \
                self.generation % self.island.every == 0:
            with self.tracer.span("elastic.island_exchange", generation=self.generation):
                if self._is_leader():
                    self._export_island()
                self._import_islands()
        return fitness

    def run(self, generations: int) -> List[List[float]]:
        """Run N generations; returns this call's fitness rows (ragged
        across resizes; also appended to ``fitness_history``)."""
        return [[float(f) for f in self.step_generation()] for _ in range(int(generations))]


def _splice_rows(pop: PyTree, saved_leaves: Sequence[np.ndarray],
                 slot_to_row: Dict[int, int]) -> PyTree:
    """Overwrite population rows ``slot`` with ``saved_leaves`` rows ``row``
    (leaf order is ``tree_leaves``', as ``population_state_dict`` stores
    it); a leaf that is not a tensor (a host value, the same for every
    member) is kept. The leaf count and the row shapes are checked: a
    structure mismatch fails loudly instead of corrupting members."""
    live = tree_leaves(pop)
    if len(saved_leaves) != len(live):
        raise ValueError(f"snapshot has {len(saved_leaves)} leaves, live population has "
                         f"{len(live)}")
    out = []
    for leaf, s in zip(live, saved_leaves):
        if not isinstance(leaf, torch.Tensor):
            out.append(leaf)
            continue
        s = np.asarray(s)
        if tuple(s.shape[1:]) != tuple(leaf.shape[1:]):
            raise ValueError(f"snapshot member row shape {s.shape[1:]} != live "
                             f"{tuple(leaf.shape[1:])}")
        arr = leaf.clone()
        for slot, row in slot_to_row.items():
            arr[slot] = torch.from_numpy(np.array(s[row])).to(device=arr.device, dtype=arr.dtype)
        out.append(arr)
    it = iter(out)
    return tree_map(lambda _: next(it), pop)
