"""Serving fleet: N data-parallel replicas behind a prefix-affinity router,
with opt-in prefill/decode disaggregation and elastic membership. The port of
``agilerl_tpu/llm/fleet.py``.

- **Replicas**: each a :class:`~agilerl_tpu_torch.llm.serving
  .ContinuousGenerator` on the fleet's device. Every replica reads the
  weight trees the caller passes to :meth:`ServingFleet.step`, so the
  replicas on one card share ONE copy of the base weights; each owns only
  its paged KV pool.
- **Router**: :class:`~agilerl_tpu_torch.llm.router.FleetRouter` dispatches
  on the queue-depth telemetry with prefix affinity: repeats of a prompt's
  block-hash chain route to the replica whose
  :class:`~agilerl_tpu_torch.llm.serving.BlockAllocator` owns the cached
  blocks, falling back to least-loaded.
- **Disaggregation** (opt-in): ``topology="disaggregated"`` runs cold
  prompts through dedicated :class:`PrefillWorker`\\ s (the SAME
  ``prefill_head`` maths at the same cache extent and the same per-slot
  counter key, so an imported request decodes the tokens a local prefill
  would) and hands the prompt KV to a decode replica through an atomic
  export/import transfer (:class:`KVTransferStore`: torn transfers are
  skipped and recomputed, never loaded). Transfers hold host numpy only (a
  bf16 KV as its ``uint16`` bit pattern, ``llm/convert.tensor_to_host``),
  so a process without a card can read them. Warm chains skip prefill and
  go straight to the replica that owns their cached blocks.
- **Elasticity**: replica membership is heartbeat leases through
  :class:`~agilerl_tpu_torch.resilience.membership.HeartbeatStore`. A
  replica whose lease expires is detected as a bounded timeout: its queued
  and in-flight requests are re-dispatched to survivors, replaying from
  their original tokens and key, so outputs stay token-for-token identical.
  ``scale_up()`` spawns a fresh replica that joins the lease set.

The fleet is host-side composition only: every device program belongs to a
replica or worker, so the fleet's program set is bounded by (members x
bucket grid), constant in request count and routing order.

``sharding_plan=`` is the layout every spawned member serves under (a
``parallel/plan.ShardingPlan`` or a registered name; see
``llm/serving.py``), and ``scale_up(plan=...)`` spawns one member under
another plan, or with ``plan="auto"`` under the first registered plan that
fills the live device count (``plans_for_device_count``).
``device=None`` means the card and raises without one.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from agilerl_tpu_torch import observability
from agilerl_tpu_torch.llm import model as M
from agilerl_tpu_torch.llm.convert import tensor_to_host
from agilerl_tpu_torch.llm.generate import fold_in, left_pad, prefill_head, request_key
from agilerl_tpu_torch.llm.router import FleetRouter
from agilerl_tpu_torch.llm.serving import (
    AdmissionPolicy,
    ContinuousGenerator,
    _PlanPlacement,
    _raw_key,
    _resolve_serving_plan,
    _round_up,
    _sampling_knobs,
    chain_hashes,
)
from agilerl_tpu_torch.observability import MetricsRegistry
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.resilience.membership import HeartbeatStore
from agilerl_tpu_torch.resilience.store import CommitDirStore

#: lease roles a fleet member records in its heartbeat metadata
ROLE_UNIFIED = "unified"
ROLE_PREFILL = "prefill"
ROLE_DECODE = "decode"

#: scale_up() wall-time buckets (s)
SCALE_UP_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0,
                    5.0, 10.0, 30.0, 60.0, 120.0, 300.0)


class PrefillWorker(_PlanPlacement):
    """Prefill-only worker for the disaggregated topology.

    Runs the SHARED ``prefill_head`` at B = 1 and the SAME dense cache
    extent a decode replica's local prefill uses (prompt bucket + whole
    decode chunks), with the request's raw counter key ``(seed, counter)``,
    so the exported prompt KV, first token and advanced key are what the
    decode replica would have computed itself: the token-for-token contract
    of the transfer. One program signature per (prompt bucket, greedy,
    adapter present), like the replica prefill it replaces."""

    def __init__(
        self,
        config: M.GPTConfig,
        max_new_tokens: int = 64,
        pad_id: int = 0,
        eos_id: Optional[int] = None,
        prompt_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
        block_size: int = 32,
        decode_chunk: int = 32,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        min_new_tokens: Optional[int] = None,
        lora_scale: float = 2.0,
        metrics=None,
        sharding_plan=None,
        mesh=None,
        device: DeviceLike = None,
    ):
        self.dev = resolve_device(device)
        self.sharding_plan, self.mesh = _resolve_serving_plan(sharding_plan, mesh, self.dev)
        self.config = config
        self.metrics = metrics if metrics is not None else observability.get_registry()
        self.pad_id = int(pad_id)
        self.eos_id = eos_id
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.block_size = int(block_size)
        self.decode_chunk = min(int(decode_chunk), int(max_new_tokens))
        self.n_chunks = -(-int(max_new_tokens) // self.decode_chunk)
        self.max_new_tokens = int(max_new_tokens)
        # the decode replica's per-slot cache extent: prefill MUST run at
        # the same extent for chunked-attention parity (see serving.
        # ContinuousGenerator._prefill_admit)
        self._decode_extent = self.n_chunks * self.decode_chunk
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_new_tokens = min_new_tokens
        self.lora_scale = lora_scale
        self._programs = set()

    @classmethod
    def matching(cls, gen: ContinuousGenerator, metrics=None, sharding_plan=None,
                 mesh=None) -> "PrefillWorker":
        """A worker whose bucket grid, decode sizing, sampling recipe and
        device match ``gen``: the only configuration under which its exports
        are admissible on that replica."""
        return cls(
            gen.config, max_new_tokens=gen.max_new_tokens, pad_id=gen.pad_id,
            eos_id=gen.eos_id, prompt_buckets=gen.prompt_buckets,
            block_size=gen.block_size, decode_chunk=gen.decode_chunk,
            temperature=gen.temperature, top_k=gen.top_k, top_p=gen.top_p,
            min_new_tokens=gen.min_new_tokens, lora_scale=gen.lora_scale,
            metrics=metrics, sharding_plan=sharding_plan, mesh=mesh, device=gen.dev,
        )

    def _knobs(self, greedy: bool, lora) -> Dict[str, Any]:
        return _sampling_knobs(self, greedy, lora)

    @torch.no_grad()
    def _prefill_impl(self, params, lora, prompt, prompt_mask, key, greedy):
        Pb = prompt.shape[1]
        self._programs.add(("prefill", Pb, bool(greedy), lora is None))
        dense = self._kv("kv", lambda d: M.init_caches(
            self.config, 1, Pb + self._decode_extent, device=d))
        carry, _, last_logits = prefill_head(
            self.config, params, prompt, prompt_mask, dense, key[None],
            return_logits=True, **self._knobs(greedy, lora))
        filled, tok0, _rv, _pos, done0, key_next = carry
        # raw log p(tok0) ships with every payload (negligible next to the
        # prompt KV) so a capture_logprobs replica's imported stream stays
        # aligned (ContinuousGenerator._record_lp0)
        lp0 = torch.log_softmax(last_logits, dim=-1)[0, tok0[0].long()]
        # under a plan each rank exports its own KV heads (the row is whole
        # on every rank: one row does not tile the data axes)
        k, v = (M.local_shard(t)[:, 0, :Pb] for t in (filled.k, filled.v))
        return k, v, tok0[0], done0[0], key_next[0], lp0, M.kv_head_range(filled.k)

    def prefill(self, tokens, key, params, lora=None, greedy: bool = False,
                hashes: Optional[List[bytes]] = None) -> Dict[str, Any]:
        """Prefill one prompt; returns the transfer payload (prompt KV
        ``[L, Pb, KV, hd]`` in ``tensor_to_host`` form, the KV heads
        ``kv_heads`` = ``[lo, hi)`` it holds (under a plan, this rank's shard
        of them: a handoff between ranks of the same plan moves each rank's
        shard), first token, EOS state, advanced counter key, lp0 and the
        block-hash chain) as host
        values ready for :meth:`KVTransferStore.export`. ``key`` is the request's raw counter
        key. ``hashes`` skips the re-hash when the router already chained
        this prompt at the same layout."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0 or tokens.size > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt of {tokens.size} tokens outside the bucket grid "
                f"(1..{self.prompt_buckets[-1]})")
        Pb = _round_up(tokens.size, self.prompt_buckets)
        toks_row, mask_row = left_pad([tokens], self.pad_id, Pb)
        t0 = time.perf_counter()
        k, v, tok0, done0, key_next, lp0, kv_heads = self._prefill_impl(
            params, lora, torch.tensor(toks_row, device=self.dev),
            torch.tensor(mask_row, device=self.dev),
            torch.tensor(np.asarray(key, np.int64).reshape(2), device=self.dev), greedy)
        payload = dict(
            tokens=tokens,
            k=tensor_to_host(k)[0], v=tensor_to_host(v)[0],
            tok0=int(tok0), done0=bool(done0),
            key_next=key_next.cpu().numpy().astype(np.int64),
            lp0=float(lp0),
            kv_heads=kv_heads,
            hashes=(list(hashes) if hashes is not None else
                    chain_hashes(toks_row[0], mask_row[0], self.block_size)),
        )
        self.metrics.counter("fleet/prefills_total",
                             help="prompts prefilled by workers").inc()
        self.metrics.histogram("fleet/prefill_s").observe(
            time.perf_counter() - t0)
        return payload

    @property
    def compiled_programs(self) -> int:
        """One prefill program per (prompt bucket, greedy, adapter) touched."""
        return len(self._programs)


class KVTransferStore:
    """Atomic prefill->decode KV handoff through a shared directory.

    A thin wrapper over the generic commit-dir entry store
    (:class:`~agilerl_tpu.resilience.store.CommitDirStore` — the same
    publish/sha-validate/skip-torn discipline island migration and the
    flywheel's weight/trajectory stores share). A reader either sees a
    complete, hash-valid transfer or nothing; torn/corrupt transfers are
    skipped with a warning (``fleet/torn_kv_transfers_total``) and NEVER
    loaded — the request is recomputed from its tokens instead, so a bad
    transfer can cost latency but never wrong tokens."""

    def __init__(self, directory: Union[str, Path], metrics=None,
                 tracer=None):
        self._store = CommitDirStore(
            directory,
            torn_counter="fleet/torn_kv_transfers_total",
            torn_help="KV transfers skipped as torn/corrupt",
            warn_prefix="torn-kv-transfer",
            metrics=metrics,
            tracer=tracer,
        )
        self.directory = self._store.directory
        self.metrics = self._store.metrics

    def export(self, name: str, payload: Dict[str, Any]) -> Path:
        """Atomically publish one transfer; returns the committed path. The
        manifest carries the block-hash chain (routing provenance) and the
        exporting span's trace context — both readable without unpickling
        the KV payload, so cross-process spans stitch off the manifest."""
        extra: Dict[str, Any] = {
            "hashes": [h.hex() for h in payload.get("hashes", [])],
        }
        if payload.get("trace") is not None:
            extra["trace"] = payload["trace"]
        final = self._store.publish(name, payload, manifest_extra=extra)
        self.metrics.counter("fleet/kv_transfers_total",
                             help="prefill->decode KV transfers "
                                  "exported").inc()
        return final

    def load(self, path: Union[str, Path]) -> Optional[Dict[str, Any]]:
        """Hash-validated import; returns None (after counting + warning)
        for a torn, truncated, or corrupt transfer — the skip-and-recompute
        contract."""
        return self._store.load(path)

    def consume(self, path: Union[str, Path]) -> None:
        """Delete an imported (or torn) transfer directory."""
        self._store.consume(path)


@dataclasses.dataclass
class _FleetRequest:
    """One fleet-level request across its whole lifecycle (the re-dispatch
    unit: everything needed to replay it from scratch on a survivor)."""

    ticket: int
    tokens: np.ndarray
    key: np.ndarray
    max_new: Optional[int]
    hashes: List[bytes]
    arrival_s: float
    rid: Optional[int] = None            # serving replica currently assigned
    replica_ticket: Optional[int] = None
    stage: str = "new"   # new|prefill_queue|transfer|decoding|done
    transfer: Optional[Path] = None
    dispatches: int = 0
    #: root span of the request's trace (submit → ... → result) — manual
    #: lifecycle, ended when the result is harvested
    span: Any = None
    #: the span covering the CURRENT decode dispatch; ended ok at finish,
    #: ended with error status when the owning replica is lost
    decode_span: Any = None


@dataclasses.dataclass
class _Member:
    """One fleet member (serving replica or prefill worker) plus the
    fleet's belief about it. ``killed`` emulates host loss (the member
    stops beating and stepping); ``alive`` flips only when the loss is
    DETECTED (lease expiry or immediate, without a heartbeat store).

    Decode/unified replicas model the detection gap faithfully: until the
    loss is detected the router may still assign work to a killed replica,
    exactly as a real router would to a host that died a moment ago, and
    that work is re-dispatched at detection. Prefill workers are skipped by
    ground-truth ``killed`` instead: prefill assignment is synchronous
    inside one ``_step_prefill`` call (the pending queue is fleet-owned),
    so there is no in-flight state a dead worker could strand — the gap
    the decode model exists to exercise cannot occur there."""

    rid: int
    role: str
    gen: Any
    alive: bool = True
    killed: bool = False
    #: replica ticket -> fleet ticket (serving members only)
    tickets: Dict[int, int] = dataclasses.field(default_factory=dict)


class ServingFleet:
    """N data-parallel serving replicas behind a prefix-affinity router.

    Drive it like a single :class:`ContinuousGenerator`: ``submit()`` /
    ``step()`` / ``result()`` / ``run_until_drained()`` / ``generate()``,
    from ONE scheduler thread. Each replica keeps its own
    :class:`MetricsRegistry` (so :meth:`latency_summary` can report per-
    replica SLOs); fleet-level counters and router decisions land in the
    fleet's registry / JSONL sink.

    ``topology="disaggregated"`` adds ``n_prefill`` :class:`PrefillWorker`
    members and a :class:`KVTransferStore` (``transfer_dir`` required):
    cold chains are prefilled by a worker and imported by a decode replica;
    warm chains go straight to the replica that owns their cached blocks.

    ``membership_dir`` enables heartbeat-lease membership: every live
    member beats each :meth:`step` with its role in the lease metadata, and
    a member whose lease expires (``lease_timeout``, injectable ``clock``)
    is detected as a bounded timeout and failed over. Without a membership
    dir, :meth:`kill_replica` fails over immediately (the single-process
    emulation used by the CPU tests)."""

    def __init__(
        self,
        config: M.GPTConfig,
        n_replicas: int = 2,
        *,
        topology: str = "unified",
        n_prefill: int = 1,
        metrics=None,
        membership_dir: Optional[Union[str, Path]] = None,
        lease_timeout: float = 5.0,
        clock=time.time,
        transfer_dir: Optional[Union[str, Path]] = None,
        sharding_plan=None,
        device: DeviceLike = None,
        router: Optional[FleetRouter] = None,
        admission: Optional[AdmissionPolicy] = None,
        tracer=None,
        telemetry_dir: Optional[Union[str, Path]] = None,
        telemetry_interval_s: float = 10.0,
        bucket_overrides: Optional[Dict[str, Sequence[float]]] = None,
        **gen_kwargs: Any,
    ):
        if topology not in ("unified", "disaggregated"):
            raise ValueError(f"unknown topology {topology!r}")
        if topology == "disaggregated" and transfer_dir is None:
            raise ValueError(
                "topology='disaggregated' needs transfer_dir (the shared "
                "directory prefill->decode KV transfers commit through)")
        if n_replicas < 1:
            raise ValueError("a fleet needs at least one serving replica")
        self.dev = resolve_device(device)
        self.sharding_plan = sharding_plan
        self.config = config
        self.topology = topology
        self.metrics = metrics if metrics is not None else observability.get_registry()
        #: histogram bucket configuration applied to the fleet registry AND
        #: every member registry this fleet spawns — the one knob that keeps
        #: bucket bounds identical fleet-wide (an SLO spec aligning edges
        #: with its thresholds must configure ALL pods identically, or the
        #: telemetry aggregator's exact bucket-wise merge raises
        #: TelemetrySchemaError — by design)
        self._bucket_overrides = {
            name: tuple(sorted(float(b) for b in bounds))
            for name, bounds in (bucket_overrides or {}).items()}
        for name, bounds in self._bucket_overrides.items():
            self.metrics.configure_buckets(name, bounds)
        self._tracer = tracer
        #: cross-process telemetry plane: when set, every step() publishes
        #: each member's registry (plus the fleet's) as a per-pod snapshot
        #: through the commit-dir protocol, throttled to the interval — the
        #: TelemetryAggregator's input (observability/export.py)
        self._telemetry_dir = (Path(telemetry_dir)
                               if telemetry_dir is not None else None)
        self._telemetry_interval_s = float(telemetry_interval_s)
        self._telemetry: Dict[str, Any] = {}
        self._last_shed_span_s = float("-inf")  # shed-span 1/s throttle
        self._gen_kwargs = dict(gen_kwargs)
        self.router = router if router is not None else FleetRouter(
            metrics=self.metrics)
        # fleet-level policy records ROUTER shed decisions (exactly once per
        # dropped request — replicas are always dispatched no_shed, so the
        # generator-level counter cannot double-count; see AdmissionPolicy).
        # A registry-less custom policy adopts the fleet registry so the
        # latency_summary shed rollup stays exact.
        self.admission = (
            admission.bind_metrics(self.metrics) if admission is not None
            else AdmissionPolicy(
                max_queue=int(gen_kwargs.get("max_queue", 256)),
                metrics=self.metrics))
        self.heartbeats = (
            HeartbeatStore(membership_dir, lease_timeout=lease_timeout,
                           registry=self.metrics, clock=clock)
            if membership_dir is not None else None)
        self.store = (KVTransferStore(transfer_dir, metrics=self.metrics,
                                      tracer=tracer)
                      if transfer_dir is not None else None)
        self._members: Dict[int, _Member] = {}
        self._next_rid = 0
        self._next_ticket = 0
        self._requests: Dict[int, _FleetRequest] = {}
        self._results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._result_lps: Dict[int, np.ndarray] = {}
        self._open = 0
        self._prefill_pending: "collections.deque[_FleetRequest]" = collections.deque()
        self._transfers: "collections.deque[_FleetRequest]" = collections.deque()
        self._parked: List[_FleetRequest] = []
        # sheds recorded by members that have since left the fleet — the
        # autoscaler's shed_total must stay monotonic across losses and
        # retirements or its delta goes negative right when capacity shrank
        self._departed_sheds = 0.0
        # lifetime totals of members DELETED by scale_down (unplanned
        # losses keep their tombstone and stay in the member sums):
        # latency_summary's fleet rollups must not run backwards either
        self._departed_totals = {"requests_total": 0.0,
                                 "tokens_decoded_total": 0.0,
                                 "shed_requests_total": 0.0}
        # full registry dumps of those same deleted members, merged: the
        # bank behind merged_dump() — without it a retirement would make
        # fleet-wide counters/histograms run BACKWARDS mid-SLO-window
        self._departed_metrics: Dict[str, Any] = {"counters": {},
                                                  "histograms": {}}
        serving_role = ROLE_DECODE if topology == "disaggregated" else ROLE_UNIFIED
        for _ in range(int(n_replicas)):
            self._spawn(serving_role)
        if topology == "disaggregated":
            for _ in range(int(n_prefill)):
                self._spawn(ROLE_PREFILL)
        # validation needs the grid even if every replica later dies
        ref = self._grid_ref()
        self._ref_attrs = dict(
            prompt_buckets=ref.prompt_buckets, block_size=ref.block_size,
            pad_id=ref.pad_id, max_new_tokens=ref.max_new_tokens)
        self._last_beat_s: Optional[float] = None
        if self.heartbeats is not None:
            for m in self._members.values():
                self._beat(m)
            self.heartbeats.expect(list(self._members))
            self._last_beat_s = float(self.heartbeats.clock())
        self._update_replica_count()

    # -- membership --------------------------------------------------------
    def _beat(self, m: _Member) -> None:
        self.heartbeats.beat(
            m.rid, meta={"role": m.role, "replica": m.rid})

    def _poll_membership(self) -> None:
        """Beat every live member's lease, then diff the live set; a lease
        that expired (its member stopped beating — host loss) surfaces here
        as the bounded-timeout loss event and triggers failover.

        Beats/polls are THROTTLED to lease_timeout/3 (by the store's own
        clock): a per-decode-chunk cadence would put N lease writes + a
        directory scan on the hot path every tick, scaling with fleet size,
        while a third of the lease window keeps every live lease safely
        fresh and bounds detection latency at timeout + timeout/3."""
        if self.heartbeats is None:
            return
        now = float(self.heartbeats.clock())
        if (self._last_beat_s is not None
                and now - self._last_beat_s < self.heartbeats.lease_timeout / 3):
            return
        self._last_beat_s = now
        for m in self._members.values():
            if m.alive and not m.killed:
                self._beat(m)
        ev = self.heartbeats.poll()
        if ev is None:
            return
        for rid in ev.lost:
            m = self._members.get(int(rid))
            if m is not None and m.alive:
                self._handle_loss(m)

    def _handle_loss(self, m: _Member, graceful: bool = False) -> None:
        """Fail a member over: drop its affinity entries and re-dispatch
        every queued + in-flight request it held to survivors. Re-dispatch
        replays from the ORIGINAL tokens and key (no partial output is
        reused), so the survivor's stream is token-for-token identical to
        what the lost replica would have produced — prefix-cache misses,
        never wrong tokens. ``graceful`` (scale_down) shares the rebalance
        logic but is a PLANNED retirement: it must not pollute the
        unplanned-loss counter/event an MTTR dashboard keys on."""
        if not m.alive:
            return
        m.alive = False
        # retire the member's telemetry publisher (rids are monotonic, so a
        # cycling autoscaler would otherwise accumulate one publisher +
        # retained dead registry per cycle); a final forced beat preserves
        # its last state in the plane
        pod = ("worker" if m.role == ROLE_PREFILL else "replica")
        pub = self._telemetry.pop(f"{pod}_{m.rid}", None)
        if pub is not None:
            pub.publish(force=True)
        if m.role != ROLE_PREFILL:
            self._departed_sheds += float(
                m.gen.metrics.counter("serving/shed_requests_total").value)
        dropped_affinity = self.router.forget_replica(m.rid)
        lost_tickets = list(m.tickets.values())
        m.tickets.clear()
        if not graceful:
            self.metrics.counter("fleet/replicas_lost_total").inc()
            self.metrics.emit(
                "fleet_replica_lost", replica=m.rid, role=m.role,
                rebalanced=len(lost_tickets),
                affinity_dropped=dropped_affinity)
        tr = self.tracer
        for ft in lost_tickets:
            fr = self._requests[ft]
            if fr.stage == "done":
                continue
            fr.rid = None
            fr.replica_ticket = None
            if fr.decode_span is not None:
                if not graceful:
                    # the decode dispatch died with the replica; a PLANNED
                    # retirement re-dispatches too but is not an error —
                    # the graceful path keeps the error channel clean,
                    # exactly like replicas_lost_total
                    fr.decode_span.set_error(f"replica {m.rid} lost")
                fr.decode_span.end()
                fr.decode_span = None
            fail = None
            if tr.enabled and not graceful:
                # failover is an ANOMALY: always sampled (force), error
                # status; the re-dispatch route/decode spans parent onto it
                # so the recovery is causally linked to the loss
                fail = tr.start_span(
                    "fleet.failover", parent=fr.span, force=True,
                    attributes={"replica": m.rid, "ticket": fr.ticket})
                fail.set_error(f"replica {m.rid} lost; re-dispatching")
            self.metrics.counter(
                "fleet/rebalanced_requests_total",
                help="requests re-dispatched after replica loss").inc()
            self._redispatch(fr, parent=fail)
            if fail is not None:
                fail.end()
        self._update_replica_count()

    def kill_replica(self, rid: int, graceful: bool = False) -> None:
        """Emulate losing a member. The member stops beating and stepping;
        with a heartbeat store the loss is DETECTED after ``lease_timeout``
        (``graceful=True`` writes a tombstone so the next poll sees it
        immediately); without one, failover runs immediately."""
        m = self._members[int(rid)]
        m.killed = True
        if self.heartbeats is None:
            self._handle_loss(m)
        elif graceful:
            self.heartbeats.mark_dead(m.rid)

    def scale_up(self, role: Optional[str] = None, plan=None) -> int:
        """Spawn a fresh member on the fleet's device and add it to the lease
        set; returns its replica id. It shares the weights every replica is
        stepped with (nothing is copied). ``plan`` (a sharding plan or a
        registered name; ``"auto"`` picks the first registered plan for the
        live device count) is the member's layout, the fleet's
        ``sharding_plan`` by default. Parked requests (survivor-less failovers) are re-dispatched
        onto the new capacity."""
        role = role or (ROLE_DECODE if self.topology == "disaggregated"
                        else ROLE_UNIFIED)
        t0 = time.perf_counter()
        m = self._spawn(role, plan=plan)
        if self.heartbeats is not None:
            self._beat(m)
        # spin-up latency = spawn + lease join: the autoscaler's reaction
        # time (latency_summary / the autoscale policy's telemetry)
        self.metrics.histogram(
            "fleet/scale_up_latency_s", buckets=SCALE_UP_BUCKETS,
            help="wall time of scale_up(): replica spawn + lease join",
        ).observe(time.perf_counter() - t0)
        self.metrics.emit("fleet_scale", action="up", replica=m.rid,
                          role=role)
        self._update_replica_count()
        if role != ROLE_PREFILL:
            parked, self._parked = self._parked, []
            for fr in parked:
                self._redispatch(fr)
        return m.rid

    def scale_down(self, rid: int) -> None:
        """Gracefully retire a member: its outstanding work is re-dispatched
        to survivors and its lease is tombstoned. A planned retirement does
        NOT count in ``fleet/replicas_lost_total``."""
        m = self._members[int(rid)]
        functioning = [
            s for s in self._serving_members(alive=True).values()
            if not s.killed and s.rid != m.rid
        ]
        # killed-but-undetected replicas are NOT survivors: retiring the
        # last functioning one would park everything behind a dead fleet
        if m.role != ROLE_PREFILL and not functioning:
            raise ValueError("cannot scale down the last serving replica")
        m.killed = True
        if self.heartbeats is not None:
            self.heartbeats.mark_dead(m.rid)
        self.metrics.emit("fleet_scale", action="down", replica=m.rid,
                          role=m.role)
        self._handle_loss(m, graceful=True)
        # a PLANNED retirement's work is fully re-dispatched (finished
        # results were already harvested into self._results at the step
        # that finished them), so drop the member outright — an autoscaler
        # cycling up/down would otherwise retain one dead generator's KV
        # pool and program set per cycle, forever (unplanned losses keep
        # their tombstone for MTTR accounting)
        for key in self._departed_totals:
            self._departed_totals[key] += float(
                m.gen.metrics.counter(f"serving/{key}").value)
        self._bank_departed(m)
        del self._members[m.rid]
        self._update_replica_count()

    def _bank_departed(self, m: _Member) -> None:
        """Fold a to-be-deleted member's full registry dump into the
        departed bank so :meth:`merged_dump` stays monotone across planned
        retirements (the restart-rebase the cross-process aggregator does,
        applied in-process)."""
        from agilerl_tpu_torch.observability.export import merge_histogram_dumps

        dump = m.gen.metrics.dump()
        bank_c = self._departed_metrics["counters"]
        for name, v in (dump.get("counters") or {}).items():
            bank_c[name] = bank_c.get(name, 0.0) + float(v)
        bank_h = self._departed_metrics["histograms"]
        for name, h in (dump.get("histograms") or {}).items():
            bank_h[name] = (merge_histogram_dumps(bank_h[name], h, name)
                            if name in bank_h else h)

    def _spawn(self, role: str, plan=None) -> _Member:
        if plan == "auto":
            from agilerl_tpu_torch.parallel.plan import live_device_count, plans_for_device_count

            candidates = plans_for_device_count(live_device_count())
            plan = candidates[0] if candidates else None
        if plan is None:
            plan = self.sharding_plan
        rid = self._next_rid
        self._next_rid += 1
        metrics = MetricsRegistry(bucket_overrides=self._bucket_overrides)
        if role == ROLE_PREFILL:
            gen = PrefillWorker.matching(self._grid_ref(), metrics=metrics,
                                         sharding_plan=plan)
        else:
            gen = ContinuousGenerator(
                self.config, metrics=metrics, tracer=self._tracer,
                sharding_plan=plan, device=self.dev, **self._gen_kwargs)
        m = _Member(rid=rid, role=role, gen=gen)
        self._members[rid] = m
        return m

    def _grid_ref(self) -> ContinuousGenerator:
        """Any serving replica (lowest id) — the bucket-grid reference."""
        for rid in sorted(self._members):
            if self._members[rid].role != ROLE_PREFILL:
                return self._members[rid].gen
        raise RuntimeError("fleet has no serving replicas")

    def _serving_members(self, alive: bool = False) -> Dict[int, _Member]:
        return {
            rid: m for rid, m in self._members.items()
            if m.role != ROLE_PREFILL and (m.alive or not alive)
        }

    def _prefill_members(self) -> List[_Member]:
        return [m for m in self._members.values()
                if m.role == ROLE_PREFILL and m.alive and not m.killed]

    @staticmethod
    def _load_of(m: _Member) -> float:
        """Router load signal: the replica's backlog (queued + in-flight
        rows — the queue-depth telemetry the serving tier already keeps)."""
        return float(m.gen.backlog())

    def _update_replica_count(self) -> None:
        serving = self._serving_members(alive=True)
        self.metrics.gauge(
            "fleet/replica_count",
            help="live serving replicas").set(len(serving))
        self.metrics.gauge("fleet/prefill_worker_count").set(
            len(self._prefill_members()))

    # -- observability plane -------------------------------------------------
    @property
    def tracer(self):
        """Distributed tracer (construction-time override, else the process
        default — read lazily so late configuration still takes effect)."""
        return (self._tracer if self._tracer is not None
                else observability.get_tracer())

    def _publish_telemetry(self) -> None:
        """Publish each member's registry (and the fleet's) as a per-pod
        snapshot through the shared commit-dir protocol; each publisher
        throttles itself to ``telemetry_interval_s``."""
        from agilerl_tpu_torch.observability.export import TelemetryPublisher

        clock = (self.heartbeats.clock if self.heartbeats is not None
                 else time.time)
        pods = [("fleet", self.metrics)]
        for rid, m in self._members.items():
            if m.alive and not m.killed:
                prefix = ("worker" if m.role == ROLE_PREFILL else "replica")
                pods.append((f"{prefix}_{rid}", m.gen.metrics))
        for name, reg in pods:
            pub = self._telemetry.get(name)
            if pub is None:
                pub = TelemetryPublisher(
                    self._telemetry_dir, name, reg,
                    interval_s=self._telemetry_interval_s, clock=clock,
                    metrics=self.metrics, tracer=self._tracer)
                self._telemetry[name] = pub
            pub.publish()

    # -- submission / routing ----------------------------------------------
    def fits(self, n_rows: int, longest_prompt: int) -> bool:
        return (n_rows > 0 and
                0 < longest_prompt <= self._ref_attrs["prompt_buckets"][-1])

    def submit(self, tokens, *, max_new: Optional[int] = None, key=None,
               no_shed: bool = False) -> Optional[int]:
        """Route one request into the fleet; returns a fleet ticket, or
        None when router-level admission sheds it (every live replica's
        policy refuses, or the fleet backlog is full). A returned ticket is
        a completion commitment: replica loss re-dispatches it, shedding
        never drops it."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        buckets = self._ref_attrs["prompt_buckets"]
        if tokens.size == 0 or tokens.size > buckets[-1]:
            raise ValueError(
                f"prompt of {tokens.size} tokens outside the bucket grid "
                f"(1..{buckets[-1]}); check fits()")
        serving = {rid: m for rid, m in self._serving_members().items()
                   if m.alive}
        if not serving:
            raise RuntimeError(
                "fleet has no live serving replicas; scale_up() first")
        # admission: probe every candidate's policy (pure reads — no
        # counter moves), shed AT THE ROUTER exactly once if none admits
        reasons = {rid: m.gen.admission_reason()
                   for rid, m in serving.items()}
        admittable = {rid: self._load_of(m) for rid, m in serving.items()
                      if reasons[rid] is None}
        if not no_shed:
            backlog = len(self._prefill_pending) + len(self._transfers)
            fleet_reason = self.admission.reason(queue_len=backlog)
            if fleet_reason is None and not admittable:
                least = min(serving,
                            key=lambda r: (self._load_of(serving[r]), r))
                fleet_reason = reasons[least]
            if fleet_reason is not None:
                tr = self.tracer
                now_s = time.perf_counter()
                if tr.enabled and now_s - self._last_shed_span_s >= 1.0:
                    # router-level shed: anomaly, always sampled — but
                    # throttled to ~1/s (a shed storm is when this fires;
                    # the shed counter/event stays exact)
                    self._last_shed_span_s = now_s
                    tr.start_span(
                        "fleet.shed", force=True,
                        attributes={"reason": fleet_reason,
                                    "backlog": backlog}).end()
                self.admission.shed(fleet_reason, source="router",
                                    backlog=backlog)
                return None
        if not admittable:  # no_shed: dispatch anyway, least-loaded
            admittable = {rid: self._load_of(m)
                          for rid, m in serving.items()}
        ticket = self._next_ticket
        self._next_ticket += 1
        key = request_key(ticket) if key is None else _raw_key(key)
        Pb = _round_up(tokens.size, buckets)
        toks_row, mask_row = left_pad(
            [tokens], self._ref_attrs["pad_id"], Pb)
        hashes = chain_hashes(toks_row[0], mask_row[0],
                              self._ref_attrs["block_size"])
        fr = _FleetRequest(
            ticket=ticket, tokens=tokens, key=key,
            max_new=max_new, hashes=hashes, arrival_s=time.perf_counter())
        tr = self.tracer
        if tr.enabled:
            # root span of the request's trace: submit → route → (prefill →
            # KV transfer → import) → decode admission → result. Manual
            # lifecycle — ended when step() harvests the result.
            fr.span = tr.start_span(
                "fleet.request",
                attributes={"ticket": ticket,
                            "prompt_tokens": int(tokens.size)})
        self._requests[ticket] = fr
        self._open += 1
        rid, affinity = self.router.route(fr.hashes, admittable)
        if (self.topology == "disaggregated" and not affinity
                and self._prefill_members()):
            # cold chain: dedicated prefill, then an atomic KV transfer to
            # a decode replica (chosen at import time, when its load and
            # liveness are current)
            fr.stage = "prefill_queue"
            self._prefill_pending.append(fr)
            if tr.enabled:
                tr.start_span(
                    "fleet.route", parent=fr.span,
                    attributes={"stage": "prefill",
                                "affinity": False}).end()
            self.metrics.emit("fleet_route", ticket=ticket, stage="prefill",
                              affinity=False)
        else:
            self._dispatch_direct(fr, rid, affinity)
        return ticket

    def _dispatch_direct(self, fr: _FleetRequest, rid: int,
                         affinity: bool, parent: Any = None,
                         submit=None, stage: Optional[str] = None) -> None:
        """The ONE dispatch tail behind direct submits AND prefilled
        imports (route/decode spans, replica submit, ticket/affinity/router
        bookkeeping — shared so the two entry points cannot drift).

        Direct path: warm chains ride the replica's own prefix cache; cold
        ones prefill locally. ``parent`` overrides the span the
        route/decode spans link under — the failover path passes its error
        span so the re-dispatch is causally linked to the loss; the import
        path passes its ``fleet.kv_import`` span. ``submit`` overrides the
        replica call (``(gen, trace_ctx) -> replica ticket`` —
        ``submit_prefilled`` for imports); ``stage`` tags the route
        event."""
        m = self._members[rid]
        fr.rid, fr.stage = rid, "decoding"
        fr.dispatches += 1
        tr = self.tracer
        fr.decode_span = None
        if tr.enabled:
            link = parent if parent is not None else fr.span
            tr.start_span(
                "fleet.route", parent=link,
                attributes={"replica": rid, "affinity": affinity,
                            "dispatches": fr.dispatches}).end()
            fr.decode_span = tr.start_span(
                "fleet.decode", parent=link, attributes={"replica": rid})
        ctx = (fr.decode_span.context()
               if fr.decode_span is not None else None)
        if submit is None:
            # fr.hashes rides along (same bucket/block layout fleet-wide):
            # the replica skips re-hashing the prompt at admission
            fr.replica_ticket = m.gen.submit(
                fr.tokens, max_new=fr.max_new, key=fr.key, no_shed=True,
                hashes=fr.hashes, trace_ctx=ctx)
        else:
            fr.replica_ticket = submit(m.gen, ctx)
        m.tickets[fr.replica_ticket] = fr.ticket
        self.router.record(fr.hashes, rid)
        if affinity:
            self.metrics.counter(
                "fleet/affinity_hits_total",
                help="requests routed to the replica owning their cached "
                     "prefix").inc()
        self.metrics.counter("fleet/routed_requests_total").inc()
        extra = {} if stage is None else {"stage": stage}
        self.metrics.emit(
            "fleet_route", ticket=fr.ticket, replica=rid,
            affinity=affinity, dispatches=fr.dispatches,
            load=self._load_of(m), **extra)

    def _survivors(self) -> Dict[int, float]:
        """Serving replicas that can actually take work RIGHT NOW (alive
        belief minus ground-truth killed) with their loads — ONE home for
        the candidate rule every fallback path routes by."""
        return {rid: self._load_of(m)
                for rid, m in self._serving_members(alive=True).items()
                if not m.killed}

    def _redispatch(self, fr: _FleetRequest, parent: Any = None) -> None:
        """Dispatch a request straight to a serving replica, bypassing the
        prefill stage — the shared fallback for rebalance-after-loss, torn
        transfers, and no-prefill-capacity (all replay from the original
        tokens: no_shed, a ticketed request is a completion commitment;
        SLO shedding throttles NEW arrivals while the fleet re-forms).
        With no survivors the request parks until :meth:`scale_up`.
        ``parent`` (a failover/torn-transfer anomaly span) causally links
        the re-dispatch spans to the fault that forced it."""
        survivors = self._survivors()
        if not survivors:
            fr.stage = "parked"
            self._parked.append(fr)
            if fr.span is not None:
                fr.span.add_event("parked", reason="no survivors")
            return
        rid, affinity = self.router.route(fr.hashes, survivors)
        self._dispatch_direct(fr, rid, affinity, parent=parent)

    # -- the scheduler tick -------------------------------------------------
    def step(self, params, lora=None, greedy: bool = False) -> List[int]:
        """ONE fleet scheduler iteration: beat + poll membership, run the
        disaggregated prefill/transfer stages, then one decode chunk on
        every live replica. Returns fleet tickets finished this step."""
        self._poll_membership()
        if self._telemetry_dir is not None:
            self._publish_telemetry()
        if self.topology == "disaggregated":
            self._step_prefill(params, lora, greedy)
            self._step_imports()
        finished: List[int] = []
        for rid in sorted(self._members):
            m = self._members[rid]
            if m.role == ROLE_PREFILL or not m.alive or m.killed:
                continue
            for rt in m.gen.step(params, lora=lora, greedy=greedy):
                ft = m.tickets.pop(rt)
                fr = self._requests[ft]
                fr.stage = "done"
                self._results[ft] = m.gen.result(rt)
                if getattr(m.gen, "capture_logprobs", False):
                    lp = m.gen.result_logprobs(rt)
                    if lp is not None:
                        self._result_lps[ft] = lp
                self._open -= 1
                if fr.decode_span is not None:
                    fr.decode_span.end()
                    fr.decode_span = None
                if fr.span is not None:
                    # the root span closes with the whole-request view
                    fr.span.set_attribute("dispatches", fr.dispatches)
                    fr.span.end()
                    fr.span = None
                finished.append(ft)
        return finished

    def _step_prefill(self, params, lora, greedy: bool) -> None:
        """Drive each live prefill worker one prompt forward and commit the
        transfer. With zero live workers the pending queue drains to the
        decode replicas' local prefill — the fleet degrades to unified
        rather than stalling."""
        workers = self._prefill_members()
        if not workers:
            while self._prefill_pending:
                fr = self._prefill_pending.popleft()
                self._redispatch(fr)
            return
        tr = self.tracer
        for m in workers:
            if not self._prefill_pending:
                break
            fr = self._prefill_pending.popleft()
            psp = tr.start_span("fleet.prefill", parent=fr.span,
                                attributes={"worker": m.rid})
            payload = m.gen.prefill(fr.tokens, fr.key, params, lora=lora,
                                    greedy=greedy, hashes=fr.hashes)
            # the prefill span's context rides the transfer payload AND its
            # manifest (KVTransferStore.export) so the decode side — this
            # process or another — stitches its import span onto it
            ctx = tr.inject(psp)
            if ctx is not None:
                payload["trace"] = ctx
            path = self.store.export(f"transfer_{fr.ticket:06d}", payload)
            psp.end()
            fr.stage, fr.transfer = "transfer", path
            self._transfers.append(fr)

    def _step_imports(self) -> None:
        """Import committed transfers on a decode replica. Torn transfers
        are skipped (counted + warned inside :meth:`KVTransferStore.load`)
        and the request recomputes from tokens on a replica's local
        prefill — wasted work, never wrong tokens."""
        pending, self._transfers = self._transfers, collections.deque()
        tr = self.tracer
        for fr in pending:
            payload = self.store.load(fr.transfer)
            self.store.consume(fr.transfer)
            fr.transfer = None
            if payload is None:
                torn = None
                if tr.enabled:
                    # torn transfer: anomaly — always sampled, error status,
                    # with the recompute dispatch causally linked under it
                    torn = tr.start_span(
                        "fleet.torn_transfer", parent=fr.span, force=True,
                        attributes={"ticket": fr.ticket})
                    torn.set_error(
                        "torn KV transfer; recomputing from tokens")
                self._redispatch(fr, parent=torn)
                if torn is not None:
                    torn.end()
                continue
            candidates = self._survivors()
            if not candidates:
                fr.stage = "parked"
                self._parked.append(fr)
                if fr.span is not None:
                    fr.span.add_event("parked", reason="no survivors")
                continue
            rid, affinity = self.router.route(fr.hashes, candidates)
            # parent the import span on the context that RODE THE TRANSFER
            # (manifest + payload) — that is what makes the trace stitch
            # when prefill and decode run in different processes; the
            # shared dispatch tail hangs its route/decode spans under it
            isp = None
            if tr.enabled:
                isp = tr.start_span(
                    "fleet.kv_import",
                    parent=(payload.get("trace") or fr.span),
                    attributes={"replica": rid})

            def _submit_import(gen, ctx, payload=payload, fr=fr):
                return gen.submit_prefilled(
                    payload["tokens"], k_prompt=payload["k"],
                    v_prompt=payload["v"], tok0=payload["tok0"],
                    done0=payload["done0"], key_next=payload["key_next"],
                    lp0=payload.get("lp0"),
                    key=fr.key, max_new=fr.max_new, arrival_s=fr.arrival_s,
                    no_shed=True, hashes=fr.hashes, trace_ctx=ctx,
                    kv_heads=payload.get("kv_heads"))

            # affinity here means two identical cold prompts raced through
            # prefill and the second import lands where the first
            # registered the chain (counted inside the shared tail)
            self._dispatch_direct(fr, rid, affinity, parent=isp,
                                  submit=_submit_import, stage="import")
            if isp is not None:
                isp.end()
            self.metrics.counter("fleet/kv_imports_total").inc()

    # -- results ------------------------------------------------------------
    def result(self, ticket: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, emit mask) for a finished fleet ticket — pops BOTH the
        result and the request's lifecycle record (the re-dispatch unit is
        only needed while the request can still fail over; keeping it
        past collection would leak one record per request forever)."""
        out = self._results.pop(ticket)
        self._requests.pop(ticket, None)
        return out

    def result_logprobs(self, ticket: int) -> Optional[np.ndarray]:
        """Decode-captured behavior logprobs [max_new] for a finished fleet
        ticket (None unless the replicas run ``capture_logprobs``); pops
        the record. Call BEFORE :meth:`result` or right after — both pop
        independent maps."""
        return self._result_lps.pop(ticket, None)

    def run_until_drained(self, params, lora=None, greedy: bool = False,
                          max_steps: int = 100_000) -> List[int]:
        finished: List[int] = []
        steps = 0
        while self._open:
            finished.extend(self.step(params, lora=lora, greedy=greedy))
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"fleet not drained after {max_steps} steps "
                    f"({self._open} requests open — a killed replica whose "
                    "lease cannot expire? advance the clock or scale_up)")
        return finished

    def generate(
        self,
        sequences: List[Any],
        key,
        params,
        lora=None,
        greedy: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
        """Batch convenience with the ContinuousGenerator.generate contract
        (same per-row key fold, so a fleet and a single generator given the
        same key produce identical streams). ``key``: an int seed, a counter
        key pair or a ``torch.Generator``."""
        B = len(sequences)
        if B == 0:
            raise ValueError("ServingFleet.generate got an empty list")
        lengths = [len(s) for s in sequences]
        if not self.fits(B, max(lengths)) or min(lengths) == 0:
            raise ValueError(
                f"prompt lengths {min(lengths)}..{max(lengths)} outside "
                f"the bucket grid "
                f"(1..{self._ref_attrs['prompt_buckets'][-1]})")
        base = _raw_key(key)
        hits0 = self.metrics.counter("fleet/affinity_hits_total").value
        tickets = [
            self.submit(s, key=fold_in(base, i), no_shed=True)
            for i, s in enumerate(sequences)
        ]
        self.run_until_drained(params, lora=lora, greedy=greedy)
        N = self._ref_attrs["max_new_tokens"]
        comp = np.full((B, N), self._ref_attrs["pad_id"], np.int32)
        cmask = np.zeros((B, N), np.int32)
        lps = (np.zeros((B, N), np.float32)
               if self._gen_kwargs.get("capture_logprobs") else None)
        for i, t in enumerate(tickets):
            if lps is not None:
                row = self.result_logprobs(t)
                if row is not None:
                    lps[i, :row.size] = row
            toks, emits = self.result(t)
            comp[i, :toks.size] = toks
            cmask[i, :emits.size] = emits
        info = {
            "replicas": len(self._serving_members(alive=True)),
            "topology": self.topology,
            "affinity_hits": int(self.metrics.counter(
                "fleet/affinity_hits_total").value - hits0),
            "compiled_programs": self.compiled_programs,
            "max_new_tokens": N,
        }
        self.metrics.emit("fleet_generate", rows=B, **info)
        if lps is not None:
            # after emit(): telemetry lines carry scalars, not [B, N] arrays
            info["logprobs"] = lps
        return comp, cmask, info

    # -- telemetry -----------------------------------------------------------
    def slo_signals(self) -> Dict[str, Any]:
        """The rolled-up signal set an autoscaling policy thresholds on
        (llm/autoscale.AutoscalePolicy) — all read from telemetry the
        serving tier already keeps: live replica count, per-replica backlog
        (queued + in-flight rows), rolling p95 TTFT across every replica's
        recent-TTFT window (the same window admission control sheds on, so
        the scaler and the shedder see one latency truth), and the
        cumulative shed count (router + live replicas + members that have
        since departed, so the total stays monotonic across losses and
        retirements; router/replica counts disjoint by construction — see
        latency_summary)."""
        members = [m for m in self._serving_members(alive=True).values()
                   if not m.killed]
        backlogs = [float(m.gen.backlog()) for m in members]
        recent = [t for m in members for t in list(m.gen._recent_ttft)]
        # the shed SUM includes killed-but-undetected members (their
        # history must not vanish for the detection window — alive=False
        # hands it to _departed_sheds at _handle_loss); capacity signals
        # (backlog/TTFT) rightly exclude them
        shed = (
            self.metrics.counter("serving/shed_requests_total").value
            + self._departed_sheds
            + sum(m.gen.metrics.counter("serving/shed_requests_total").value
                  for m in self._serving_members(alive=True).values()))
        return {
            "replicas": len(members),
            "mean_backlog": (sum(backlogs) / len(backlogs)
                             if backlogs else 0.0),
            "max_backlog": max(backlogs) if backlogs else 0.0,
            "fleet_backlog": float(len(self._prefill_pending)
                                   + len(self._transfers)
                                   + len(self._parked)),
            "p95_ttft_s": (float(np.percentile(np.asarray(recent), 95))
                           if recent else None),
            "shed_total": float(shed),
        }

    def least_loaded_replica(self) -> Optional[int]:
        """The live serving replica with the smallest backlog (ties ->
        HIGHEST id: retire the newest first, keeping low ids — the grid
        reference and leader-election anchors — stable). None when the
        fleet has at most one functioning replica (nothing retirable)."""
        survivors = self._survivors()
        if len(survivors) < 2:
            return None
        return min(survivors, key=lambda r: (survivors[r], -r))

    def latency_summary(self) -> Dict[str, Any]:
        """Fleet-level SLO rollup: every serving replica's
        ``latency_summary()`` (each on its own registry) plus the fleet
        counters — replica count, rebalances, affinity hits, transfers,
        router sheds — and cross-replica request/token totals."""
        replicas: Dict[int, Dict[str, Any]] = {}
        for rid in sorted(self._members):
            m = self._members[rid]
            if m.role == ROLE_PREFILL:
                replicas[rid] = {
                    "role": m.role, "alive": m.alive,
                    "compiled_programs": m.gen.compiled_programs,
                }
            else:
                s = m.gen.latency_summary()
                s["role"], s["alive"] = m.role, m.alive
                replicas[rid] = s
        serving = [m for m in self._members.values()
                   if m.role != ROLE_PREFILL]
        reg = self.metrics
        fleet = {
            "replica_count": sum(m.alive for m in serving),
            "prefill_worker_count": len(self._prefill_members()),
            "rebalanced_requests_total": reg.counter(
                "fleet/rebalanced_requests_total").value,
            "affinity_hits_total": reg.counter(
                "fleet/affinity_hits_total").value,
            "routed_requests_total": reg.counter(
                "fleet/routed_requests_total").value,
            "replicas_lost_total": reg.counter(
                "fleet/replicas_lost_total").value,
            "kv_transfers_total": reg.counter(
                "fleet/kv_transfers_total").value,
            "torn_kv_transfers_total": reg.counter(
                "fleet/torn_kv_transfers_total").value,
            # router sheds live on the fleet registry, generator sheds on
            # each replica's — disjoint by construction (no_shed dispatch),
            # so the sum is exact, never double-counted
            "shed_requests_total": (
                reg.counter("serving/shed_requests_total").value
                + self._departed_totals["shed_requests_total"]
                + sum(m.gen.metrics.counter(
                    "serving/shed_requests_total").value for m in serving)),
            "requests_total": (
                self._departed_totals["requests_total"]
                + sum(m.gen.metrics.counter(
                    "serving/requests_total").value for m in serving)),
            "tokens_decoded_total": (
                self._departed_totals["tokens_decoded_total"]
                + sum(m.gen.metrics.counter(
                    "serving/tokens_decoded_total").value for m in serving)),
            "scale_up_latency_s": reg.histogram(
                "fleet/scale_up_latency_s",
                buckets=SCALE_UP_BUCKETS).summary(),
        }
        return {"replicas": replicas, "fleet": fleet}

    def merged_dump(self, counters: Optional[Sequence[str]] = None,
                    histograms: Optional[Sequence[str]] = None
                    ) -> Dict[str, Any]:
        """One fleet-wide metric dump: the fleet registry ⊕ every member
        registry (tombstoned unplanned losses included — their state is
        history, not noise) ⊕ the banked dumps of scale_down-deleted
        members. The in-process analogue of
        ``TelemetryAggregator.merged_dump()`` — same bucket-exact histogram
        merge (``TelemetrySchemaError`` on bounds skew, which
        ``bucket_overrides`` exists to prevent) without the commit-dir
        round-trip — and the source the SLO evaluator grades in-process
        (``observability/slo.SLOEvaluator``; pass the spec's
        ``metric_names()`` as the ``counters``/``histograms`` filters to
        keep the per-step read off the full-dump path)."""
        from agilerl_tpu_torch.observability.export import merge_histogram_dumps
        from agilerl_tpu_torch.observability.registry import (Counter, Gauge,
                                                        Histogram)

        cset = set(counters) if counters is not None else None
        hset = set(histograms) if histograms is not None else None
        unfiltered = cset is None and hset is None
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        for name, v in self._departed_metrics["counters"].items():
            if cset is None or name in cset:
                out["counters"][name] = float(v)
        for name, h in self._departed_metrics["histograms"].items():
            if hset is None or name in hset:
                out["histograms"][name] = {
                    "bounds": list(h["bounds"]),
                    "counts": list(h["counts"]),
                    "sum": float(h["sum"]), "count": int(h["count"])}
        regs = [self.metrics] + [
            m.gen.metrics for m in self._members.values()
            if getattr(m.gen, "metrics", None) is not None
            and m.gen.metrics is not self.metrics]
        for reg in regs:
            for name, inst in list(reg._metrics.items()):
                if isinstance(inst, Counter):
                    if cset is None or name in cset:
                        out["counters"][name] = (
                            out["counters"].get(name, 0.0) + inst.value)
                elif isinstance(inst, Histogram):
                    if hset is None or name in hset:
                        with inst._lock:
                            h = {"bounds": list(inst.bounds),
                                 "counts": list(inst._counts),
                                 "sum": inst._sum, "count": inst._count}
                        prev = out["histograms"].get(name)
                        out["histograms"][name] = (
                            merge_histogram_dumps(prev, h, name)
                            if prev is not None else h)
                elif isinstance(inst, Gauge) and unfiltered:
                    # fleet-registry value wins (regs[0]); members only
                    # fill gauges the fleet itself does not keep
                    out["gauges"].setdefault(name, inst.value)
        return out

    @property
    def open_requests(self) -> int:
        """Fleet tickets submitted but not yet finished (queued, prefilling,
        in transfer, decoding, or parked): a load generator's drain signal."""
        return int(self._open)

    @property
    def replica_ids(self) -> List[int]:
        return sorted(rid for rid, m in self._members.items()
                      if m.role != ROLE_PREFILL and m.alive)

    @property
    def compiled_programs(self) -> int:
        """Total compiled programs across every member — bounded by
        (members x bucket grid), constant in request count and routing
        order."""
        return sum(m.gen.compiled_programs for m in self._members.values())
