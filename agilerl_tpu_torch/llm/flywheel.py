"""Online GRPO flywheel: disaggregated rollout/learner pods exchanging
weights and trajectories through atomic commit-dir stores. The port of
``agilerl_tpu/llm/flywheel.py``.

``finetune_llm_reasoning`` interleaves generate and learn in one process,
so rollout generation dominates GRPO step time. The flywheel splits the two
sides along the IMPALA / Podracer seam (Espeholt et al.: decoupled
actor/learner with importance correction):

- **Rollout pods** (:class:`RolloutPod`) drive GRPO group generation
  (through the agent's serving tier, or a router-fronted
  :class:`~agilerl_tpu_torch.llm.fleet.ServingFleet` via
  :meth:`GRPO.attach_rollout_fleet`, optionally autoscaled by
  :class:`~agilerl_tpu_torch.llm.autoscale.AutoscalePolicy`) against the
  freshest PUBLISHED adapter epoch, tag every group batch with the weight
  epoch it was decoded under, record the behavior policy's per-token
  logprobs, and publish the batch. Actors never block on the learner.
- **Learner pods** (:class:`LearnerPod`) consume trajectory batches, drop
  those staler than ``max_staleness_epochs`` (counted, never trained on),
  and run the staleness-aware importance-corrected GRPO update
  (:meth:`~agilerl_tpu_torch.algorithms.grpo.GRPO.learn_from_trajectory`).
  Each update publishes a new weight epoch.
- **Stores**: :class:`WeightStore` (versioned adapter epochs, last-K GC)
  and :class:`TrajectoryStore` (group batches with epoch + prompt
  provenance), both thin wrappers over the shared commit-dir protocol
  (:class:`~agilerl_tpu_torch.resilience.store.CommitDirStore`): torn
  publishes are skipped with a warning and NEVER loaded. Payloads are host
  numpy only (adapter trees, optimizer state, the ``torch.Generator``
  state as a byte array), so a process without a card reads them, and a
  weight epoch published by the JAX package's learner loads here too.

Staleness semantics: a batch decoded under weight epoch ``e`` consumed by
a learner at epoch ``E`` has lag ``E - e``. ``max_staleness_epochs=0`` is
the synchronous mode: the learner trains only on current-epoch batches,
so the flywheel reproduces the interleaved loop's loss/param stream
exactly. Larger budgets let decode run ahead; the importance correction
keeps bounded lag unbiased and the drop policy bounds it.

:class:`OnlineGRPOFlywheel` is the single-process loop: it ticks both
pods with flow control derived from the staleness budget, so "decode never
blocks on learn" is an observable (``flywheel/decode_stall_s``), not a
hope. A real deployment runs the pods as separate processes against the
same store directories: every pod<->pod interaction goes through the
stores, never through shared memory.

Prefix-cache coherence on weight swaps is inherited from the serving tier:
adopting a published epoch binds NEW adapter tensors, and every replica's
``_check_weight_epoch`` (keyed on object identity) flushes its prefix cache
and drops queued stale prefill imports at its next step.

``LearnerPod(plan=, mesh=)`` raises ``NotImplementedError`` until the
distribution slice.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from agilerl_tpu_torch import observability
from agilerl_tpu_torch.llm.convert import lora_from_numpy
from agilerl_tpu_torch.resilience.atomic import atomic_write_bytes
from agilerl_tpu_torch.resilience.store import CommitDirStore, entry_seq
from agilerl_tpu_torch.utils.tree import tree_from_numpy, tree_to_numpy

#: entry-name prefixes (the stores' GC and ordering key on these)
_EPOCH_PREFIX = "epoch_"
_BATCH_PREFIX = "batch_"


class WeightStore:
    """Versioned adapter epochs through the commit-dir protocol.

    One entry per published epoch (``epoch_00000012/`` holding
    ``weights.pkl`` + manifest), last-K GC on publish. Readers walk
    newest-first and skip torn entries (``flywheel/torn_weight_publishes_
    total``) — a torn publish is invisible to actors, which keep decoding
    under the previous epoch instead of loading garbage."""

    def __init__(self, directory: Union[str, Path], keep_last: int = 4,
                 metrics=None, tracer=None):
        self._store = CommitDirStore(
            directory,
            payload_name="weights.pkl",
            prefix=_EPOCH_PREFIX,
            keep_last=int(keep_last),
            torn_counter="flywheel/torn_weight_publishes_total",
            torn_help="weight epochs skipped as torn/corrupt",
            warn_prefix="torn-weight-epoch",
            metrics=metrics,
            tracer=tracer,
        )
        self.directory = self._store.directory
        self.metrics = self._store.metrics

    def publish(self, epoch: int, lora: Any,
                meta: Optional[Dict[str, Any]] = None,
                trace_ctx: Optional[Dict[str, Any]] = None,
                extra_payload: Optional[Dict[str, Any]] = None) -> Path:
        """Atomically publish one adapter epoch (host numpy copies: a pickled
        CUDA tensor could not be read by a process without a card). ``trace_ctx`` (the publishing span's injected
        context) rides the payload and manifest so an actor's adoption
        span stitches onto the learn step that produced the epoch.
        ``extra_payload`` keys ride the pickled payload only (NOT the
        manifest — they may hold arrays): the learner's warm-restart state
        travels with the epoch it belongs to, so a respawned learner
        resumes from whatever epoch actors can already see."""
        payload = {"epoch": int(epoch), "lora": tree_to_numpy(lora)}
        if extra_payload:
            payload.update(extra_payload)
        if trace_ctx is not None:
            payload["trace"] = trace_ctx
        extra = {"epoch": int(epoch), **(meta or {})}
        if trace_ctx is not None:
            extra["trace"] = trace_ctx
        path = self._store.publish(
            f"{_EPOCH_PREFIX}{int(epoch):08d}", payload,
            manifest_extra=extra)
        self.metrics.counter(
            "flywheel/weight_epochs_published_total",
            help="adapter epochs published by learner pods").inc()
        return path

    def epochs(self) -> List[int]:
        """Committed epoch numbers, oldest first."""
        return [s for s in (entry_seq(p.name) for p in self._store.entries())
                if s is not None]

    def latest_epoch(self) -> Optional[int]:
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def load_latest(self) -> Optional[Tuple[int, Any]]:
        """(epoch, adapter tree) of the newest LOADABLE epoch — torn
        entries are counted, warned about, and walked past (never loaded);
        None when nothing valid is committed yet."""
        payload = self.load_latest_payload()
        if payload is None:
            return None
        return int(payload["epoch"]), payload["lora"]

    def load_latest_payload(self) -> Optional[Dict[str, Any]]:
        """The newest loadable epoch's FULL payload (epoch, lora, and the
        publisher's trace context when one rode along)."""
        for path in reversed(self._store.entries()):
            payload = self._store.load(path)
            if payload is not None:
                return payload
        return None

    def truncate_above(self, epoch: int) -> int:
        """Delete committed epochs NEWER than ``epoch`` — the resume
        protocol: a crash can leave post-snapshot epochs in the store, and
        without truncation actors would adopt the PRE-crash adapter (and
        last-K GC could collect the restored re-publish as the oldest
        entry). Returns the number of entries removed."""
        removed = 0
        for path in self._store.entries():
            seq = entry_seq(path.name)
            if seq is not None and seq > int(epoch):
                self._store.consume(path)
                removed += 1
        return removed


@dataclasses.dataclass
class TrajectoryBatch:
    """One GRPO group batch with full decode provenance — everything the
    learner needs to run the importance-corrected update WITHOUT
    recomputing anything from the rollout side.

    ``weight_epoch`` is the adapter epoch the completions were decoded
    under (the staleness tag); ``behavior_lp`` is that epoch's per-token
    completion logprob record (:meth:`GRPO.behavior_logprobs`);
    ``data_epoch`` is the env's dataset-epoch counter at generation time
    (it drives the learner's reference-adapter refresh, exactly as the
    interleaved loop's ``set_reference_policy(env.num_epochs)`` did);
    ``prompt_hashes`` is per-prompt provenance (sha1 of the prompt token
    ids)."""

    seq: int
    actor_id: int
    weight_epoch: int
    data_epoch: int
    ids: np.ndarray            # [B*G, P+N] prompt+completion sequences
    action_masks: np.ndarray   # [B*G, P+N-1] completion-prediction mask
    rewards: np.ndarray        # [B, G]
    behavior_lp: np.ndarray    # [B*G, P+N-1] behavior-epoch logprobs, masked
    prompt_hashes: List[str] = dataclasses.field(default_factory=list)
    #: for EXTERNAL batch producers whose tokenizer's pad id collides with
    #: a real vocab token (GRPO.learn's 4-tuple contract). RolloutPod never
    #: ships one — the serving-tier envs derive the mask from pad ids,
    #: exactly like the interleaved loop's 3-tuple learn path.
    attention_mask: Optional[np.ndarray] = None
    #: the rollout span's injected trace context: the learner's consume /
    #: learn spans parent onto it, stitching the batch lifecycle across
    #: the pod boundary
    trace_ctx: Optional[Dict[str, Any]] = None


class TrajectoryStore:
    """GRPO group batches through the commit-dir protocol.

    Writers publish ``batch_{actor:03d}_{seq:08d}`` entries; readers
    :meth:`poll` committed entries in global seq order, consume (delete)
    each after reading, and skip torn ones
    (``flywheel/torn_trajectories_total``) — a torn batch costs one group
    of rollouts, never a corrupted gradient."""

    def __init__(self, directory: Union[str, Path], metrics=None,
                 tracer=None):
        self._store = CommitDirStore(
            directory,
            payload_name="trajectory.pkl",
            prefix=_BATCH_PREFIX,
            torn_counter="flywheel/torn_trajectories_total",
            torn_help="trajectory batches skipped as torn/corrupt",
            warn_prefix="torn-trajectory",
            metrics=metrics,
            tracer=tracer,
        )
        self.directory = self._store.directory
        self.metrics = self._store.metrics

    def publish(self, batch: TrajectoryBatch) -> Path:
        extra = {
            "seq": int(batch.seq),
            "actor_id": int(batch.actor_id),
            "weight_epoch": int(batch.weight_epoch),
            "data_epoch": int(batch.data_epoch),
            "rows": int(np.asarray(batch.ids).shape[0]),
            "prompt_hashes": list(batch.prompt_hashes),
        }
        if batch.trace_ctx is not None:
            extra["trace"] = batch.trace_ctx
        path = self._store.publish(
            f"{_BATCH_PREFIX}{int(batch.actor_id):03d}_{int(batch.seq):08d}",
            batch, manifest_extra=extra)
        self.metrics.counter(
            "flywheel/trajectories_published_total",
            help="trajectory batches published by rollout pods").inc()
        self.metrics.gauge(
            "flywheel/trajectories_pending",
            help="published-but-unconsumed trajectory batches").set(
            self.pending())
        return path

    def pending(self) -> int:
        return len(self._store.entries())

    def clear(self) -> int:
        """Consume every committed batch WITHOUT returning it — the resume
        protocol: pre-crash leftovers reference a decode-epoch line and a
        prompt-stream position the restored run no longer matches (and
        their seq numbers would collide with the restarted rollout
        counter). Returns the number of entries removed."""
        removed = 0
        for path in self._store.entries():
            self._store.consume(path)
            removed += 1
        if removed:
            self.metrics.gauge("flywheel/trajectories_pending").set(
                self.pending())
        return removed

    def poll_entries(
        self, max_batches: Optional[int] = None
    ) -> List[Tuple[Path, TrajectoryBatch]]:
        """Read committed batches in seq order WITHOUT consuming them —
        the caller calls :meth:`consume` per entry once whatever depends on
        the batch is durably committed (the learner consumes AFTER its
        weight publish, so a kill between learn and consume replays or
        staleness-drops the batch instead of losing it). Torn entries are
        counted, warned about, and consumed here (they cannot wedge the
        queue) but never returned."""
        out: List[Tuple[Path, TrajectoryBatch]] = []
        entries = self._store.entries()
        if max_batches is not None:
            entries = entries[: int(max_batches)]
        for path in entries:
            payload = self._store.load(path)
            if payload is None:
                self._store.consume(path)  # torn: never returned
                continue
            out.append((path, payload))
        return out

    def consume(self, path: Union[str, Path]) -> None:
        """Delete one polled entry (counted as consumed)."""
        self._store.consume(path)
        self.metrics.counter(
            "flywheel/trajectories_consumed_total",
            help="trajectory batches consumed by learner pods").inc()
        self.metrics.gauge("flywheel/trajectories_pending").set(
            self.pending())

    def poll(self, max_batches: Optional[int] = None) -> List[TrajectoryBatch]:
        """Read + consume committed batches in seq order. Torn entries are
        counted, warned about, consumed (so they cannot wedge the queue),
        and excluded from the result — never trained on."""
        out: List[TrajectoryBatch] = []
        for path, payload in self.poll_entries(max_batches):
            self.consume(path)
            out.append(payload)
        self.metrics.gauge("flywheel/trajectories_pending").set(
            self.pending())
        return out


def _prompt_hashes(prompts: Dict[str, np.ndarray]) -> List[str]:
    """Per-prompt sha1 provenance over the REAL (unpadded) token ids."""
    ids = np.asarray(prompts["input_ids"])
    mask = np.asarray(prompts["attention_mask"]).astype(bool)
    return [hashlib.sha1(row[m].astype(np.int32).tobytes()).hexdigest()
            for row, m in zip(ids, mask)]


class RolloutPod:
    """The decode side: generates GRPO groups under the freshest published
    adapter epoch and publishes tagged trajectory batches. Never blocks on
    the learner — flow control (if any) lives in the tick loop, where a stall
    is counted, not hidden.

    ``agent`` is a GRPO instance whose ``base_params`` match the
    learner's (a clone, or the very same object in the colocated
    emulation); only its ACTOR adapter is replaced on epoch adoption, so
    its own optimizer/reference state is never touched. ``fleet`` routes
    generation through a ServingFleet (attach_rollout_fleet — the router
    path), and ``autoscaler`` is applied to that fleet once per rollout."""

    def __init__(
        self,
        agent,
        env,
        weight_store: WeightStore,
        traj_store: TrajectoryStore,
        actor_id: int = 0,
        metrics=None,
        fleet=None,
        autoscaler=None,
        tracer=None,
        cursor_path: Optional[Union[str, Path]] = None,
    ):
        self.agent = agent
        self.env = env
        self.weight_store = weight_store
        self.traj_store = traj_store
        self.actor_id = int(actor_id)
        self.metrics = (metrics if metrics is not None
                        else observability.get_registry())
        self._tracer = tracer
        self.fleet = fleet
        self.autoscaler = autoscaler
        if fleet is not None:
            agent.attach_rollout_fleet(fleet)
        self.weight_epoch = -1  # nothing adopted yet
        self.seq = 0
        self._prompts = None
        #: durable per-actor seq cursor (the process-launcher respawn path):
        #: the NEXT seq is committed before each publish, so a crash between
        #: cursor write and publish skips a seq (harmless — the learner's
        #: seq-ordered consume tolerates gaps) but can never publish the same
        #: seq twice under two different weight epochs
        self.cursor_path = Path(cursor_path) if cursor_path else None
        if self.cursor_path is not None and self.cursor_path.exists():
            try:
                cur = json.loads(self.cursor_path.read_text())
                self.seq = int(cur["seq"])
            except (OSError, ValueError, KeyError, TypeError):
                # unreadable cursor == fresh actor (atomic_write_bytes makes
                # this external corruption, not a crash artifact)
                pass

    def _commit_cursor(self) -> None:
        """Persist the NEXT seq (``self.seq`` post-increment) atomically."""
        if self.cursor_path is None:
            return
        atomic_write_bytes(
            self.cursor_path,
            json.dumps({"actor_id": self.actor_id,
                        "seq": int(self.seq)}).encode())

    @property
    def tracer(self):
        return (self._tracer if self._tracer is not None
                else observability.get_tracer())

    def poll_weights(self) -> bool:
        """Adopt the newest loadable published epoch if it is newer than
        the one being decoded under. Rebinding the adapter tree is what
        triggers the serving tier's prefix-cache invalidation on every
        replica at its next step: the adopted tree is built from new
        tensors, and the serving tier keys its weight epoch on identity."""
        latest = self.weight_store.latest_epoch()
        if latest is None or latest <= self.weight_epoch:
            return False
        payload = self.weight_store.load_latest_payload()
        if payload is None or int(payload["epoch"]) <= self.weight_epoch:
            return False
        epoch, lora = int(payload["epoch"]), payload["lora"]
        tr = self.tracer
        if tr.enabled:
            # the adoption span parents onto the PUBLISHING learn step's
            # context (rode the weight payload) — the cross-pod stitch of
            # the weight half of the flywheel
            tr.start_span(
                "flywheel.adopt", parent=payload.get("trace"),
                attributes={"actor": self.actor_id,
                            "weight_epoch": int(epoch)}).end()
        self.agent.actor.params = lora_from_numpy(lora, device=self.agent.dev)
        self.weight_epoch = int(epoch)
        self.metrics.gauge(
            "flywheel/actor_weight_epoch",
            help="adapter epoch the rollout pod decodes under").set(epoch)
        self.metrics.emit("flywheel_adopt", actor=self.actor_id,
                          weight_epoch=int(epoch))
        return True

    def _behavior_lp(self, agent, ids, action_masks, completions,
                     completion_mask) -> np.ndarray:
        """Behavior logprobs for the batch: consume the logprobs the serving
        tier captured AT DECODE TIME when they are present and shaped for
        this batch (``capture_logprobs`` generators/fleets publish them in
        ``last_generation_info`` — the decode forward already computed
        them, so the dense recompute is pure waste), else fall back to the
        dense ``behavior_logprobs`` forward unchanged.

        Layout: ``ids = [prompt | completion]`` so completion token j is
        the prediction at position P-1+j — exactly where
        ``assemble_learn_batch`` puts the action mask."""
        info = getattr(agent, "last_generation_info", None) or {}
        dlp = info.get("logprobs")
        ids = np.asarray(ids)
        cmask = np.asarray(completion_mask, np.float32)
        if (dlp is not None and dlp.shape == cmask.shape
                and ids.shape[1] > cmask.shape[1]):
            P = ids.shape[1] - cmask.shape[1]
            out = np.zeros((ids.shape[0], ids.shape[1] - 1), np.float32)
            out[:, P - 1:] = np.asarray(dlp, np.float32) * cmask
            self.metrics.counter(
                "flywheel/logprob_forwards_saved_total",
                help="dense behavior-logprob forwards skipped because the "
                     "serving tier captured logprobs at decode time").inc()
            return out
        return agent.behavior_logprobs(ids, action_masks)

    def rollout_once(self, greedy: bool = False) -> TrajectoryBatch:
        """ONE group-batch rollout: generate ``group_size`` completions per
        prompt, record the behavior logprobs, score rewards, publish the
        tagged batch, and carry the env's next prompt batch (the same
        cross-step prompt stream contract as the interleaved loop)."""
        if self.weight_epoch < 0:
            raise RuntimeError(
                "rollout pod has no adopted weight epoch; the learner must "
                "publish its initial adapter (epoch 0) and poll_weights() "
                "must run before the first rollout")
        if self.autoscaler is not None and self.fleet is not None:
            self.autoscaler.apply(self.fleet)
        t0 = time.perf_counter()
        env, agent = self.env, self.agent
        tr = self.tracer
        with tr.span("flywheel.rollout", actor=self.actor_id, seq=self.seq,
                     weight_epoch=self.weight_epoch) as rsp:
            if self._prompts is None:
                self._prompts = env.reset()
            prompts = self._prompts
            data_epoch = int(env.num_epochs)
            completions, completion_mask = agent.get_action(
                prompts, training=not greedy)
            ids, action_masks = env.assemble_learn_batch(
                completions, completion_mask)
            behavior_lp = self._behavior_lp(
                agent, ids, action_masks, completions, completion_mask)
            next_prompts, rewards = env.step(completions, completion_mask)
            self._prompts = next_prompts
            batch = TrajectoryBatch(
                seq=self.seq, actor_id=self.actor_id,
                weight_epoch=self.weight_epoch, data_epoch=data_epoch,
                ids=np.asarray(ids), action_masks=np.asarray(action_masks),
                rewards=np.asarray(rewards), behavior_lp=behavior_lp,
                prompt_hashes=_prompt_hashes(prompts))
            # existing provenance tags double as span attributes: the
            # per-prompt sha1s and the epoch line the batch decoded under
            rsp.set_attributes(data_epoch=data_epoch,
                               prompt_sha1=list(batch.prompt_hashes))
            self.seq += 1
            # cursor BEFORE publish: crash in between skips a seq (safe);
            # the reverse order could replay a published seq after respawn
            self._commit_cursor()
            with tr.span("flywheel.publish", seq=batch.seq) as psp:
                batch.trace_ctx = tr.inject(psp)
                self.traj_store.publish(batch)
        self.metrics.counter(
            "flywheel/rollout_tokens_total",
            help="completion tokens decoded by rollout pods").inc(
            int(np.asarray(completion_mask).sum()))
        self.metrics.histogram("flywheel/rollout_s").observe(
            time.perf_counter() - t0)
        return batch


class LearnerPod:
    """The learn side: consumes trajectory batches, enforces the staleness
    drop policy, runs the importance-corrected sharded update, and
    publishes a new adapter epoch per learn step.

    ``plan``/``mesh`` (a sharded learner) raise ``NotImplementedError``
    until the distribution slice. ``importance_correction=False`` disables
    the rho term (ablation knob); the staleness DROP policy still applies."""

    def __init__(
        self,
        agent,
        weight_store: WeightStore,
        traj_store: TrajectoryStore,
        max_staleness_epochs: int = 2,
        rho_clip: float = 2.0,
        importance_correction: bool = True,
        metrics=None,
        plan=None,
        mesh=None,
        publish_initial: bool = True,
        tracer=None,
        carry_state: bool = False,
    ):
        if max_staleness_epochs < 0:
            raise ValueError("max_staleness_epochs must be >= 0")
        self.agent = agent
        self.weight_store = weight_store
        self.traj_store = traj_store
        self.max_staleness_epochs = int(max_staleness_epochs)
        self.rho_clip = float(rho_clip)
        self.importance_correction = bool(importance_correction)
        self.metrics = (metrics if metrics is not None
                        else observability.get_registry())
        self._tracer = tracer
        #: ship the full learner state (optimizer, reference adapter, RNG
        #: streams, loss history) INSIDE every weight-epoch payload so a
        #: respawned learner process warm-restarts from the store alone —
        #: the process launcher's kill -9 recovery path
        self.carry_state = bool(carry_state)
        if plan is not None or mesh is not None:
            raise NotImplementedError(
                "LearnerPod plan= / mesh= is not ported yet (distribution slice)")
        self.epoch = 0
        self.losses: List[float] = []
        self.kls: List[float] = []
        self.trained_seqs: List[int] = []
        self.dropped_seqs: List[int] = []
        self.tokens_trained = 0  # sequence tokens through learn steps
        self._last_step_end: Optional[float] = None
        if publish_initial:
            # epoch 0 = the initial adapter: actors can adopt and decode
            # before the first learn step ever runs
            self.publish()

    @property
    def learn_calls(self) -> int:
        return len(self.trained_seqs)

    @property
    def tracer(self):
        return (self._tracer if self._tracer is not None
                else observability.get_tracer())

    def _carry_payload(self) -> Dict[str, Any]:
        """Everything beyond the adapter a respawned learner needs to
        continue the EXACT run: optimizer moments, the reference adapter +
        its refresh epoch, both RNG streams, and the history lists the
        loop and telemetry read. Host numpy throughout (the torch generator's
        state as a byte array): the pickle must load without a card."""
        a = self.agent
        return {
            "opt_state": tree_to_numpy(a.optimizer.opt_state),
            "reference": tree_to_numpy(a.reference.params),
            "reference_epoch": int(a._reference_epoch),
            "rng": a.rng_state(),
            "steps": list(a.steps),
            "losses": list(self.losses),
            "kls": list(self.kls),
            "trained_seqs": list(self.trained_seqs),
            "dropped_seqs": list(self.dropped_seqs),
            "tokens_trained": int(self.tokens_trained),
        }

    def publish(self) -> None:
        tr = self.tracer
        extra = ({"learner_state": self._carry_payload()}
                 if self.carry_state else None)
        # the loss stream rides the MANIFEST too: a launcher reads
        # per-epoch losses without unpickling adapter payloads
        meta: Dict[str, Any] = {"learn_calls": self.learn_calls}
        if self.losses:
            meta["loss"] = self.losses[-1]
        with tr.span("flywheel.weight_publish", epoch=self.epoch) as sp:
            # the publish span's context rides the weight payload: the
            # actor's adoption span stitches onto THIS learn step
            self.weight_store.publish(self.epoch, self.agent.actor.params,
                                      meta=meta, trace_ctx=tr.inject(sp),
                                      extra_payload=extra)
        self.metrics.gauge(
            "flywheel/learner_weight_epoch",
            help="newest adapter epoch published by the learner").set(
            self.epoch)

    def restore_from_store(self) -> bool:
        """Warm-restart from the newest loadable weight epoch (the process
        launcher's learner-respawn path). Adopts the published adapter and
        — when the epoch was published with ``carry_state`` — the optimizer
        state, reference adapter, RNG streams, and history lists, so the
        restarted learner continues the exact loss/param stream. Returns
        False when the store holds no loadable epoch (fresh start: the
        caller's ``publish_initial`` epoch-0 publish applies instead)."""
        payload = self.weight_store.load_latest_payload()
        if payload is None:
            return False
        a = self.agent
        a.actor.params = lora_from_numpy(payload["lora"], device=a.dev)
        self.epoch = int(payload["epoch"])
        state = payload.get("learner_state")
        if state:
            a.optimizer.opt_state = tree_from_numpy(state["opt_state"], a.dev)
            a.reference.params = lora_from_numpy(state["reference"], device=a.dev)
            a._reference_epoch = int(state["reference_epoch"])
            a.set_rng_state(state["rng"])
            a.steps = [int(s) for s in state["steps"]]
            self.losses = [float(x) for x in state["losses"]]
            self.kls = [float(x) for x in state["kls"]]
            self.trained_seqs = [int(s) for s in state["trained_seqs"]]
            self.dropped_seqs = [int(s) for s in state["dropped_seqs"]]
            self.tokens_trained = int(state["tokens_trained"])
        self.metrics.counter(
            "flywheel/learner_restores_total",
            help="learner warm-restarts from the weight store").inc()
        self.metrics.emit("flywheel_learner_restore", epoch=self.epoch,
                          carried=bool(state))
        return True

    def step(self, max_batches: Optional[int] = None) -> int:
        """Consume available batches (seq order): train on those within
        the staleness budget (one learn step + weight publish each), drop
        and count the rest. Returns the number of batches CONSUMED
        (trained + dropped); 0 means the learner idled — that wall time is
        accumulated in ``flywheel/learner_idle_s``.

        Consumption is **after** the batch's outcome is durable (the
        weight publish, or the drop decision): a learner killed mid-step
        leaves the in-flight batch in the store, and the respawned
        learner's restored epoch classifies it — lag 0 replays the learn
        with the restored RNG stream (bit-identical), a batch whose learn
        already published drops as stale. Nothing is ever lost OR trained
        twice across a kill."""
        now0 = time.perf_counter()
        entries = self.traj_store.poll_entries(max_batches)
        if not entries:
            if self._last_step_end is not None:
                self.metrics.counter(
                    "flywheel/learner_idle_s",
                    help="wall time the learner waited with no consumable "
                         "trajectory batches").inc(
                    now0 - self._last_step_end)
            self._last_step_end = time.perf_counter()
            return 0
        consumed = 0
        for path, b in sorted(entries,
                              key=lambda e: (e[1].seq, e[1].actor_id)):
            consumed += 1
            lag = self.epoch - int(b.weight_epoch)
            self.metrics.gauge(
                "flywheel/weight_epoch_lag",
                help="learner epoch minus the consumed batch's decode "
                     "epoch").set(lag)
            # negative lag (decoded under an epoch NEWER than the learner's
            # — pre-crash leftovers, or a foreign weight line) is just as
            # untrainable as over-budget lag: the behavior record doesn't
            # belong to any epoch this learner can correct against
            tr = self.tracer
            batch_ctx = getattr(b, "trace_ctx", None)
            if lag < 0 or lag > self.max_staleness_epochs:
                if tr.enabled:
                    # stale drop: anomaly — always sampled, parented onto
                    # the rollout that produced the batch
                    tr.start_span(
                        "flywheel.drop_stale", parent=batch_ctx, force=True,
                        attributes={"seq": int(b.seq), "lag": int(lag),
                                    "max_staleness":
                                        self.max_staleness_epochs}).end()
                self.dropped_seqs.append(int(b.seq))
                self.metrics.counter(
                    "flywheel/trajectories_dropped_stale_total",
                    help="batches dropped for lag outside "
                         "[0, max_staleness_epochs] (never trained on)").inc()
                self.metrics.emit(
                    "flywheel_drop_stale", seq=int(b.seq),
                    actor=int(b.actor_id), lag=int(lag),
                    max_staleness=self.max_staleness_epochs)
                self.traj_store.consume(path)  # the drop IS the outcome
                continue
            with tr.span("flywheel.learn", parent=batch_ctx,
                         seq=int(b.seq), actor=int(b.actor_id),
                         lag=int(lag), weight_epoch=int(b.weight_epoch),
                         data_epoch=int(b.data_epoch)) as lsp:
                # reference refresh rides the batch's dataset-epoch tag —
                # the disaggregated analogue of
                # set_reference_policy(env.num_epochs)
                self.agent.set_reference_policy(int(b.data_epoch))
                loss, kl = self.agent.learn_from_trajectory(
                    b.ids, b.action_masks, b.rewards, b.behavior_lp,
                    attention_mask=b.attention_mask,
                    rho_clip=(self.rho_clip if self.importance_correction
                              else None))
                self.agent.steps[-1] += int(np.asarray(b.rewards).size)
                self.tokens_trained += int(np.asarray(b.ids).size)
                self.losses.append(float(loss))
                self.kls.append(float(kl))
                self.trained_seqs.append(int(b.seq))
                lsp.set_attribute("loss", self.losses[-1])
                self.metrics.counter(
                    "flywheel/learn_steps_total",
                    help="importance-corrected learn steps executed").inc()
                self.epoch += 1
                # inside the learn span: the weight_publish span (and the
                # trace context shipped with the epoch) parents onto it
                self.publish()
            # consume ONLY once the epoch that embodies this batch is
            # committed — the kill-anywhere replay/drop invariant above
            self.traj_store.consume(path)
        self._last_step_end = time.perf_counter()
        return consumed


class OnlineGRPOFlywheel:
    """Single-process loop ticking one rollout pod against one learner
    pod (the CPU emulation; real pods run the same objects in separate
    processes against the same store directories).

    Flow control: the actor is gated only when the store already holds
    ``max_inflight`` unconsumed batches (default ``max_staleness_epochs +
    1`` — anything more would be dropped as stale by construction, so
    producing it is pure waste). A gated tick is a DECODE STALL: counted
    (``flywheel/decode_stalls_total``) and timed
    (``flywheel/decode_stall_s``), because "decode never blocks on learn"
    is this subsystem's acceptance criterion, not an assumption. With
    ``max_staleness_epochs=0`` the gate degenerates to lockstep — the
    synchronous mode the equivalence gate runs."""

    def __init__(self, rollout: RolloutPod, learner: LearnerPod,
                 max_inflight: Optional[int] = None, metrics=None,
                 telemetry_dir: Optional[Union[str, Path]] = None,
                 telemetry_interval_s: float = 10.0):
        self.rollout = rollout
        self.learner = learner
        self.max_inflight = (int(max_inflight) if max_inflight is not None
                             else learner.max_staleness_epochs + 1)
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        self.metrics = (metrics if metrics is not None
                        else observability.get_registry())
        self._last_stall_span_s = float("-inf")  # stall-span 1/s throttle
        #: cross-process telemetry plane: per-pod snapshots of the rollout
        #: and learner registries, merged fleet-wide by TelemetryAggregator
        self._telemetry = []
        if telemetry_dir is not None:
            from agilerl_tpu_torch.observability.export import TelemetryPublisher

            pods = [(f"rollout_{rollout.actor_id}", rollout.metrics),
                    ("learner", learner.metrics)]
            seen = []
            for name, reg in pods:
                # colocated emulation: both pods may share one registry —
                # publish it once, under the first pod name
                if any(reg is r for _, r in seen):
                    continue
                seen.append((name, reg))
                self._telemetry.append(TelemetryPublisher(
                    telemetry_dir, name, reg,
                    interval_s=float(telemetry_interval_s),
                    metrics=self.metrics))

    def can_rollout(self) -> bool:
        return self.rollout.traj_store.pending() < self.max_inflight

    def run(self, max_epochs: int, greedy: bool = False,
            max_ticks: int = 1_000_000) -> None:
        """Tick until the learner has published ``max_epochs`` weight
        epochs (i.e. executed that many learn steps past the initial
        publish)."""
        try:
            self._run_ticks(max_epochs, greedy, max_ticks)
        finally:
            # the final beat runs on EVERY exit — the failure paths (the
            # not-converged RuntimeError, a pod raising mid-tick) are
            # exactly when the aggregate's view of the end-state counters
            # matters most for diagnosis
            for pub in self._telemetry:
                pub.publish(force=True)

    def _run_ticks(self, max_epochs: int, greedy: bool,
                   max_ticks: int) -> None:
        ticks = 0
        while self.learner.epoch < max_epochs:
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError(
                    f"flywheel not converged after {max_ticks} ticks "
                    f"(learner at epoch {self.learner.epoch}/{max_epochs})")
            for pub in self._telemetry:
                pub.publish()
            stalled = not self.can_rollout()
            if stalled:
                tr = self.rollout.tracer
                now_s = time.perf_counter()
                if tr.enabled and now_s - self._last_stall_span_s >= 1.0:
                    # a decode stall is an anomaly in "decode never blocks
                    # on learn" — always sampled, but throttled to ~1/s
                    # (the stall counter/timer stays exact)
                    self._last_stall_span_s = now_s
                    tr.start_span(
                        "flywheel.decode_stall", force=True,
                        attributes={"pending":
                                    self.rollout.traj_store.pending()}).end()
                self.metrics.counter(
                    "flywheel/decode_stalls_total",
                    help="ticks the rollout pod was gated by the "
                         "staleness-derived inflight bound").inc()
                with self.metrics.timer(
                        "flywheel/decode_stall_s",
                        help="wall time decode spent gated on the "
                             "learner"):
                    consumed = self.learner.step()
                # consumed==0 with the gate now OPEN means the poll drained
                # torn entries (counted+consumed, never returned) — a torn
                # batch costs one group of rollouts, it must not wedge the
                # loop; only a still-gated no-consume is a real wedge
                if consumed == 0 and not self.can_rollout():
                    raise RuntimeError(
                        "flywheel wedged: rollout gated at "
                        f"{self.rollout.traj_store.pending()} in-flight "
                        "batches but the learner consumed nothing")
                continue
            self.rollout.poll_weights()
            self.rollout.rollout_once(greedy=greedy)
            self.learner.step()
