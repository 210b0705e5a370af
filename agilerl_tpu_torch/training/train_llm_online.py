"""Online GRPO flywheel entry point: the port of
``agilerl_tpu/training/train_llm_online.py``, the disaggregated analogue of
``finetune_llm_reasoning``. Rollout and learner pods exchange adapter epochs
and trajectory batches through atomic commit-dir stores
(``llm/flywheel.py``), with the staleness-aware importance-corrected learn
step. ``max_staleness_epochs=0`` is the synchronous mode, loss-stream
equivalent to the interleaved loop on the same prompt set; larger budgets
let decode run ahead of learn.

``telemetry=`` and ``telemetry_export_dir=`` work as in the reference:
losses route through the ``RunTelemetry`` facade, evaluations feed its
lineage and eval events. ``resilience=`` snapshots the learner agent, its
random streams, the env's data stream and the rollout pod's carried prompt
batch at every evaluation boundary; ``resume`` continues the epoch line from
the newest complete snapshot (post-snapshot weight epochs and trajectory
leftovers are purged and the restored adapter re-published). Not ported
yet, and raising ``NotImplementedError``: ``plan=`` / ``mesh=`` (a sharded
learner) and ``wb=True``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional, Tuple, Union

from agilerl_tpu_torch.llm.flywheel import (
    LearnerPod,
    OnlineGRPOFlywheel,
    RolloutPod,
    TrajectoryStore,
    WeightStore,
)
from agilerl_tpu_torch.observability import init_run_telemetry
from agilerl_tpu_torch.resilience.facade import max_fitness
from agilerl_tpu_torch.training.train_llm import _assert_llm_mutations
from agilerl_tpu_torch.training.train_on_policy import refuse_unported


def finetune_llm_reasoning_online(
    agent,
    env,
    workdir: Union[str, Path],
    INIT_HP: Optional[dict] = None,
    max_reward: Optional[float] = None,
    wb: bool = False,
    evaluation_interval: int = 10,
    verbose: bool = True,
    max_epochs: int = 200,
    max_staleness_epochs: int = 2,
    rho_clip: float = 2.0,
    importance_correction: bool = True,
    keep_weight_epochs: int = 4,
    actor_agent=None,
    fleet=None,
    autoscaler=None,
    plan=None,
    mesh=None,
    mutation=None,
    wandb_api_key: Optional[str] = None,
    resume: bool = False,
    telemetry=None,
    resilience=None,
    telemetry_export_dir=None,
) -> Tuple[object, List[float]]:
    """Disaggregated online GRPO over a ReasoningGym-style env.

    ``agent`` is the LEARNER's GRPO instance. ``actor_agent`` defaults to
    the same object (the colocated single-process emulation); pass a clone
    sharing ``base_params`` for separate pods. ``fleet`` routes rollouts
    through a ServingFleet (with ``autoscaler`` watching its SLO
    telemetry). Returns ``(agent, fitnesses)``."""
    if resume and resilience is None:
        raise ValueError(
            "resume=True requires resilience= (the snapshot defines the "
            "epoch line to continue; without one the fresh learner would "
            "start at epoch 0 under a reused workdir's newer epochs and "
            "drop every batch as negative-lag)")
    _assert_llm_mutations(mutation)
    refuse_unported("finetune_llm_reasoning_online", plan=plan, mesh=mesh, wb=wb)
    telem = init_run_telemetry(config=INIT_HP, telemetry=telemetry)
    if telem.timeline.model_config is None:
        telem.timeline.set_model_config(getattr(agent, "model_config", None))
    workdir = Path(workdir)
    reg = telem.registry
    weight_store = WeightStore(workdir / "weights",
                               keep_last=keep_weight_epochs, metrics=reg,
                               tracer=telem.tracer)
    traj_store = TrajectoryStore(workdir / "trajectories", metrics=reg,
                                 tracer=telem.tracer)
    # a reused workdir's previous-run epochs would out-number the fresh
    # learner's: actors adopt the stale newest adapter, every batch drops
    # with negative lag, and the flywheel spins to max_ticks. Fresh runs start
    # from clean stores.
    weight_store.truncate_above(-1)
    traj_store.clear()
    # explicit tracer pass-through: a RunTelemetry built with trace=...
    # traces the batch lifecycle even when several runs share one process
    learner = LearnerPod(
        agent, weight_store, traj_store,
        max_staleness_epochs=max_staleness_epochs, rho_clip=rho_clip,
        importance_correction=importance_correction, metrics=reg,
        tracer=telem.tracer)
    rollout = RolloutPod(
        actor_agent if actor_agent is not None else agent, env,
        weight_store, traj_store, metrics=reg, fleet=fleet,
        autoscaler=autoscaler, tracer=telem.tracer)
    fly = OnlineGRPOFlywheel(rollout, learner, metrics=reg,
                             telemetry_dir=telemetry_export_dir)

    fitnesses: List[float] = []
    done_epochs = 0
    n_logged = 0
    tokens_logged = 0

    def _counters():
        # the rollout pod's carried prompt batch (each env.step returns the
        # NEXT batch) belongs to the snapshot, as in the interleaved loop
        return {"done_epochs": done_epochs, "pop_fitnesses": [fitnesses],
                "prompts": rollout._prompts}

    try:
        if resilience is not None:
            resilience.attach(pop=[agent], telemetry=telem, env=env)
            if resume:
                restored = resilience.resume(_counters())
                done_epochs = int(restored["done_epochs"])
                fitnesses = list(restored["pop_fitnesses"][0])
                rollout._prompts = restored.get("prompts")
                # continue the epoch line where the snapshot left it: purge
                # post-snapshot weight epochs and pre-crash trajectories,
                # then re-publish so actors adopt the RESTORED adapter
                learner.epoch = done_epochs
                weight_store.truncate_above(done_epochs)
                traj_store.clear()
                learner.publish()
        start = time.time()
        while done_epochs < max_epochs:
            target = min(done_epochs + evaluation_interval, max_epochs)
            fly.run(target)
            done_epochs = learner.epoch
            for loss in learner.losses[n_logged:]:
                telem.log_step({"train/loss": loss, "agent": agent.index})
            n_logged = len(learner.losses)
            telem.step(tokens=learner.tokens_trained - tokens_logged,
                       agent_index=agent.index)
            tokens_logged = learner.tokens_trained
            fitness = agent.test(env)
            fitnesses.append(fitness)
            if verbose:
                recent = learner.losses[-1] if learner.losses else None
                print(f"=== flywheel epoch {done_epochs}: fitness "
                      f"{fitness:.3f} loss {recent} dropped_stale "
                      f"{len(learner.dropped_seqs)}")
            telem.record_eval([agent], [fitness])
            telem.log_step({"eval/mean_fitness": fitness})
            stop = max_reward is not None and fitness >= max_reward
            if resilience is not None:
                last_fitness = max_fitness([fitness])
                if resilience.step_boundary(done_epochs, _counters(), pop=[agent],
                                            fitness=last_fitness):
                    break
                if stop:
                    resilience.snapshot(done_epochs, _counters(), kind="final",
                                        fitness=last_fitness)
            if stop:
                break
        if verbose:
            print(f"flywheel finished {done_epochs} epochs in "
                  f"{time.time() - start:.1f}s (stalls: "
                  f"{int(reg.counter('flywheel/decode_stalls_total').value)},"
                  f" dropped stale: {len(learner.dropped_seqs)})")
    finally:
        # a crash escaping the loop must not leak the guard's signal handlers
        # or leave an unflushed telemetry sink behind
        if resilience is not None:
            resilience.close()
        if telemetry is None:
            telem.close()
    return agent, fitnesses
