"""LLM finetuning loops: the port of ``agilerl_tpu/training/train_llm.py``:
``finetune_llm_reasoning`` (GRPO over a ReasoningGym) and
``finetune_llm_preference`` (DPO over a PreferenceGym), each with the
per-epoch reference refresh, and tournament selection and hyperparameter
mutation every ``evaluation_interval`` steps.

Every hook the JAX loops take runs: ``telemetry=`` (the observability
facade, its step timeline bound to the population's model config so each
step emits MFU), ``resilience=`` and ``resume`` (whole-run snapshots through
``resilience/facade.Resilience``: the population without its frozen base,
each agent's reference adapter, every random stream, the gym's data stream
and, for the reasoning loop, the prompt batch carried to the next step),
``checkpoint_interval`` / ``checkpoint_path`` / ``overwrite_checkpoints``
(self-contained population checkpoints that ``load`` rebuilds from, the
frozen base inside them as host numpy) and ``save_elite`` / ``elite_path``.
``wb=True`` raises until slice 6.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from agilerl_tpu_torch.observability import init_run_telemetry
from agilerl_tpu_torch.resilience.facade import max_fitness
from agilerl_tpu_torch.training.train_on_policy import refuse_unported
from agilerl_tpu_torch.utils.utils import (
    print_hyperparams,
    resume_population_from_checkpoint,
    save_population_checkpoint,
    tournament_selection_and_mutation,
)


def _assert_llm_mutations(mutation) -> None:
    """LLMs only mutate RL hyperparameters."""
    if mutation is None:
        return
    assert mutation.architecture_mut == 0, "architecture mutation must be 0 for LLMs"
    assert mutation.parameters_mut == 0, "parameter mutation must be 0 for LLMs"
    assert mutation.activation_mut == 0, "activation mutation must be 0 for LLMs"


def _boundary(step, counters, pop, fitnesses, stop, resilience, checkpoint_interval,
              checkpoint_path, overwrite_checkpoints) -> bool:
    """The end of a step: a snapshot (cadence, preemption, or the final one
    when the run reached its target) or a legacy population checkpoint.
    Returns True when a preemption asked the loop to exit."""
    last_fitness = None if fitnesses is None else max_fitness(fitnesses)
    if resilience is not None:
        if resilience.step_boundary(step, counters(), pop=pop, fitness=last_fitness):
            return True
        if stop:
            # the state that reached the target is the state on disk
            resilience.snapshot(step, counters(), kind="final", fitness=last_fitness)
    elif checkpoint_interval is not None and checkpoint_path is not None:
        if stop or step % checkpoint_interval == 0:
            save_population_checkpoint(pop, checkpoint_path, overwrite_checkpoints)
    return False


def finetune_llm_reasoning(
    pop: List,
    env,
    INIT_HP: Optional[Dict] = None,
    max_reward: Optional[float] = None,
    wb: bool = False,
    evaluation_interval: int = 10,
    verbose: bool = True,
    accelerator=None,
    checkpoint_interval: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    overwrite_checkpoints: bool = False,
    max_steps: int = 200,
    evo_steps: Optional[int] = None,
    tournament=None,
    mutation=None,
    wandb_api_key: Optional[str] = None,
    save_elite: bool = False,
    elite_path: Optional[str] = None,
    resume: bool = False,
    telemetry=None,
    resilience=None,
) -> Tuple[List, List[List[float]]]:
    """GRPO reasoning finetune. Returns (population, per-agent fitnesses)."""
    _assert_llm_mutations(mutation)
    refuse_unported("finetune_llm_reasoning", wb=wb)
    if resume and resilience is None:
        resume_population_from_checkpoint(pop, checkpoint_path)
    telem = init_run_telemetry(config=INIT_HP, telemetry=telemetry)
    telem.attach_evolution(tournament, mutation)
    if telem.timeline.model_config is None:
        # the population's transformer config lets the timeline emit MFU
        telem.timeline.set_model_config(getattr(pop[0], "model_config", None))
    pop_fitnesses: List[List[float]] = [[] for _ in pop]
    done_steps = 0
    # each env.step returns the NEXT batch, carried as ``prompts``: it
    # belongs to the snapshot (a resumed run that re-reset the env would
    # draw another batch and leave the uninterrupted stream)
    prompts = None

    def _counters():
        return {"done_steps": done_steps, "pop_fitnesses": pop_fitnesses, "prompts": prompts}

    try:
        if resilience is not None:
            resilience.attach(pop=pop, tournament=tournament, mutation=mutation,
                              telemetry=telem, env=env)
            if resume:
                restored = resilience.resume(_counters())
                done_steps = int(restored["done_steps"])
                pop_fitnesses = [list(f) for f in restored["pop_fitnesses"]]
                prompts = restored.get("prompts")
        if prompts is None:
            prompts = env.reset()
        for step in range(done_steps + 1, max_steps + 1):
            for agent in pop:
                agent.set_reference_policy(env.num_epochs)
                completions, completion_mask = agent.get_action(prompts)
                ids, action_masks = env.assemble_learn_batch(completions, completion_mask)
                next_prompts, rewards = env.step(completions, completion_mask)
                loss, kl = agent.learn((ids, action_masks, rewards))
                agent.steps[-1] += int(np.asarray(rewards).size)
                if verbose:
                    print(f"[{step}] agent {agent.index} loss {loss:.4f} "
                          f"reward {np.mean(rewards):.3f}")
                telem.log_step({"train/loss": loss, "train/mean_reward": float(np.mean(rewards)),
                                "agent": agent.index})
                telem.step(tokens=int(np.asarray(ids).size), agent_index=agent.index,
                           metrics={"loss": float(loss)})
                prompts = next_prompts

            stop, fitnesses = False, None
            if step % evaluation_interval == 0:
                fitnesses = [agent.test(env) for agent in pop]
                for i, f in enumerate(fitnesses):
                    pop_fitnesses[i].append(f)
                if verbose:
                    print(f"=== eval @ {step}: {[f'{f:.3f}' for f in fitnesses]}")
                    print_hyperparams(pop)
                telem.record_eval(pop, fitnesses)
                telem.log_step({"eval/mean_fitness": float(np.mean(fitnesses))})
                if tournament is not None and mutation is not None:
                    pop = tournament_selection_and_mutation(
                        pop, tournament, mutation, language_model=True,
                        elite_path=elite_path, save_elite=save_elite)
                stop = max_reward is not None and np.max(fitnesses) >= max_reward
            done_steps = step
            if _boundary(step, _counters, pop, fitnesses, stop, resilience, checkpoint_interval,
                         checkpoint_path, overwrite_checkpoints) or stop:
                break
    finally:
        # a crash escaping the loop must not leak the guard's signal handlers
        # (or an unflushed telemetry sink) into a caller that goes on
        if resilience is not None:
            resilience.close()
        if telemetry is None:
            telem.close()
    return pop, pop_fitnesses


def finetune_llm_preference(
    pop: List,
    env,
    INIT_HP: Optional[Dict] = None,
    max_reward: Optional[float] = None,
    wb: bool = False,
    evaluation_interval: int = 10,
    verbose: bool = True,
    accelerator=None,
    checkpoint_interval: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    overwrite_checkpoints: bool = False,
    max_steps: int = 200,
    tournament=None,
    mutation=None,
    wandb_api_key: Optional[str] = None,
    save_elite: bool = False,
    elite_path: Optional[str] = None,
    resume: bool = False,
    telemetry=None,
    resilience=None,
) -> Tuple[List, List[List[float]]]:
    """DPO preference finetune. Returns (population, per-agent fitnesses)."""
    _assert_llm_mutations(mutation)
    refuse_unported("finetune_llm_preference", wb=wb)
    if resume and resilience is None:
        resume_population_from_checkpoint(pop, checkpoint_path)
    telem = init_run_telemetry(config=INIT_HP, telemetry=telemetry)
    telem.attach_evolution(tournament, mutation)
    if telem.timeline.model_config is None:
        telem.timeline.set_model_config(getattr(pop[0], "model_config", None))
    pop_fitnesses: List[List[float]] = [[] for _ in pop]
    done_steps = 0

    def _counters():
        return {"done_steps": done_steps, "pop_fitnesses": pop_fitnesses}

    try:
        if resilience is not None:
            resilience.attach(pop=pop, tournament=tournament, mutation=mutation,
                              telemetry=telem, env=env)
            if resume:
                restored = resilience.resume(_counters())
                done_steps = int(restored["done_steps"])
                pop_fitnesses = [list(f) for f in restored["pop_fitnesses"]]
        for step in range(done_steps + 1, max_steps + 1):
            batch = env.reset()
            for agent in pop:
                agent.set_reference_policy(env.num_epochs)
                loss, acc = agent.learn(batch)
                agent.steps[-1] += len(batch["chosen_ids"])
                if verbose:
                    print(f"[{step}] agent {agent.index} dpo loss {loss:.4f} acc {acc:.3f}")
                telem.log_step({"train/loss": loss, "train/acc": acc, "agent": agent.index})
                telem.step(tokens=int(np.asarray(batch["chosen_ids"]).size),
                           agent_index=agent.index, metrics={"loss": float(loss)})

            stop, fitnesses = False, None
            if step % evaluation_interval == 0:
                fitnesses = [agent.test(env) for agent in pop]
                for i, f in enumerate(fitnesses):
                    pop_fitnesses[i].append(f)
                if verbose:
                    print(f"=== eval @ {step}: {[f'{f:.3f}' for f in fitnesses]}")
                telem.record_eval(pop, fitnesses)
                telem.log_step({"eval/mean_fitness": float(np.mean(fitnesses))})
                if tournament is not None and mutation is not None:
                    pop = tournament_selection_and_mutation(
                        pop, tournament, mutation, language_model=True,
                        elite_path=elite_path, save_elite=save_elite)
                stop = max_reward is not None and np.max(fitnesses) >= max_reward
            done_steps = step
            if _boundary(step, _counters, pop, fitnesses, stop, resilience, checkpoint_interval,
                         checkpoint_path, overwrite_checkpoints) or stop:
                break
    finally:
        if resilience is not None:
            resilience.close()
        if telemetry is None:
            telem.close()
    return pop, pop_fitnesses
