"""Evolutionary multi-agent on-policy training (IPPO): the port of
``agilerl_tpu/training/train_multi_agent_on_policy.py``.

Per generation every agent runs ``evo_steps // (learn_step * num_envs)``
rounds (at least one) of ``collect_rollouts`` (one host sync each) and
``learn`` (one each), from fresh episodes; then every agent is evaluated
and the population goes through tournament selection and mutation. The
``telemetry=`` facade gets one ``generation`` event per generation with the
host seconds spent collecting, learning, evaluating and evolving, the
learn calls, the fitnesses and the mutations. ``checkpoint=`` /
``checkpoint_path``, ``resume`` and ``save_elite`` work as in the JAX
package. ``resilience=``
(``resilience/facade.Resilience``) takes whole-run snapshots at the
generation boundaries and a final one on a preemption request; with
``resume`` the run continues from the newest complete snapshot, the same
run bit for bit. ``wb=True`` logs to wandb when it imports.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from agilerl_tpu_torch.observability import init_run_telemetry
from agilerl_tpu_torch.resilience.facade import max_fitness
from agilerl_tpu_torch.utils.utils import (
    print_hyperparams,
    resume_population_from_checkpoint,
    save_population_checkpoint,
    tournament_selection_and_mutation,
)


def train_multi_agent_on_policy(
    env,
    env_name: str,
    algo: str,
    pop: List,
    INIT_HP: Optional[Dict] = None,
    MUT_P: Optional[Dict] = None,
    sum_scores: bool = True,
    max_steps: int = 50_000,
    evo_steps: int = 5_000,
    eval_steps: Optional[int] = None,
    eval_loop: int = 1,
    target: Optional[float] = None,
    tournament=None,
    mutation=None,
    checkpoint: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    overwrite_checkpoints: bool = False,
    save_elite: bool = False,
    elite_path: Optional[str] = None,
    wb: bool = False,
    verbose: bool = True,
    accelerator=None,
    wandb_api_key: Optional[str] = None,
    resume: bool = False,
    telemetry=None,
    resilience=None,
) -> Tuple[List, List[List[float]]]:
    """Returns (population, per-agent fitness histories)."""
    if resume and resilience is None:
        resume_population_from_checkpoint(pop, checkpoint_path)
    telem = init_run_telemetry(wb=wb, config=INIT_HP, telemetry=telemetry)
    telem.attach_evolution(tournament, mutation)
    num_envs = getattr(env, "num_envs", 1)
    pop_fitnesses: List[List[float]] = [[] for _ in pop]
    total_steps = 0
    checkpoint_count = 0
    generation = 0

    def _counters():
        return {"total_steps": total_steps, "checkpoint_count": checkpoint_count,
                "pop_fitnesses": pop_fitnesses, "generation": generation}

    try:
        if resilience is not None:
            resilience.attach(pop=pop, tournament=tournament, mutation=mutation,
                              telemetry=telem, env=env)
            if resume:
                restored = resilience.resume(_counters())
                total_steps = int(restored["total_steps"])
                checkpoint_count = int(restored["checkpoint_count"])
                pop_fitnesses = [list(f) for f in restored["pop_fitnesses"]]
                generation = int(restored["generation"])
        start = time.time()
        while np.min([agent.steps[-1] for agent in pop]) < max_steps:
            secs = {"collect_s": 0.0, "learn_s": 0.0}
            learn_calls = 0
            for agent in pop:
                if resilience is not None and resilience.abort_generation:
                    break
                steps = 0
                agent._last_obs = None  # fresh episodes per generation
                for _ in range(max(evo_steps // (agent.learn_step * num_envs), 1)):
                    t0 = time.perf_counter()
                    agent.collect_rollouts(env, n_steps=agent.learn_step)
                    t1 = time.perf_counter()
                    agent.learn()
                    secs["collect_s"] += t1 - t0
                    secs["learn_s"] += time.perf_counter() - t1
                    learn_calls += 1
                    steps += agent.learn_step * num_envs
                    total_steps += agent.learn_step * num_envs
                    telem.step(env_steps=agent.learn_step * num_envs, agent_index=agent.index)
                    if resilience is not None and resilience.abort_generation:
                        break
                agent.steps[-1] += steps

            if resilience is not None and resilience.abort_generation:
                resilience.step_boundary(total_steps, _counters(), pop=pop)
                break

            t0 = time.perf_counter()
            fitnesses = [agent.test(env, max_steps=eval_steps, loop=eval_loop,
                                    sum_scores=sum_scores) for agent in pop]
            secs["eval_s"] = time.perf_counter() - t0
            for i, f in enumerate(fitnesses):
                pop_fitnesses[i].append(f)
            telem.record_eval(pop, fitnesses)
            fps = total_steps / (time.time() - start)
            telem.log_step({"global_step": total_steps, "fps": fps,
                            "eval/mean_fitness": float(np.mean(fitnesses))})
            if verbose:
                print(f"--- steps {total_steps} fps {fps:.0f} "
                      f"fitness {[f'{f:.1f}' for f in fitnesses]}")
                print_hyperparams(pop)

            t0 = time.perf_counter()
            if tournament is not None and mutation is not None:
                pop = tournament_selection_and_mutation(
                    pop, tournament, mutation, env_name=env_name, algo=algo,
                    elite_path=elite_path, save_elite=save_elite)
            secs["evo_s"] = time.perf_counter() - t0
            telem.log_step({"generation": generation, "total_steps": total_steps,
                            "learn_calls": learn_calls, "fitness": [float(f) for f in fitnesses],
                            "mutations": [str(a.mut) for a in pop], **secs},
                           kind="generation")
            generation += 1

            for agent in pop:
                agent.steps.append(agent.steps[-1])
            if resilience is not None:
                if resilience.step_boundary(total_steps, _counters(), pop=pop,
                                            fitness=max_fitness(fitnesses)):
                    break
            elif checkpoint is not None and checkpoint_path is not None:
                if total_steps // checkpoint > checkpoint_count:
                    save_population_checkpoint(pop, checkpoint_path, overwrite_checkpoints)
                    checkpoint_count = total_steps // checkpoint
            if target is not None and np.min(fitnesses) >= target:
                break
    finally:
        if resilience is not None:
            resilience.close()
        if telemetry is None:
            telem.close()
    return pop, pop_fitnesses
