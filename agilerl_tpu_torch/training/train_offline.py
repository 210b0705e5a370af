"""Offline RL training from a fixed dataset: the port of
``agilerl_tpu/training/train_offline.py`` (the dataset into the buffer once,
then per generation ``evo_steps // learn_step`` learns of each agent on
uniform samples, evaluation in ``env``, tournament selection and mutation).

The dataset is a dict of arrays (numpy, an ``h5py.File``, or the output of
``utils/minari_utils``); it is written into ``memory`` once, as one batched
add, when the buffer is empty (a resumed buffer keeps its rows). Each learn
is the agent's ``learn`` on ``memory.sample``, which reads its loss on the
host (one sync per learn, as in the JAX loop). ``checkpoint=`` /
``checkpoint_path``, ``resume`` and ``save_elite`` work as in the JAX
package, through the population checkpoints of ``utils/utils.py``.
``resilience=`` (``resilience/facade.Resilience``) takes whole-run
snapshots (population, the buffer, every random stream, counters) at the
generation boundaries and a final one on a preemption request; with
``resume`` the run continues from the newest complete snapshot (a restored
buffer skips the dataset's ingest). ``wb=True`` raises until slice 6.
"""

from __future__ import annotations

import time
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


def train_offline(
    env,
    env_name: str,
    dataset,
    algo: str,
    pop: List,
    memory,
    INIT_HP: Optional[Dict] = None,
    MUT_P: Optional[Dict] = None,
    swap_channels: bool = False,
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
    """``dataset``: observations / actions / rewards / next_observations /
    terminals arrays. Returns (population, per-agent fitness histories)."""
    refuse_unported("train_offline", wb=wb)
    if resume and resilience is None:
        resume_population_from_checkpoint(pop, checkpoint_path)
    telem = init_run_telemetry(config=INIT_HP, telemetry=telemetry)
    telem.attach_evolution(tournament, mutation)

    pop_fitnesses: List[List[float]] = [[] for _ in pop]
    total_steps = 0
    checkpoint_count = 0

    def _counters():
        return {"total_steps": total_steps, "checkpoint_count": checkpoint_count,
                "pop_fitnesses": pop_fitnesses}

    try:
        if resilience is not None:
            resilience.attach(pop=pop, memory=memory, tournament=tournament, mutation=mutation,
                              telemetry=telem, env=env)
            if resume:
                # a restored buffer skips the dataset's ingest below
                restored = resilience.resume(_counters())
                total_steps = int(restored["total_steps"])
                checkpoint_count = int(restored["checkpoint_count"])
                pop_fitnesses = [list(f) for f in restored["pop_fitnesses"]]
        if len(memory) == 0:
            memory.add({"obs": np.asarray(dataset["observations"]),
                        "action": np.asarray(dataset["actions"]).squeeze(),
                        "reward": np.asarray(dataset["rewards"], np.float32).squeeze(),
                        "next_obs": np.asarray(dataset["next_observations"]),
                        "done": np.asarray(dataset["terminals"], np.float32).squeeze()},
                       batched=True)
        start = time.time()
        while np.min([agent.steps[-1] for agent in pop]) < max_steps:
            for agent in pop:
                if resilience is not None and resilience.abort_generation:
                    break
                for _ in range(max(evo_steps // max(agent.learn_step, 1), 1)):
                    agent.learn(memory.sample(agent.batch_size))
                    agent.steps[-1] += agent.learn_step
                    total_steps += agent.learn_step
                    telem.step(env_steps=agent.learn_step, agent_index=agent.index)
                    if resilience is not None and resilience.abort_generation:
                        break
            if resilience is not None and resilience.abort_generation:
                resilience.step_boundary(total_steps, _counters(), pop=pop)
                break

            fitnesses = [agent.test(env, swap_channels=swap_channels, max_steps=eval_steps,
                                    loop=eval_loop) for agent in pop]
            for i, f in enumerate(fitnesses):
                pop_fitnesses[i].append(f)
            telem.record_eval(pop, fitnesses)
            telem.log_step({"global_step": total_steps,
                            "eval/mean_fitness": float(np.mean(fitnesses))})
            if verbose:
                print(f"--- steps {total_steps} ({total_steps / (time.time() - start):.0f} "
                      f"learn steps/s) fitness {[f'{f:.1f}' for f in fitnesses]}")
                print_hyperparams(pop)

            if tournament is not None and mutation is not None:
                pop = tournament_selection_and_mutation(
                    pop, tournament, mutation, env_name=env_name, algo=algo,
                    elite_path=elite_path, save_elite=save_elite)
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
