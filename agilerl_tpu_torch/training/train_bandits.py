"""Evolutionary contextual-bandit training loop: the port of
``agilerl_tpu/training/train_bandits.py``.

Per generation each agent pulls ``evo_steps`` arms of ``env`` (a host
``BanditEnv``), storing the pulled arm's context and reward, and learns
every ``learn_step`` pulls once the buffer holds a batch; then every agent
is evaluated (``test``) and the population goes through tournament
selection and mutation. Transitions are staged and written to the buffer
``flush_every`` pulls at a time (default 8; a buffer's own cadence is kept);
a learn flushes first. A pull reads the device once (the arm, which the
host env needs) and a learn once (its loss).

The ``telemetry=`` facade gets one ``generation`` event per generation with
the host seconds spent pulling (``act_s``: action and env step), learning
(``learn_s``), evaluating (``eval_s``) and evolving (``evo_s``), the pulls,
the learn calls, fitnesses and mutations. ``checkpoint=`` /
``checkpoint_path``, ``resume`` and ``save_elite`` work as in the JAX
package. ``resilience=`` (``resilience/facade.Resilience``) takes whole-run
snapshots (population, the buffer, the env's and every other random stream,
counters) at the generation boundaries and a final one on a preemption
request; with ``resume`` the run continues from the newest complete
snapshot, the same run bit for bit. ``wb=True`` logs to wandb when it imports.
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


def train_bandits(
    env,
    env_name: str,
    algo: str,
    pop: List,
    memory,
    INIT_HP: Optional[Dict] = None,
    MUT_P: Optional[Dict] = None,
    swap_channels: bool = False,
    max_steps: int = 10_000,
    episode_steps: int = 100,
    evo_steps: int = 500,
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
    seed: Optional[int] = None,
    flush_every: Optional[int] = None,
    resilience=None,
) -> Tuple[List, List[List[float]]]:
    if resume and resilience is None:
        resume_population_from_checkpoint(pop, checkpoint_path)
    telem = init_run_telemetry(wb=wb, config=INIT_HP, telemetry=telemetry)
    telem.attach_evolution(tournament, mutation)
    if seed is not None and hasattr(memory, "seed"):
        memory.seed(seed)
    use_staging = hasattr(memory, "stage")
    if hasattr(memory, "flush_every"):
        if flush_every is not None:
            memory.flush_every = max(int(flush_every), 1)
        elif not getattr(memory, "_flush_every_user_set", False):
            memory.flush_every = 8
    pop_fitnesses: List[List[float]] = [[] for _ in pop]
    total_steps = 0
    checkpoint_count = 0
    generation = 0

    def _counters():
        return {"total_steps": total_steps, "checkpoint_count": checkpoint_count,
                "pop_fitnesses": pop_fitnesses, "generation": generation}

    try:
        if resilience is not None:
            resilience.attach(pop=pop, memory=memory, tournament=tournament, mutation=mutation,
                              telemetry=telem, env=env)
            if resume:
                restored = resilience.resume(_counters())
                total_steps = int(restored["total_steps"])
                checkpoint_count = int(restored["checkpoint_count"])
                pop_fitnesses = [list(f) for f in restored["pop_fitnesses"]]
                generation = int(restored["generation"])
        while np.min([agent.steps[-1] for agent in pop]) < max_steps:
            secs = {"act_s": 0.0, "learn_s": 0.0}
            learn_calls = 0
            for agent in pop:
                if resilience is not None and resilience.abort_generation:
                    break
                context = env.reset()
                regret_free = 0.0
                learn_every = max(agent.learn_step, 1)
                for step in range(max(evo_steps, 1)):
                    t_act = time.perf_counter()
                    arm = agent.get_action(context)
                    next_context, reward = env.step(arm)
                    reward = np.float32(np.asarray(reward).squeeze())
                    regret_free += float(reward)
                    transition = {
                        "obs": np.asarray(context)[int(arm)],
                        "action": np.int32(arm),
                        "reward": reward,
                        "next_obs": np.asarray(next_context)[int(arm)],
                        "done": np.float32(1.0),
                    }
                    if use_staging:
                        memory.stage(transition)
                    else:
                        memory.add(transition)
                    context = next_context
                    total_steps += 1
                    agent.steps[-1] += 1
                    t_learn = time.perf_counter()
                    secs["act_s"] += t_learn - t_act
                    if step % learn_every == 0:
                        if use_staging:
                            memory.flush()
                        if len(memory) >= agent.batch_size:
                            agent.learn(memory.sample(agent.batch_size))
                            learn_calls += 1
                    t_done = time.perf_counter()
                    secs["learn_s"] += t_done - t_learn
                    telem.step(env_steps=1, agent_index=agent.index,
                               host_time_s=t_learn - t_act, device_time_s=t_done - t_learn)
                    if resilience is not None and resilience.abort_generation:
                        break
                if use_staging:
                    memory.flush()
                agent.scores.append(regret_free / max(evo_steps, 1))

            if resilience is not None and resilience.abort_generation:
                resilience.step_boundary(total_steps, _counters(), pop=pop)
                break

            t0 = time.perf_counter()
            fitnesses = [agent.test(env, max_steps=eval_steps or 100, loop=eval_loop)
                         for agent in pop]
            secs["eval_s"] = time.perf_counter() - t0
            for i, f in enumerate(fitnesses):
                pop_fitnesses[i].append(f)
            telem.record_eval(pop, fitnesses)
            telem.log_step({"global_step": total_steps,
                            "eval/mean_fitness": float(np.mean(fitnesses))})
            if verbose:
                print(f"--- steps {total_steps} fitness {[f'{f:.2f}' for f in fitnesses]}")
                print_hyperparams(pop)

            t0 = time.perf_counter()
            if tournament is not None and mutation is not None:
                pop = tournament_selection_and_mutation(
                    pop, tournament, mutation, env_name=env_name, algo=algo,
                    elite_path=elite_path, save_elite=save_elite)
            secs["evo_s"] = time.perf_counter() - t0
            telem.log_step({"generation": generation, "total_steps": total_steps,
                            "pulls": max(evo_steps, 1) * len(pop), "learn_calls": learn_calls,
                            "fitness": [float(f) for f in fitnesses],
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
