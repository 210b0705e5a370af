"""Evolutionary multi-agent off-policy training (MADDPG, MATD3): the port of
``agilerl_tpu/training/train_multi_agent_off_policy.py``.

Per generation each agent steps the dict-API ``env`` for ``evo_steps`` env
steps, staging every transition into a ``MultiAgentReplayBuffer`` (written
``flush_every`` steps at a time, default 8), and learns on a sampled batch
when ``steps % learn_step < num_envs`` once the buffer holds a batch (and
``learning_delay`` rows); the gate and ``len(memory)`` read host counters.
Each step's NaN placeholders are zeroed (``sanitize_ma_transition``), the
stored successor is the env's ``final_obs`` (the observation before an
autoreset) and ``done`` is termination only. Then every agent is evaluated
and the population goes through tournament selection and mutation.

Against a device env (``MultiAgentTorchVecEnv``) actions, rewards and the
staged rows stay on the device: an env step makes no host sync, and a learn
makes one (the loss read of ``learn``). A host env gets numpy actions. The
``telemetry=`` facade gets one ``generation`` event per generation with the
host seconds spent acting and stepping (``act_s``), learning (``learn_s``),
evaluating (``eval_s``) and evolving (``evo_s``), the learn calls, the last
losses, the fitnesses and the mutations. ``checkpoint=`` /
``checkpoint_path``, ``resume`` and ``save_elite`` work as in the JAX
package. ``resilience=``
(``resilience/facade.Resilience``) takes whole-run snapshots at the
generation boundaries and a final one on a preemption request; with
``resume`` the run continues from the newest complete snapshot, the same
run bit for bit. ``wb=True`` raises until slice 6.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer
from agilerl_tpu_torch.observability import init_run_telemetry
from agilerl_tpu_torch.resilience.facade import max_fitness
from agilerl_tpu_torch.rollouts.on_policy import env_action
from agilerl_tpu_torch.training.train_off_policy import _f32
from agilerl_tpu_torch.training.train_on_policy import refuse_unported
from agilerl_tpu_torch.utils.utils import (
    print_hyperparams,
    resume_population_from_checkpoint,
    save_population_checkpoint,
    tournament_selection_and_mutation,
)
from agilerl_tpu_torch.vector.pz_vec_env import sanitize_ma_transition


def train_multi_agent_off_policy(
    env,
    env_name: str,
    algo: str,
    pop: List,
    memory,
    INIT_HP: Optional[Dict] = None,
    MUT_P: Optional[Dict] = None,
    sum_scores: bool = True,
    max_steps: int = 50_000,
    evo_steps: int = 5_000,
    eval_steps: Optional[int] = None,
    eval_loop: int = 1,
    learning_delay: int = 0,
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
    """Returns (population, per-agent fitness histories)."""
    refuse_unported("train_multi_agent_off_policy", wb=wb)
    if not isinstance(memory, ReplayBuffer):
        raise NotImplementedError(
            f"train_multi_agent_off_policy learns from the port's replay buffers "
            f"(components/multi_agent_replay_buffer.py), not a {type(memory).__name__}")
    if resume and resilience is None:
        resume_population_from_checkpoint(pop, checkpoint_path)
    telem = init_run_telemetry(config=INIT_HP, telemetry=telemetry)
    telem.attach_evolution(tournament, mutation)
    if seed is not None:
        memory.seed(seed)
    if flush_every is not None:
        memory.flush_every = max(int(flush_every), 1)
    elif not memory._flush_every_user_set:
        memory.flush_every = 8
    num_envs = getattr(env, "num_envs", 1)
    agent_ids = pop[0].agent_ids
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
        start = time.time()
        while np.min([agent.steps[-1] for agent in pop]) < max_steps:
            secs = {"act_s": 0.0, "learn_s": 0.0}
            learn_calls = 0
            losses = []
            for agent in pop:
                if resilience is not None and resilience.abort_generation:
                    break
                obs, info = env.reset()
                steps = 0
                last_loss = None
                learn_every = max(agent.learn_step, 1)
                for _ in range(max(evo_steps // num_envs, 1)):
                    t_act = time.perf_counter()
                    # action masks / env-defined actions ride the info dict
                    actions = agent.get_action(obs, infos=info)
                    next_obs, reward, terminated, truncated, info = env.step(
                        {a: env_action(env, v) for a, v in actions.items()})
                    next_obs, reward = sanitize_ma_transition(next_obs, reward)
                    done = {a: _f32(terminated[a]) for a in agent_ids}
                    store_next = (info.get("final_obs", next_obs) if isinstance(info, dict)
                                  else next_obs)
                    if store_next is not next_obs:
                        store_next, _ = sanitize_ma_transition(store_next, {})
                    memory.stage_to_memory(obs, actions, {a: _f32(reward[a]) for a in agent_ids},
                                           store_next, done, is_vectorised=num_envs > 1)
                    obs = next_obs
                    steps += num_envs
                    total_steps += num_envs
                    t_learn = time.perf_counter()
                    secs["act_s"] += t_learn - t_act
                    if steps % learn_every < num_envs:
                        memory.flush()
                        if len(memory) >= agent.batch_size and len(memory) >= learning_delay:
                            learn_calls += 1
                            last_loss = agent.learn(memory.sample(agent.batch_size))
                    t_done = time.perf_counter()
                    secs["learn_s"] += t_done - t_learn
                    telem.step(env_steps=num_envs, agent_index=agent.index,
                               host_time_s=t_done - t_learn, device_time_s=t_learn - t_act)
                    if resilience is not None and resilience.abort_generation:
                        break
                memory.flush()
                if last_loss is not None:
                    losses.append(last_loss)
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
                            "learn_calls": learn_calls, "last_losses": losses,
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
