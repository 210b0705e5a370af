"""Evolutionary off-policy training loop: the port of
``agilerl_tpu/training/train_off_policy.py``.

Per generation each agent steps ``env`` for ``evo_steps`` env steps,
storing every transition (the n-step variant stores folded and raw rows in
two index-aligned rings) and learning every ``learn_step`` steps once the
buffer holds a batch; then every agent is evaluated, and the population
goes through tournament selection and mutation.

Transitions are staged and written ``flush_every`` steps at a time
(default 8); learning goes through the agent's ``learn_from_buffer``
(sample, learn and PER write-back in one call, no host sync, the loss left
on the device). An agent without a fused learn for the buffer (DDPG and TD3
under PER) takes the JAX loop's second path, ``sampled_learn``:
``Sampler.sample`` + ``learn`` + ``update_priorities`` when ``learn``
returns priorities; its ``learn`` reads the loss on the host, one sync per
learn. A buffer that is not one of the port's is refused. Against a device
env (``TorchVecEnv``)
actions, rewards, episode returns and the staged rows stay on the device,
so an env step makes no host sync; the loop reads the device once per
agent and generation (the last loss and the mean episode return). Against
a host env the action is read on the host each step, the one sync per
step. ``merge_final_obs`` stores the true successor of a step that ended
an episode (the env's ``final_obs``), and a gymnasium env that autoresets
on the NEXT step (``autoreset_mode``) has its filler rows dropped or, in
the n-step variant, replaced by the env's previous row.

The ``telemetry=`` facade gets one ``generation`` event per generation
with the host seconds spent acting and stepping the env (``act_s``),
staging and dispatching the learn steps (``learn_s``), waiting for the
device at the end of each agent's run (``sync_s``), evaluating (``eval_s``)
and evolving (``evo_s``), the learn calls, fitnesses and mutations.
``checkpoint=`` / ``checkpoint_path``, ``resume`` and ``save_elite`` work
as in the JAX package. ``resilience=`` (``resilience/facade.Resilience``)
takes whole-run snapshots at the generation boundaries (population, replay
rings, every random stream, counters, lineage) and a final one on a
preemption request; with ``resume`` the run continues from the newest
complete snapshot, the same run bit for bit. ``wb=True`` raises until
slice 6.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer, drain_staging
from agilerl_tpu_torch.components.sampler import Sampler
from agilerl_tpu_torch.observability import init_run_telemetry
from agilerl_tpu_torch.resilience import max_fitness
from agilerl_tpu_torch.rollouts.on_policy import env_action
from agilerl_tpu_torch.training.train_on_policy import refuse_unported
from agilerl_tpu_torch.utils.spaces import as_tensor
from agilerl_tpu_torch.utils.tree import tree_map
from agilerl_tpu_torch.utils.utils import (
    print_hyperparams,
    resume_population_from_checkpoint,
    save_population_checkpoint,
    tournament_selection_and_mutation,
)


def _rows_where(mask, a, b):
    """``a`` where the per-env ``mask`` is set, else ``b`` (tensors or numpy)."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        a_t = as_tensor(a)
        b_t = as_tensor(b, a_t.device)
        m = as_tensor(mask, a_t.device).bool()
        return torch.where(m.view(m.shape + (1,) * (a_t.dim() - m.dim())), a_t, b_t)
    a, b = np.asarray(a), np.asarray(b)
    m = np.asarray(mask, bool)
    return np.where(m.reshape(m.shape + (1,) * max(a.ndim - m.ndim, 0)), a, b)


def merge_final_obs(next_obs, final_obs, done):
    """The bootstrap target's obs: ``final_obs`` where ``done``, else
    ``next_obs``. A gymnasium same-step autoreset env gives ``final_obs``
    as an object array with None for the envs that are not done; a dense
    ``final_obs`` (numpy, or tensors of a device env, merged by
    ``torch.where`` on the device) equals ``next_obs`` where not done."""
    if final_obs is None:
        return next_obs
    if isinstance(final_obs, np.ndarray) and final_obs.dtype == object:
        done = np.atleast_1d(np.asarray(done)).astype(bool)
        if isinstance(next_obs, dict):
            out = {k: np.array(v, copy=True) for k, v in next_obs.items()}
            for i, f in enumerate(final_obs):
                if f is not None and done[i]:
                    for k in out:
                        out[k][i] = np.asarray(f[k])
            return out
        out = np.array(next_obs, copy=True)
        for i, f in enumerate(final_obs):
            if f is not None and done[i]:
                out[i] = np.asarray(f)
        return out
    if not isinstance(done, torch.Tensor):
        done = np.atleast_1d(np.asarray(done)).astype(bool)

    def merge(n, f):
        if tuple(n.shape) != tuple(f.shape):
            return n
        return _rows_where(done, f, n)

    return tree_map(merge, next_obs, final_obs)


def _substitute_rows(transition, prev_transition, mask):
    """``transition`` with the rows where ``mask`` is set taken from
    ``prev_transition`` (obs leaves may be trees)."""

    def sub(tv, pv):
        if not isinstance(tv, torch.Tensor) and np.ndim(tv) == 0:
            return pv if np.asarray(mask).reshape(-1)[0] else tv
        return _rows_where(mask, pv, tv)

    return tree_map(sub, transition, prev_transition)


def _f32(x):
    return x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _logical_or(a, b):
    if isinstance(a, torch.Tensor):
        return torch.logical_or(a.bool(), as_tensor(b, a.device).bool())
    return np.logical_or(a, b)


def sampled_learn(agent, sampler: Sampler, memory, per: bool, draws=None):
    """The JAX loop's learn path for an agent without a fused learn
    (``train_off_policy.py:313-331``): under PER, ``sampler.sample`` at
    ``beta = agent.beta`` (0.4 when the agent has none), ``agent.learn`` on
    the tuple, then ``memory.update_priorities`` where ``learn`` returned
    priorities; else ``agent.learn`` on a uniform sample. ``draws`` stand in
    for the memory's own (PER's uniforms, or the indices). Returns the loss."""
    if per:
        sampled = sampler.sample(agent.batch_size, beta=getattr(agent, "beta", None),
                                 draws=draws)
        result = agent.learn(sampled)
        new_priorities = result[1] if isinstance(result, tuple) else None
        if new_priorities is not None:
            memory.update_priorities(sampled[1], new_priorities)
        return result[0] if isinstance(result, tuple) else result
    result = agent.learn(sampler.sample(agent.batch_size, draws=draws))
    return result[0] if isinstance(result, tuple) else result


class _EpisodeScores:
    """Per-env running returns and the finished episodes' sum and count, on
    ``device`` (the env's; a host env's on the CPU), read once."""

    def __init__(self, num_envs: int, device):
        self.device = device
        self.scores = torch.zeros(num_envs, dtype=torch.float64, device=device)
        self.fin_sum = torch.zeros((), dtype=torch.float64, device=device)
        self.fin_n = torch.zeros((), dtype=torch.float64, device=device)

    def add(self, reward, done) -> None:
        self.scores = self.scores + as_tensor(reward, self.device).double().reshape(-1)
        d = as_tensor(done, self.device).bool().reshape(-1)
        self.fin_sum = self.fin_sum + torch.sum(self.scores * d)
        self.fin_n = self.fin_n + torch.sum(d)
        self.scores = torch.where(d, 0.0, self.scores)

    def mean(self) -> float:
        """The mean finished return, or the mean running one if none
        finished (one read)."""
        return float(torch.where(self.fin_n > 0, self.fin_sum / torch.clamp(self.fin_n, min=1),
                                 self.scores.mean()))


def train_off_policy(
    env,
    env_name: str,
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
    learning_delay: int = 0,
    eps_start: float = 1.0,
    eps_end: float = 0.1,
    eps_decay: float = 0.995,
    target: Optional[float] = None,
    n_step: bool = False,
    per: bool = False,
    n_step_memory=None,
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
    refuse_unported("train_off_policy", wb=wb)
    if not isinstance(memory, ReplayBuffer):
        raise NotImplementedError(
            f"train_off_policy learns from the port's replay buffers "
            f"(components/replay_buffer.py), not a {type(memory).__name__}")
    if resume and resilience is None:
        resume_population_from_checkpoint(pop, checkpoint_path)
    telem = init_run_telemetry(config=INIT_HP, telemetry=telemetry)
    telem.attach_evolution(tournament, mutation)
    if seed is not None:
        if hasattr(memory, "seed"):
            memory.seed(seed)
        if n_step_memory is not None and hasattr(n_step_memory, "seed"):
            n_step_memory.seed(seed + 1)
    use_staging = hasattr(memory, "stage") and (
        not (n_step and n_step_memory is not None) or hasattr(n_step_memory, "stage"))
    for buf in (memory, n_step_memory):
        if buf is None or not hasattr(buf, "flush_every"):
            continue
        if flush_every is not None:
            buf.flush_every = max(int(flush_every), 1)
        elif not getattr(buf, "_flush_every_user_set", False):
            buf.flush_every = 8
    paired = n_step_memory if n_step else None
    sampler = Sampler(memory=memory, per=per, n_step_memory=paired)
    num_envs = getattr(env, "num_envs", 1)
    batched = num_envs > 1
    env_dev = getattr(env, "device", None)
    device_env = isinstance(env_dev, torch.device)
    # gymnasium >= 1.0 vector envs autoreset on the NEXT step: the step after
    # a done ignores its action and returns (reset obs, reward 0); such rows
    # must not be stored. TorchVecEnv autoresets on the same step.
    next_step_autoreset = "NEXT_STEP" in str(getattr(env, "autoreset_mode", ""))
    epsilon = eps_start
    pop_fitnesses: List[List[float]] = [[] for _ in pop]
    total_steps = 0
    checkpoint_count = 0
    generation = 0

    def _counters():
        return {"total_steps": total_steps, "checkpoint_count": checkpoint_count,
                "epsilon": epsilon, "pop_fitnesses": pop_fitnesses, "generation": generation}

    try:
        if resilience is not None:
            resilience.attach(pop=pop, memory=memory, n_step_memory=paired,
                              tournament=tournament, mutation=mutation, telemetry=telem, env=env)
            if resume:
                restored = resilience.resume(_counters())
                total_steps = int(restored["total_steps"])
                checkpoint_count = int(restored["checkpoint_count"])
                epsilon = float(restored["epsilon"])
                pop_fitnesses = [list(f) for f in restored["pop_fitnesses"]]
                generation = int(restored["generation"])
        start = time.time()
        while np.min([agent.steps[-1] for agent in pop]) < max_steps:
            secs = {"act_s": 0.0, "learn_s": 0.0, "sync_s": 0.0}
            learn_calls = 0
            losses = []
            for agent in pop:
                if resilience is not None and resilience.abort_generation:
                    break
                obs, info = env.reset()
                prev_done = np.zeros(num_envs, dtype=bool)
                prev_transition = None
                if paired is not None:
                    # no fold spans the reset or the previous agent's steps
                    n_step_memory.reset_horizon()
                pending_loss = None
                scores = _EpisodeScores(num_envs, env_dev if device_env else "cpu")
                steps = 0
                learn_every = max(agent.learn_step, 1)
                fused = hasattr(agent, "learn_from_buffer") and (
                    not per or getattr(agent, "supports_fused_per", False))
                for _ in range(max(evo_steps // num_envs, 1)):
                    t_act = time.perf_counter()
                    action_mask = info.get("action_mask") if isinstance(info, dict) else None
                    action = agent.get_action(obs, epsilon=epsilon, action_mask=action_mask)
                    taken = env_action(env, action)
                    next_obs, reward, terminated, truncated, info = env.step(taken)
                    done = _logical_or(terminated, truncated)
                    final = (info.get("final_obs", info.get("final_observation"))
                             if isinstance(info, dict) else None)
                    scores.add(reward, done)
                    transition = {"obs": obs, "action": action if device_env else taken,
                                  "reward": _f32(reward),
                                  "next_obs": merge_final_obs(next_obs, final, done),
                                  "done": _f32(terminated)}
                    if paired is not None:
                        # _boundary stops folds at truncations and autoresets
                        transition["_boundary"] = _f32(done)
                        if next_step_autoreset and prev_done.any() and prev_transition:
                            # the filler row after a done becomes a duplicate of
                            # the env's previous (episode-ending) row: its
                            # _boundary keeps folds frozen, the rings aligned
                            transition = _substitute_rows(transition, prev_transition,
                                                          prev_done)
                        prev_transition = transition
                        if use_staging:
                            n_step_memory.stage(transition, batched=batched)
                        else:
                            one_step = n_step_memory.add(transition, batched=batched)
                            if one_step is not None:
                                memory.add(one_step, batched=batched)
                    elif next_step_autoreset and prev_done.any():
                        keep = np.where(~prev_done)[0]
                        if keep.size:
                            kept = tree_map(lambda v: v[keep], transition)
                            (memory.stage if use_staging else memory.add)(kept, batched=True)
                    elif use_staging:
                        memory.stage(transition, batched=batched)
                    else:
                        memory.add(transition, batched=batched)
                    if next_step_autoreset:
                        prev_done = np.atleast_1d(np.asarray(done)).astype(bool)
                    obs = next_obs
                    steps += num_envs
                    total_steps += num_envs
                    epsilon = max(eps_end, epsilon * eps_decay)

                    t_learn = time.perf_counter()
                    secs["act_s"] += t_learn - t_act
                    if steps % learn_every < num_envs:
                        # drain the staging so the warm-up gate counts every row
                        drain_staging(memory, paired)
                        if len(memory) >= agent.batch_size and len(memory) >= learning_delay:
                            learn_calls += 1
                            pending_loss = (agent.learn_from_buffer(memory, paired) if fused
                                            else sampled_learn(agent, sampler, memory, per))
                    t_done = time.perf_counter()
                    secs["learn_s"] += t_done - t_learn
                    telem.step(env_steps=num_envs, agent_index=agent.index,
                               host_time_s=t_done - t_learn, device_time_s=t_learn - t_act)
                    if resilience is not None and resilience.abort_generation:
                        break  # the final snapshot is taken at the boundary below

                # the agent's one wait on the device: the last loss and its returns
                drain_staging(memory, paired)
                t_sync = time.perf_counter()
                if pending_loss is not None:
                    losses.append(float(pending_loss))
                agent.steps[-1] += steps
                agent.scores.append(scores.mean())
                secs["sync_s"] += time.perf_counter() - t_sync

            if resilience is not None and resilience.abort_generation:
                # on_preempt="now": the final snapshot mid-generation, without
                # the eval and the evolution; under "finish_generation" the
                # boundary below takes it instead
                resilience.step_boundary(total_steps, _counters(), pop=pop)
                break

            t0 = time.perf_counter()
            fitnesses = [agent.test(env, swap_channels=swap_channels, max_steps=eval_steps,
                                    loop=eval_loop) for agent in pop]
            secs["eval_s"] = time.perf_counter() - t0
            for i, f in enumerate(fitnesses):
                pop_fitnesses[i].append(f)
            telem.record_eval(pop, fitnesses)
            fps = total_steps / (time.time() - start)
            telem.log_step({"global_step": total_steps, "fps": fps,
                            "eval/mean_fitness": float(np.mean(fitnesses)),
                            "pipeline/sync_wait_s": secs["sync_s"]})
            if verbose:
                print(f"--- steps {total_steps} fps {fps:.0f} eps {epsilon:.3f} "
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
                # cadence snapshot when due; the final one and a clean exit
                # when a preemption was requested
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
        # a crash escaping the loop must not leak the guard's signal handlers
        if resilience is not None:
            resilience.close()
        if telemetry is None:
            telem.close()
    return pop, pop_fitnesses
