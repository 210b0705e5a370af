"""Rollout collection into the RolloutBuffer: the port of
``agilerl_tpu/rollouts/on_policy.py``.

Against a device env (``TorchVecEnv``) actions, rewards and dones stay on
the device for the whole call: the truncation bootstrap is folded in on
every step, masked by ``truncated & ~terminated`` (the JAX package's ``if
truncated.any()`` without its sync), the reward is summed on the device,
and the call syncs once, for the mean reward it returns. Envs with a host
API (gymnasium vector envs) get numpy actions.

One deviation from the JAX package: a step that both terminates and
truncates (an episode that ends on its last allowed step; the autoreset
flags it truncated, as gymnasium's ``TimeLimit`` does) gets no
``gamma * V(final_obs)``. The JAX package bootstraps it on ``truncated``
alone, which adds a value to a terminal reward (``MemoryEnv``, whose every
episode ends at its limit, then reads a mean step reward near 3 where a
step earns at most 1/3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from agilerl_tpu_torch.utils.spaces import as_tensor
from agilerl_tpu_torch.utils.tree import tree_map


def env_action(env, action: torch.Tensor):
    """The action as the env takes it: the tensor for an env on a device,
    host numpy for any other env."""
    if isinstance(getattr(env, "device", None), torch.device):
        return action
    return action.detach().cpu().numpy()


def collect_rollouts(agent, env, n_steps: Optional[int] = None) -> float:
    """Step ``env`` ``n_steps`` times (default ``agent.learn_step``), storing
    the transitions in ``agent.rollout_buffer``; returns the mean reward per
    step. Envs that publish "action_mask" in their info get masked sampling:
    the agent latches maskedness the first time any info carries a mask,
    and from then on every buffered step carries one (all ones when a step
    omits it; earlier rows are backfilled with ones)."""
    n_steps = n_steps or agent.learn_step
    buf = agent.rollout_buffer
    dev = agent.dev
    if agent._last_obs is None:
        obs, info = env.reset()
        agent._last_obs = obs
        agent._last_info = info
        agent._last_done = torch.zeros(agent.num_envs, device=dev)
        if agent.recurrent:
            agent._hidden = agent.get_initial_hidden_state()
    obs = agent._last_obs
    info = getattr(agent, "_last_info", None)

    def _latch_mask(i):
        if not agent._masked_env and isinstance(i, dict) and i.get("action_mask") is not None:
            agent._masked_env = True
            agent._mask_shape = tuple(np.shape(i["action_mask"])[1:])

    if not hasattr(agent, "_masked_env"):
        agent._masked_env = False
        agent._mask_shape = None
    _latch_mask(info)
    total_reward = torch.zeros((), device=dev)
    done = agent._last_done
    for _ in range(n_steps):
        hidden_before = agent._hidden_for(agent.num_envs) if agent.recurrent else None
        action_mask = (info.get("action_mask")
                       if agent._masked_env and isinstance(info, dict) else None)
        action, logp, value, _ = agent.get_action_and_value(obs, action_mask=action_mask)
        next_obs, reward, terminated, truncated, info = env.step(env_action(env, action))
        agent._last_info = info
        _latch_mask(info)
        terminated = as_tensor(terminated, dev)
        truncated = as_tensor(truncated, dev).to(torch.bool)
        done = torch.logical_or(terminated, truncated).float()
        reward = as_tensor(reward, dev).float()
        # time-limit bootstrapping: an episode cut by its time limit (and not
        # terminated) folds gamma * V(s') into its last reward, so GAE (which
        # treats done as terminal) stays unbiased at truncation
        if isinstance(info, dict) and "final_obs" in info:
            v_final = agent.value_of(info["final_obs"])
            cut = torch.logical_and(truncated, ~terminated.to(torch.bool))
            reward = reward + agent.gamma * v_final * cut
        step = dict(obs=obs, action=action, reward=reward, done=done, value=value,
                    log_prob=logp)
        if agent._masked_env:
            step["action_mask"] = (
                as_tensor(action_mask, dev).float() if action_mask is not None
                else torch.ones((agent.num_envs,) + agent._mask_shape, device=dev))
        if agent.recurrent:
            step["hidden_state"] = hidden_before
            keep = (1.0 - done)[None, :, None]
            agent._hidden = tree_map(lambda h: h * keep, agent._hidden)
        buf.add(**step)
        total_reward = total_reward + reward.mean()
        obs = next_obs
    agent._last_obs = obs
    agent._last_done = done
    return float(total_reward) / n_steps
