"""Agent wrappers: the port of ``agilerl_tpu/wrappers/agent.py``
(``RunningMeanStd``, ``build_rms``, ``RSNorm``: online observation
normalisation with Welford statistics; ``AsyncAgentsWrapper``: turn-based
and partially active PettingZoo agents, keyed on the async vector env's NaN
placeholders).

``RunningMeanStd`` keeps the JAX package's numpy path for host
observations. For a tensor observation it keeps its statistics as float64
tensors on the observation's device and updates and normalises there, with
no host read (the count stays a host number: each batch's row count is
known on the host); a deviation, since the JAX one reads every observation
to numpy. ``AsyncAgentsWrapper`` is host-side, as the PettingZoo envs it
serves: actions that come back as tensors are read to numpy (one read per
agent and step). Spaces are read through ``utils.spaces.space_kind``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from agilerl_tpu_torch.utils.spaces import space_kind


def _host(x):
    """``x`` as host numpy when it is a tensor."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


class RunningMeanStd:
    """Welford online mean and variance over the leading axis of each
    update: numpy for host observations, float64 tensors on the device of a
    tensor observation."""

    def __init__(self, shape=(), epsilon: float = 1e-4):
        self.mean = np.zeros(shape, np.float64)
        self.var = np.ones(shape, np.float64)
        self.count = epsilon

    def _on_device(self, x) -> bool:
        """Whether ``x`` takes the tensor path; the statistics move to its
        device (once) when it does."""
        if not isinstance(x, torch.Tensor) and not isinstance(self.mean, torch.Tensor):
            return False
        dev = x.device if isinstance(x, torch.Tensor) else self.mean.device
        if not isinstance(self.mean, torch.Tensor) or self.mean.device != dev:
            self.mean = torch.as_tensor(self.mean, dtype=torch.float64, device=dev)
            self.var = torch.as_tensor(self.var, dtype=torch.float64, device=dev)
        return True

    def update(self, x) -> None:
        if self._on_device(x):
            x = torch.as_tensor(x, device=self.mean.device).to(torch.float64)
            if x.dim() == self.mean.dim():
                x = x[None]
            batch_mean, batch_var = x.mean(dim=0), x.var(dim=0, correction=0)
            square = torch.square
        else:
            x = np.asarray(x, np.float64)
            if x.ndim == len(self.mean.shape):
                x = x[None]
            batch_mean, batch_var = x.mean(axis=0), x.var(axis=0)
            square = np.square
        batch_count = x.shape[0]
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        self.mean = self.mean + delta * batch_count / tot
        m2 = self.var * self.count + batch_var * batch_count + square(
            delta) * self.count * batch_count / tot
        self.var = m2 / tot
        self.count = tot

    def normalize(self, x):
        if self._on_device(x):
            x = torch.as_tensor(x, device=self.mean.device).to(torch.float64)
            return ((x - self.mean) / torch.sqrt(self.var + 1e-8)).float()
        return ((np.asarray(x, np.float64) - self.mean) / np.sqrt(self.var + 1e-8)).astype(
            np.float32)


def build_rms(observation_space, epsilon: float = 1e-4, norm_obs_keys=None):
    """A ``RunningMeanStd`` tree shaped like the space: one per (selected)
    key of a Dict space, one per element of a Tuple space, None for
    categorical leaves (Discrete, MultiDiscrete, MultiBinary stay integer
    for their one-hot encoders); integer Box leaves (uint8 images) are
    normalised."""
    kind = space_kind(observation_space)
    if kind == "dict":
        items = observation_space.spaces.items()
        if norm_obs_keys is not None:
            items = [(k, v) for k, v in items if k in norm_obs_keys]
        return {k: build_rms(v, epsilon) for k, v in items}
    if kind == "tuple":
        return tuple(build_rms(v, epsilon) for v in observation_space.spaces)
    if kind in ("discrete", "multidiscrete", "multibinary"):
        return None
    return RunningMeanStd(getattr(observation_space, "shape", ()) or (), epsilon)


class RSNorm:
    """Observation-normalising agent wrapper.

    Wraps any agent (single- or multi-agent; flat, Dict or Tuple observation
    spaces), intercepting ``get_action`` and ``learn``: observations are
    normalised with running statistics that ``get_action`` updates while
    training. ``norm_obs_keys`` restricts which Dict keys are normalised."""

    def __init__(self, agent, epsilon: float = 1e-4, norm_obs_keys=None):
        self.agent = agent
        self.norm_obs_keys = norm_obs_keys
        self.multi_agent = hasattr(agent, "observation_spaces") and isinstance(
            getattr(agent, "observation_spaces"), dict
        )
        if self.multi_agent:
            self.obs_rms: Any = {
                aid: build_rms(space, epsilon, norm_obs_keys)
                for aid, space in agent.observation_spaces.items()
            }
        else:
            self.obs_rms = build_rms(
                getattr(agent, "observation_space", None), epsilon, norm_obs_keys
            )

    # back-compat: flat single-agent callers read .rms
    @property
    def rms(self):
        return self.obs_rms

    @staticmethod
    def _apply(rms, obs, update: bool):
        if rms is None:  # unnormalised leaf (integer space or unknown)
            return obs
        if not isinstance(rms, (dict, tuple)) and isinstance(obs, (dict, tuple)):
            # an agent without a Dict space emitting dict obs: pass through
            return obs
        if isinstance(rms, dict):
            out = dict(obs)
            for k, sub in rms.items():
                out[k] = RSNorm._apply(sub, obs[k], update)
            return out
        if isinstance(rms, tuple):
            return tuple(
                RSNorm._apply(sub, o, update) for sub, o in zip(rms, obs)
            )
        if update:
            rms.update(obs)
        return rms.normalize(obs)

    def _norm_obs(self, obs, update: bool = True):
        if self.multi_agent:
            return {
                aid: self._apply(self.obs_rms[aid], o, update)
                if o is not None else None
                for aid, o in obs.items()
            }
        return self._apply(self.obs_rms, obs, update)

    def get_action(self, obs, *args, training: bool = True, **kwargs):
        obs = self._norm_obs(obs, update=training)
        return self.agent.get_action(obs, *args, training=training, **kwargs)

    def _norm_batch(self, batch):
        batch = dict(batch)
        for key in ("obs", "next_obs"):
            if key in batch:
                if self.multi_agent:
                    batch[key] = self._norm_obs(batch[key], update=False)
                else:
                    batch[key] = self._apply(self.obs_rms, batch[key], update=False)
        return batch

    def learn(self, experiences, *args, **kwargs):
        if isinstance(experiences, dict):
            experiences = self._norm_batch(experiences)
        elif isinstance(experiences, tuple) and experiences and isinstance(
            experiences[0], dict
        ):
            # PER / n-step tuples (batch, idxs, weights[, n_batch]): normalise
            # every dict element
            experiences = tuple(
                self._norm_batch(e) if isinstance(e, dict) else e
                for e in experiences
            )
        return self.agent.learn(experiences, *args, **kwargs)

    def test(self, env, *args, **kwargs):
        return self.agent.test(env, *args, **kwargs)

    def __getattr__(self, item):
        return getattr(self.agent, item)


class AsyncAgentsWrapper:
    """Turn-based (AEC-style) and partially active PettingZoo agents.

    In a turn-based env only a subset of agents observes/acts each step, and an
    agent's experience spans from its action until its NEXT turn (accumulating
    the rewards in between). This wrapper:
    - ``get_action``: filters to the active agents (entries whose obs is not
      None) before delegating, so multi-agent algorithms always see full
      batched dicts;
    - ``record_step``: buffers each acting agent's (obs, action) and, when that
      agent's next turn (or episode end) arrives, emits its completed
      transition with the accumulated inter-turn reward.
    """

    def __init__(self, agent):
        self.agent = agent
        self._pending: Dict[Any, Dict[str, Any]] = {}

    # -- NaN-row machinery ----------------------------------------------- #
    @staticmethod
    def _leaf_inactive(value) -> Optional[np.ndarray]:
        """Per-leaf all-NaN row mask; None strictly means 'cannot detect'
        (unbatched or integer leaf). An all-False mask means 'detectably
        active' — the distinction matters when AND-combining leaves."""
        arr = np.asarray(value)
        if arr.ndim < 2 or not np.issubdtype(arr.dtype, np.floating):
            return None
        flat = arr.reshape(arr.shape[0], -1)
        return np.isnan(flat).all(axis=1)

    @staticmethod
    def _inactive_rows(value) -> Optional[np.ndarray]:
        """Boolean [N] mask of env rows where the agent is inactive (all-NaN
        observation across EVERY float leaf — the AsyncPettingZooVecEnv
        placeholder). A single all-NaN leaf (e.g. one glitched sensor) does
        NOT mark the row inactive when another leaf carries finite data. None
        for unbatched or integer-only obs."""
        if isinstance(value, (dict, tuple)):
            leaves = (list(value.values()) if isinstance(value, dict)
                      else list(value))
            masks = [AsyncAgentsWrapper._leaf_inactive(leaf) for leaf in leaves]
            masks = [m for m in masks if m is not None]
        else:
            m = AsyncAgentsWrapper._leaf_inactive(value)
            masks = [m] if m is not None else []
        if not masks:
            return None
        out = masks[0]
        for m in masks[1:]:
            out = out & m
        return out if out.any() else None

    def extract_inactive_agents(self, obs):
        """Split a batched observation dict into ({agent: inactive row idx},
        obs with NaN rows zero-substituted): the algorithms take full batched
        dicts, so rows are substituted and their actions masked afterwards."""
        inactive: Dict[str, np.ndarray] = {}
        cleaned = {}
        for aid, value in obs.items():
            mask = self._inactive_rows(value) if value is not None else None
            if mask is None:
                cleaned[aid] = value
                continue
            inactive[aid] = np.where(mask)[0]
            cleaned[aid] = self._substitute_rows(value, mask)
        return inactive, cleaned

    @staticmethod
    def _substitute_rows(value, mask):
        if isinstance(value, dict):
            return {k: AsyncAgentsWrapper._substitute_rows(v, mask)
                    for k, v in value.items()}
        if isinstance(value, tuple):
            return tuple(AsyncAgentsWrapper._substitute_rows(v, mask)
                         for v in value)
        arr = np.array(value, copy=True)
        if arr.ndim >= 1 and np.issubdtype(arr.dtype, np.floating):
            arr[mask] = 0.0
        return arr

    def get_action(self, obs, *args, **kwargs):
        active = {a: o for a, o in obs.items() if o is not None}
        if not active:
            return {a: None for a in obs}
        # vectorized partial activity: zero-substitute NaN rows, act, then
        # mask the placeholder rows' actions
        inactive, cleaned = self.extract_inactive_agents(active)
        # multi-agent algorithms index obs by EVERY agent id — substitute
        # zero placeholders for fully-absent agents, then drop their actions
        ref = next(iter(cleaned.values()))
        ref_leaf = ref if not isinstance(ref, (dict, tuple)) else (
            next(iter(ref.values())) if isinstance(ref, dict) else ref[0]
        )
        batch_shape = (
            np.asarray(ref_leaf).shape[:1] if np.asarray(ref_leaf).ndim > 1 else ()
        )
        full = {}
        for aid in obs:
            if obs[aid] is not None:
                full[aid] = cleaned[aid]
            else:
                space = self.agent.observation_spaces[aid]
                full[aid] = np.zeros(batch_shape + tuple(space.shape), np.float32)
        actions = self.agent.get_action(full, *args, **kwargs)
        out = {}
        for a in obs:
            if obs[a] is None:
                out[a] = None
                continue
            act = _host(actions.get(a))
            rows = inactive.get(a)
            if rows is not None and act is not None and len(rows):
                act = np.array(act, copy=True)
                if np.issubdtype(act.dtype, np.integer):
                    act[rows] = 0  # env discards these; 0 keeps the dtype
                else:
                    act = act.astype(np.float32)
                    act[rows] = np.nan
            out[a] = act
        return out

    def record_step(self, obs, actions, rewards, dones, autoreset=None):
        """Feed one env step; returns a list of ``(agent_id, transition)``
        pairs for experiences that just closed.

        A list (not a dict) because one step can close TWO transitions for the
        same agent — the buffered inter-turn one and the episode-ending action
        — and consumers key multi-agent buffers by real agent ids.

        Vectorized envs (NaN-placeholder rows from AsyncPettingZooVecEnv)
        dispatch to ``record_step_vec``, which buffers per (agent, env index)
        and returns ``(agent_id, env_idx, transition)`` triples.
        """
        for aid, value in obs.items():
            if value is not None and self._looks_batched(aid, value):
                return self.record_step_vec(obs, actions, rewards, dones,
                                            autoreset=autoreset)
        completed: list = []
        for aid, r in rewards.items():
            if aid in self._pending:
                self._pending[aid]["reward"] += float(np.asarray(r).squeeze())
        for aid, o in obs.items():
            pending = self._pending.get(aid)
            acted_now = actions.get(aid) is not None and o is not None
            done = bool(np.asarray(dones.get(aid, False)).squeeze())
            if pending is not None and (acted_now or done):
                completed.append((aid, {
                    "obs": pending["obs"],
                    "action": pending["action"],
                    "reward": np.float32(pending["reward"]),
                    "next_obs": o if o is not None else pending["obs"],
                    "done": np.float32(done),
                }))
                del self._pending[aid]
            if acted_now and not done:
                self._pending[aid] = {
                    "obs": o, "action": actions[aid], "reward": 0.0,
                }
            elif acted_now and done:
                # the episode-ending action closes immediately with this
                # step's reward (it would otherwise be dropped)
                completed.append((aid, {
                    "obs": o,
                    "action": actions[aid],
                    "reward": np.float32(np.asarray(rewards.get(aid, 0.0)).squeeze()),
                    "next_obs": o,
                    "done": np.float32(1.0),
                }))
        return completed

    def _looks_batched(self, aid, value) -> bool:
        """Batched iff the leading axis is a batch axis over the agent's
        observation space — NOT merely ndim>=2, which would misroute
        unbatched image/board observations."""
        space = getattr(self.agent, "observation_spaces", {}).get(aid)
        if isinstance(value, dict):
            key = next(iter(value))
            sub = space.spaces.get(key) if space is not None and hasattr(space, "spaces") else None
            return self._leaf_batched(value[key], sub)
        if isinstance(value, tuple):
            sub = space.spaces[0] if space is not None and hasattr(space, "spaces") else None
            return self._leaf_batched(value[0], sub)
        return self._leaf_batched(value, space)

    @staticmethod
    def _leaf_batched(leaf, space) -> bool:
        arr = np.asarray(leaf)
        if space is not None and getattr(space, "shape", None) is not None:
            return arr.ndim > len(space.shape)
        return arr.ndim >= 2

    @staticmethod
    def _row(value, i):
        if isinstance(value, dict):
            return {k: AsyncAgentsWrapper._row(v, i) for k, v in value.items()}
        if isinstance(value, tuple):
            return tuple(AsyncAgentsWrapper._row(v, i) for v in value)
        return np.asarray(value)[i]

    def record_step_vec(self, obs, actions, rewards, dones, autoreset=None):
        """Per-(agent, env-row) turn buffering over a vectorized async env.
        An agent's row is inactive when its observation row is all-NaN; its
        action row is NaN (or the 0 placeholder get_action wrote) and
        ignored. Rewards at inactive rows are NaN (the async env's
        placeholder) and skipped.

        ``autoreset``: boolean [N] mask of env rows whose EPISODE just ended
        (AsyncPettingZooVecEnv provides it as ``info["autoreset"]``) — pass it
        for EXACT closure semantics: pending transitions close with done=1
        precisely at autoreset rows, and one agent dying mid-episode leaves
        its teammates' in-flight transitions open. Without the mask the
        fallback is conservative: ANY agent's done closes all pendings at
        that row (turn-based envs report done only for the agent that acted
        last — an AND-of-dones would never fire and stale pendings would
        bootstrap across the reset, which is strictly worse than the
        occasional early closure).

        Returns a list of ``(agent_id, env_idx, transition)`` triples.
        """
        completed: list = []
        if autoreset is not None:
            episode_end = np.asarray(autoreset, bool).reshape(-1)
        else:
            episode_end = None
            for aid, d in dones.items():
                if d is None:
                    continue
                d = np.asarray(d, np.float64).reshape(-1)
                flags = np.nan_to_num(d, nan=0.0).astype(bool)
                episode_end = flags if episode_end is None \
                    else (episode_end | flags)
        for aid, r in rewards.items():
            if r is None:
                continue
            r = np.asarray(r, np.float64).reshape(-1)
            for i in range(r.shape[0]):
                key = (aid, i)
                if key in self._pending and not np.isnan(r[i]):
                    self._pending[key]["reward"] += float(r[i])
        for aid, value in obs.items():
            if value is None:
                continue
            mask = self._inactive_rows(value)
            n = np.asarray(
                value if not isinstance(value, (dict, tuple)) else (
                    next(iter(value.values())) if isinstance(value, dict)
                    else value[0]
                )
            ).shape[0]
            act = _host(actions.get(aid))
            d_val = dones.get(aid)
            done_arr = np.asarray(
                d_val if d_val is not None else np.zeros(n), np.float64
            ).reshape(-1)
            for i in range(n):
                inactive = bool(mask[i]) if mask is not None else False
                row_act = None if act is None else np.asarray(act)[i]
                if row_act is not None and np.issubdtype(
                    np.asarray(row_act).dtype, np.floating
                ) and np.isnan(np.asarray(row_act)).all():
                    row_act = None
                acted_now = (not inactive) and row_act is not None
                d = done_arr[i]
                done = bool(d) and not np.isnan(d)
                # the EPISODE ending at this row closes every pending
                # transition there — a dead agent's buffered step must not
                # bootstrap into the NEXT episode after autoreset
                if episode_end is not None and episode_end[i]:
                    done = True
                key = (aid, i)
                pending = self._pending.get(key)
                o_row = self._row(value, i)
                if pending is not None and (acted_now or done):
                    completed.append((aid, i, {
                        "obs": pending["obs"],
                        "action": pending["action"],
                        "reward": np.float32(pending["reward"]),
                        "next_obs": o_row if not inactive else pending["obs"],
                        "done": np.float32(done),
                    }))
                    del self._pending[key]
                if acted_now and not done:
                    self._pending[key] = {
                        "obs": o_row, "action": row_act, "reward": 0.0,
                    }
                elif acted_now and done:
                    r_val = rewards.get(aid)
                    r_now = np.asarray(
                        r_val if r_val is not None else np.zeros(n), np.float64
                    ).reshape(-1)[i]
                    completed.append((aid, i, {
                        "obs": o_row,
                        "action": row_act,
                        "reward": np.float32(0.0 if np.isnan(r_now) else r_now),
                        "next_obs": o_row,
                        "done": np.float32(1.0),
                    }))
        return completed

    def reset(self):
        self._pending = {}

    def learn(self, experiences, *args, **kwargs):
        return self.agent.learn(experiences, *args, **kwargs)

    def __getattr__(self, item):
        return getattr(self.agent, item)
