"""On-policy rollout storage with GAE: the port of
``agilerl_tpu/components/rollout_buffer.py``.

Storage is a dict of ``[T, N, ...]`` tensors on the buffer's device,
allocated at the first ``add``; the write cursor is a host integer, so no
step syncs the device. GAE is the JAX reverse scan as a loop over time on
the device. ``get_sequences`` cuts the buffer into recurrent PPO's BPTT
chunks, each with the hidden state stored at its first step.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from agilerl_tpu_torch.ops import resolve_device
from agilerl_tpu_torch.utils.rng import derive_key
from agilerl_tpu_torch.utils.spaces import as_tensor
from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

PyTree = Any


class RolloutState(NamedTuple):
    data: Dict[str, PyTree]  # each leaf [T, N, ...]
    t: int  # host write cursor
    advantages: torch.Tensor  # [T, N]
    returns: torch.Tensor  # [T, N]


def _compute_gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
                 last_value: torch.Tensor, last_done: Optional[torch.Tensor],
                 gamma: float, gae_lambda: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over ``[T, N]`` rewards, values and dones.

    Storage convention (the JAX package's): ``dones[t] = 1`` iff the episode
    ended AT step t (the env autoresets, so obs[t+1] belongs to the next
    episode), so step t's own done masks both its bootstrap and the
    advantage carried from t+1:
        delta_t = r_t + gamma * V(s_{t+1}) * (1 - done_t) - V(s_t)
        A_t     = delta_t + gamma * lambda * (1 - done_t) * A_{t+1}
    ``last_value`` is V of the obs after the last step; ``last_done`` is
    unused (``dones[T-1]`` already carries it)."""
    gae = torch.zeros_like(last_value)
    next_value = last_value
    adv = torch.empty_like(values)
    for t in range(rewards.shape[0] - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        gae = delta + gamma * gae_lambda * nonterminal * gae
        adv[t] = gae
        next_value = values[t]
    return adv, adv + values


class RolloutBuffer:
    """Fixed-horizon rollout buffer over N vectorised envs on ``device`` (the
    card when None, raising without one)."""

    #: backfill value per key that first appears after the schema was set
    #: (an action mask backfills with ones: unmasked sampling)
    backfill_fills = {"action_mask": 1}

    def __init__(self, capacity: int, num_envs: int, gamma: float = 0.99,
                 gae_lambda: float = 0.95, device=None):
        self.capacity = int(capacity)
        self.num_envs = int(num_envs)
        self.gamma = float(gamma)
        self.gae_lambda = float(gae_lambda)
        self.device = resolve_device(device)
        self.state: Optional[RolloutState] = None
        self._key = derive_key()

    @property
    def full(self) -> bool:
        return self.state is not None and self.state.t >= self.capacity

    def reset(self) -> None:
        if self.state is not None:
            self.state = self.state._replace(t=0)

    def _alloc(self, x: torch.Tensor, fill=0) -> torch.Tensor:
        return torch.full((self.capacity,) + tuple(x.shape), fill, dtype=x.dtype,
                          device=self.device)

    def add(self, **step: PyTree) -> None:
        """step keys: obs, action, reward, done, value, log_prob (+ action_mask,
        + hidden_state when recurrent). An empty buffer whose stored shapes
        no longer fit the step (a hidden state after an architecture
        mutation) is allocated anew."""
        step = {k: tree_map(lambda x: as_tensor(x, self.device), v) for k, v in step.items()}
        if self.state is not None and self.state.t == 0 and any(
                tuple(b.shape[1:]) != tuple(x.shape)
                for k, v in step.items() if k in self.state.data
                for b, x in zip(tree_leaves(self.state.data[k]), tree_leaves(v))):
            self.state = None
        if self.state is None:
            zeros = torch.zeros((self.capacity, self.num_envs), device=self.device)
            self.state = RolloutState({k: tree_map(self._alloc, v) for k, v in step.items()},
                                      0, zeros, zeros.clone())
        elif any(k not in self.state.data for k in step):
            data = dict(self.state.data)
            for k, v in step.items():
                if k not in data:
                    fill = self.backfill_fills.get(k, 0)
                    data[k] = tree_map(lambda x, _f=fill: self._alloc(x, _f), v)
            self.state = self.state._replace(data=data)
        t = self.state.t
        for k, v in step.items():
            tree_map(lambda buf, x: buf[t].copy_(x), self.state.data[k], v)
        self.state = self.state._replace(t=t + 1)

    def compute_returns_and_advantages(self, last_value: torch.Tensor,
                                       last_done: Optional[torch.Tensor] = None) -> None:
        s = self.state
        adv, ret = _compute_gae(s.data["reward"].float(), s.data["value"].float(),
                                s.data["done"].float(), as_tensor(last_value, self.device).float(),
                                last_done, self.gamma, self.gae_lambda)
        self.state = s._replace(advantages=adv, returns=ret)

    # -- flat minibatches ------------------------------------------------- #
    def minibatch_indices(self, batch_size: int,
                          key: Optional[torch.Generator] = None) -> torch.Tensor:
        """[n_batches, batch_size] indices into the flat ``T * N`` rows, from
        one permutation drawn on the buffer's device."""
        total = self.capacity * self.num_envs
        mb = min(int(batch_size), total)
        if key is None:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._key))
            key = torch.Generator(device=self.device).manual_seed(seed)
        perm = torch.randperm(total, generator=key, device=self.device)
        n_batches = max(total // mb, 1)
        return perm[: n_batches * mb].reshape(n_batches, mb)

    def _flat_data(self) -> Dict[str, PyTree]:
        s = self.state
        data = dict(s.data)
        data["advantages"] = s.advantages
        data["returns"] = s.returns
        return data

    def get_batch(self, idx: torch.Tensor) -> Dict[str, PyTree]:
        return tree_map(lambda buf: buf.reshape((-1,) + tuple(buf.shape[2:]))[idx],
                        self._flat_data())

    def get_all_flat(self) -> Dict[str, PyTree]:
        return tree_map(lambda buf: buf.reshape((-1,) + tuple(buf.shape[2:])), self._flat_data())

    def get_sequences(self, seq_len: int, key: Optional[torch.Generator] = None
                      ) -> Dict[str, PyTree]:
        """The buffer as ``[n_chunks * N, seq_len, ...]`` sequences (chunk-major,
        then env; time-major within a sequence), with ``hidden_state`` leaves
        ``[L, N, H]`` per step kept only at each sequence's first step, as
        ``[n_chunks * N, L, H]``. Where ``seq_len`` does not divide the
        capacity (after a learn_step mutation) the last rows are left out;
        the JAX package asserts instead."""
        s = self.state
        n_chunks = self.capacity // seq_len
        keep = n_chunks * seq_len

        def chop(buf):  # [T, N, ...] -> [n_chunks * N, seq_len, ...]
            x = buf[:keep].reshape((n_chunks, seq_len) + tuple(buf.shape[1:]))
            return x.transpose(1, 2).reshape((n_chunks * self.num_envs, seq_len)
                                             + tuple(buf.shape[2:]))

        def chop_hidden(buf):  # [T, L, N, H] -> [n_chunks * N, L, H]
            x = buf[:keep:seq_len].transpose(1, 2)
            return x.reshape((n_chunks * self.num_envs,) + tuple(x.shape[2:]))

        return {k: tree_map(chop_hidden if k == "hidden_state" else chop, v)
                for k, v in self._flat_data().items()}
