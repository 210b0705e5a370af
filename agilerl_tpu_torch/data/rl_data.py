"""Language-RL data layer: the port of ``agilerl_tpu/data/rl_data.py``
(``Language_Observation``, ``TokenReward``, ``RL_Dataset``), which the ILQL and
BC_LM stack trains on.

A Language_Observation is a (text, reward) trajectory; RL_Dataset tokenizes it
into fixed-length sequences with per-token rewards and terminal flags, batched
as numpy arrays. Numpy only, as in the JAX package: ``sample_batch`` draws the
same rows from the same ``np.random.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class Language_Observation:
    """A (possibly multi-turn) text episode with a scalar reward per segment."""

    sequence: List[Tuple[str, Optional[float]]]  # [(text, reward-or-None), ...]
    terminal: bool = True


class TokenReward:
    """Per-token reward shaping hook (parity: rl_data.py). Default: zero shaping."""

    def get_token_reward(self, tokens: Sequence[int]) -> List[float]:
        return [0.0] * len(tokens)


class RL_Dataset:
    """Tokenised offline language-RL dataset."""

    def __init__(
        self,
        observations: List[Language_Observation],
        tokenizer,
        max_len: int = 64,
        token_reward: Optional[TokenReward] = None,
    ):
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.token_reward = token_reward or TokenReward()
        self.rows = [self._encode(o) for o in observations]

    def _encode(self, obs: Language_Observation) -> Dict[str, np.ndarray]:
        ids: List[int] = []
        rewards: List[float] = []
        for text, reward in obs.sequence:
            toks = self.tokenizer.encode(text)
            ids.extend(toks)
            seg_r = [0.0] * len(toks)
            if reward is not None and toks:
                seg_r[-1] = float(reward)  # reward lands on the final token
            rewards.extend(seg_r)
        ids = ids[: self.max_len]
        rewards = rewards[: self.max_len]
        shaped = self.token_reward.get_token_reward(ids)
        rewards = [r + s for r, s in zip(rewards, shaped)]
        pad = self.max_len - len(ids)
        attn = [1] * len(ids) + [0] * pad
        terminal = [0.0] * self.max_len
        if obs.terminal and len(ids) > 0:
            terminal[len(ids) - 1] = 1.0
        ids = ids + [self.tokenizer.pad_token_id] * pad
        rewards = rewards + [0.0] * pad
        return {
            "tokens": np.asarray(ids, np.int32),
            "attention_mask": np.asarray(attn, np.int32),
            "rewards": np.asarray(rewards, np.float32),
            "terminals": np.asarray(terminal, np.float32),
        }

    def __len__(self) -> int:
        return len(self.rows)

    def sample_batch(self, batch_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, len(self.rows), batch_size)
        return {
            k: np.stack([self.rows[i][k] for i in idx])
            for k in self.rows[0]
        }
