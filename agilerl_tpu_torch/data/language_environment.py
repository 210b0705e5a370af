"""Online language-environment interaction: the port of
``agilerl_tpu/data/language_environment.py``. String-level env/policy
interfaces plus a bridge that lets a token-level policy act in them. Pure
Python and numpy, as in the JAX package."""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import numpy as np


class Language_Environment:
    """String-action environment protocol: subclass and implement
    step(action) -> (Language_Observation, reward, done), reset() and
    is_terminal()."""

    def step(self, action: str):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def is_terminal(self) -> bool:
        raise NotImplementedError


class TextPolicy:
    """String-level acting policy protocol; caching is the subclass's
    business."""

    def act(self, obs) -> str:
        raise NotImplementedError

    def train(self) -> None:  # mode toggles are no-ops for pure functions
        pass

    def eval(self) -> None:
        pass


def interact_environment(env: Language_Environment, policy, obs=None):
    """Roll a string policy through a language env until terminal. Returns (final_obs, obs_sequence)
    where obs_sequence rows are (obs, action|None, reward, done)."""
    obs_sequence: List[Tuple[Any, Optional[str], float, bool]] = []
    if obs is None:
        obs = env.reset()
    while not env.is_terminal():
        action = policy.act(obs)
        new_obs, r, t = env.step(action)
        obs_sequence.append((obs, action, float(r), bool(t)))
        obs = new_obs
    obs_sequence.append((obs, None, 0.0, True))
    return obs, obs_sequence


class TokenPolicyAdapter(TextPolicy):
    """Bridge a token-level policy (one whose act takes (prompt_tokens,
    prompt_mask) and returns the full token sequences) into the string-level
    TextPolicy protocol using any tokenizer with encode/decode
    (utils.llm_utils.CharTokenizer or an HF tokenizer)."""

    def __init__(self, token_policy, tokenizer,
                 obs_to_text: Optional[Callable[[Any], str]] = None):
        self.token_policy = token_policy
        self.tokenizer = tokenizer
        self.obs_to_text = obs_to_text or str

    def act(self, obs) -> str:
        text = self.obs_to_text(obs)
        encoded = list(self.tokenizer.encode(text))
        if not encoded:
            # an empty observation (fresh env) still needs one real prompt
            # token — a zero-length prompt would index the sample loop at -1
            encoded = [int(getattr(self.tokenizer, "pad_token_id", 0))]
        ids = np.asarray(encoded, np.int32)[None, :]
        mask = np.ones_like(ids)
        out_tokens, out_mask = self.token_policy.act(ids, mask)
        # token policies return the FULL [P+N] sequence — the action is only
        # the generated suffix, never the echoed prompt
        P = ids.shape[1]
        out_tokens = np.asarray(out_tokens)[0][P:]
        out_mask = np.asarray(out_mask)[0][P:].astype(bool)
        return self.tokenizer.decode([int(t) for t in out_tokens[out_mask]])
