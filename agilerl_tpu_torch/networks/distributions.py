"""Action distributions over network heads, with masking: the port of
``agilerl_tpu/networks/distributions.py``.

A frozen ``DistConfig`` names the family (categorical for Discrete, normal
for Box with a state-independent ``log_std`` in ``params["dist"]``,
multidiscrete, bernoulli for MultiBinary); ``sample`` / ``mode`` /
``log_prob`` / ``entropy`` are functions of (config, head output, ...).
Sampling draws from a ``torch.Generator`` on the logits' device with no
host sync (categoricals by Gumbel-max), so it matches the JAX package by
distribution only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agilerl_tpu_torch.utils.spaces import space_kind

NEG_INF = -1e8


@dataclasses.dataclass(frozen=True)
class DistConfig:
    kind: str  # "categorical" | "normal" | "multidiscrete" | "bernoulli"
    action_dim: int
    nvec: Tuple[int, ...] = ()  # for multidiscrete
    log_std_init: float = 0.0
    squash: bool = False


def dist_config_from_space(space) -> DistConfig:
    kind = space_kind(space)
    if kind == "discrete":
        return DistConfig(kind="categorical", action_dim=int(space.n))
    if kind == "multidiscrete":
        nvec = tuple(int(n) for n in space.nvec)
        return DistConfig(kind="multidiscrete", action_dim=int(sum(nvec)), nvec=nvec)
    if kind == "multibinary":
        return DistConfig(kind="bernoulli", action_dim=int(np.prod(space.shape)))
    if kind == "box":
        return DistConfig(kind="normal", action_dim=int(np.prod(space.shape)))
    raise TypeError(f"Unsupported action space {type(space)}")


def head_output_dim(config: DistConfig) -> int:
    """Number of raw head outputs the distribution consumes."""
    return config.action_dim


def extra_params(config: DistConfig, device=None) -> dict:
    """Learnable distribution params outside the head (the normal's log_std)."""
    if config.kind == "normal":
        return {"log_std": torch.full((config.action_dim,), float(config.log_std_init),
                                      dtype=torch.float32, device=device)}
    return {}


def apply_mask(config: DistConfig, logits: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Masked-out action logits set to NEG_INF."""
    if mask is None or config.kind == "normal":
        return logits
    return torch.where(mask.to(torch.bool), logits, torch.full_like(logits, NEG_INF))


def _md_slices(config: DistConfig):
    out, start = [], 0
    for n in config.nvec:
        out.append((start, n))
        start += n
    return out


def _gumbel_argmax(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def draw_noise(config: DistConfig, shape, gen: torch.Generator,
               dtype=torch.float32) -> torch.Tensor:
    """The draws one ``sample`` of head outputs of ``shape`` consumes: uniform
    for the discrete families (Gumbel-max, Bernoulli), standard normal for
    the normal."""
    if config.kind == "normal":
        return torch.randn(shape, generator=gen, device=gen.device, dtype=dtype)
    return torch.rand(shape, generator=gen, device=gen.device, dtype=dtype)


def sample_from_noise(config: DistConfig, logits: torch.Tensor, noise: torch.Tensor,
                      dist_extra: Optional[dict] = None,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sample`` on draws made beforehand (``draw_noise``): a pure function,
    so it runs under ``torch.func.vmap``."""
    logits = apply_mask(config, logits, mask)
    if config.kind == "categorical":
        return _gumbel_argmax(logits, noise)
    if config.kind == "multidiscrete":
        return torch.stack([_gumbel_argmax(logits[..., s:s + n], noise[..., s:s + n])
                            for s, n in _md_slices(config)], dim=-1)
    if config.kind == "bernoulli":
        return (noise < torch.sigmoid(logits)).to(torch.int32)
    action = logits + torch.exp(dist_extra["log_std"]) * noise
    return torch.tanh(action) if config.squash else action


def sample(config: DistConfig, logits: torch.Tensor, gen: torch.Generator,
           dist_extra: Optional[dict] = None, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    return sample_from_noise(config, logits, draw_noise(config, logits.shape, gen, logits.dtype),
                             dist_extra, mask)


def mode(config: DistConfig, logits: torch.Tensor,
         mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = apply_mask(config, logits, mask)
    if config.kind == "categorical":
        return torch.argmax(logits, dim=-1)
    if config.kind == "multidiscrete":
        return torch.stack([torch.argmax(logits[..., s:s + n], dim=-1)
                            for s, n in _md_slices(config)], dim=-1)
    if config.kind == "bernoulli":
        return (logits > 0).to(torch.int32)
    return torch.tanh(logits) if config.squash else logits


def _take(logp: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    return torch.gather(logp, -1, action.long()[..., None])[..., 0]


def log_prob(config: DistConfig, logits: torch.Tensor, action: torch.Tensor,
             dist_extra: Optional[dict] = None, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = apply_mask(config, logits, mask)
    if config.kind == "categorical":
        return _take(F.log_softmax(logits, dim=-1), action)
    if config.kind == "multidiscrete":
        total = 0.0
        for i, (s, n) in enumerate(_md_slices(config)):
            total = total + _take(F.log_softmax(logits[..., s:s + n], dim=-1), action[..., i])
        return total
    if config.kind == "bernoulli":
        action = action.to(logits.dtype)
        logp = -F.softplus(-logits) * action - F.softplus(logits) * (1 - action)
        return torch.sum(logp, dim=-1)
    # diagonal normal; squash scores a = tanh(u) by the change of variables
    log_std = dist_extra["log_std"]
    var = torch.exp(2 * log_std)
    if config.squash:
        a = torch.clamp(action, -1.0 + 1e-6, 1.0 - 1e-6)
        u = torch.atanh(a)
        logp = -0.5 * ((u - logits) ** 2 / var + 2 * log_std + math.log(2 * math.pi))
        logp = logp - torch.log(1.0 - torch.square(a) + 1e-6)
        return torch.sum(logp, dim=-1)
    logp = -0.5 * ((action - logits) ** 2 / var + 2 * log_std + math.log(2 * math.pi))
    return torch.sum(logp, dim=-1)


def entropy(config: DistConfig, logits: torch.Tensor, dist_extra: Optional[dict] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    logits = apply_mask(config, logits, mask)
    if config.kind == "categorical":
        logp = F.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)
    if config.kind == "multidiscrete":
        total = 0.0
        for s, n in _md_slices(config):
            logp = F.log_softmax(logits[..., s:s + n], dim=-1)
            total = total - torch.sum(torch.exp(logp) * logp, dim=-1)
        return total
    if config.kind == "bernoulli":
        p = torch.sigmoid(logits)
        return torch.sum(F.softplus(-logits) + logits * (1 - p), dim=-1)
    log_std = dist_extra["log_std"]
    base = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e), dim=-1) * torch.ones(
        logits.shape[:-1], dtype=logits.dtype, device=logits.device)
    if config.squash:
        # H[tanh(u)] ~ H[u] + log(1 - tanh(mean)^2): the expectation at the mean
        base = base + torch.sum(torch.log(1.0 - torch.square(torch.tanh(logits)) + 1e-6), dim=-1)
    return base
