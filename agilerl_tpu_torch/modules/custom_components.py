"""Custom layer components: the port of ``agilerl_tpu/modules/custom_components.py``
(``NewGELU``, the image residual block and the SimBa residual MLP block, as
init/apply pairs over dict parameters with the JAX package's keys; the
noisy linear layer is ``layers.noisy_dense_*``), and ``gumbel_softmax``
(exported as ``GumbelSoftmax``), MADDPG's discrete sampler."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from agilerl_tpu_torch.modules.layers import (  # noqa: F401
    conv2d_apply,
    conv2d_init,
    dense_apply,
    dense_init,
    layer_norm_apply,
    layer_norm_init,
)
from agilerl_tpu_torch.modules.layers import noisy_dense_apply as NoisyLinear_apply  # noqa: F401
from agilerl_tpu_torch.modules.layers import noisy_dense_init as NoisyLinear_init  # noqa: F401


def NewGELU(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def gumbel_uniforms(shape, gen: torch.Generator) -> torch.Tensor:
    """The uniforms one ``gumbel_softmax`` of logits ``shape`` consumes, in
    ``[1e-10, 1)`` (the JAX package's ``uniform(minval=1e-10)``)."""
    return 1e-10 + torch.rand(shape, generator=gen, device=gen.device)


def gumbel_softmax(logits: torch.Tensor, u: torch.Tensor, tau: float = 1.0,
                   hard: bool = True) -> torch.Tensor:
    """Gumbel-softmax sample of ``logits`` on uniforms ``u`` drawn first
    (``gumbel_uniforms``): ``softmax((logits + g) / tau)`` with
    ``g = -log(-log(u + 1e-10))``; with ``hard``, the one-hot of its argmax
    carrying the soft sample's gradient (straight-through
    ``y_hard + y - y.detach()``)."""
    g = -torch.log(-torch.log(u + 1e-10))
    y = torch.softmax((logits + g) / tau, dim=-1)
    if hard:
        y_hard = F.one_hot(torch.argmax(y, dim=-1), logits.shape[-1]).to(y.dtype)
        y = y_hard + y - y.detach()
    return y


GumbelSoftmax = gumbel_softmax


def residual_block_init(gen: torch.Generator, channels: int, kernel: int = 3) -> Dict:
    """Image residual block: two SAME convs, each with a layer norm over channels."""
    return {
        "conv1": conv2d_init(gen, kernel, kernel, channels, channels),
        "norm1": layer_norm_init(channels, gen.device),
        "conv2": conv2d_init(gen, kernel, kernel, channels, channels),
        "norm2": layer_norm_init(channels, gen.device),
    }


def residual_block_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = F.relu(layer_norm_apply(params["norm1"], conv2d_apply(params["conv1"], x, 1, "SAME")))
    h = layer_norm_apply(params["norm2"], conv2d_apply(params["conv2"], h, 1, "SAME"))
    return F.relu(x + h)


def simba_residual_block_init(gen: torch.Generator, hidden: int, scale: int = 4) -> Dict:
    """SimBa residual MLP block: LayerNorm -> Dense(scale * h) -> ReLU -> Dense(h) + skip."""
    return {
        "norm": layer_norm_init(hidden, gen.device),
        "fc1": dense_init(gen, hidden, hidden * scale),
        "fc2": dense_init(gen, hidden * scale, hidden),
    }


def simba_residual_block_apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = layer_norm_apply(params["norm"], x)
    h = F.relu(dense_apply(params["fc1"], h))
    return x + dense_apply(params["fc2"], h)
