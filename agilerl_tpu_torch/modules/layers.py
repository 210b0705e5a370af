"""Functional layer library: the port of ``agilerl_tpu/modules/layers.py``.

Plain init/apply pairs over dict parameters with the JAX package's keys and
layouts (dense kernels ``[in, out]``, conv kernels HWIO over NHWC inputs), so
weights carry across through numpy unchanged. Inits take a
``torch.Generator`` (on the device the parameters should live on) where the
JAX package takes a key; the two draw different numbers from one seed, so
compare applies on carried weights and inits by shape and distribution only.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# --------------------------------------------------------------------------- #
# Activations
# --------------------------------------------------------------------------- #

ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "ReLU": F.relu,
    "Tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    "GELU": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "ELU": F.elu,
    "LeakyReLU": lambda x: F.leaky_relu(x, 0.01),
    "Softsign": F.softsign,
    "Softplus": F.softplus,
    "PReLU": lambda x: F.leaky_relu(x, 0.25),
    "Identity": lambda x: x,
    "Mish": lambda x: x * torch.tanh(F.softplus(x)),
    "SiLU": F.silu,
}


def get_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None:
        return ACTIVATIONS["Identity"]
    if name not in ACTIVATIONS:
        raise ValueError(f"Unknown activation {name!r}; choose from {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


# --------------------------------------------------------------------------- #
# Initializers
# --------------------------------------------------------------------------- #


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return u * (2 * bound) - bound


def kaiming_uniform(gen: torch.Generator, shape: Tuple[int, ...], fan_in: int) -> torch.Tensor:
    return _uniform(gen, shape, math.sqrt(1.0 / max(fan_in, 1)))


def orthogonal(gen: torch.Generator, shape: Tuple[int, int], scale: float = 1.0) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return torch.nn.init.orthogonal_(w, gain=scale, generator=gen)


# --------------------------------------------------------------------------- #
# Dense
# --------------------------------------------------------------------------- #


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int) -> Params:
    return {
        "kernel": kaiming_uniform(gen, (in_dim, out_dim), in_dim),
        "bias": kaiming_uniform(gen, (out_dim,), in_dim),
    }


def dense_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["kernel"] + params["bias"]


# --------------------------------------------------------------------------- #
# Noisy dense (factorised Gaussian noise, as Rainbow DQN uses it)
# --------------------------------------------------------------------------- #


def noisy_dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
                     std_init: float = 0.5) -> Params:
    mu_range = 1.0 / math.sqrt(in_dim)
    dev = gen.device
    return {
        "kernel_mu": _uniform(gen, (in_dim, out_dim), mu_range),
        "kernel_sigma": torch.full((in_dim, out_dim), std_init / math.sqrt(in_dim),
                                   dtype=torch.float32, device=dev),
        "bias_mu": _uniform(gen, (out_dim,), mu_range),
        "bias_sigma": torch.full((out_dim,), std_init / math.sqrt(out_dim),
                                 dtype=torch.float32, device=dev),
    }


class NoiseStream:
    """Standard normals drawn beforehand (a ``[..., count]`` tensor), handed
    out in order in place of a generator's draws: the noisy layers of one
    apply take ``in + out`` entries each, input side first. A population
    program passes one per member under ``vmap``."""

    def __init__(self, normals: torch.Tensor):
        self.normals = normals
        self.offset = 0

    def take(self, n: int) -> torch.Tensor:
        out = self.normals[..., self.offset:self.offset + n]
        self.offset += n
        return out


def _scaled_noise(gen, n: int) -> torch.Tensor:
    if isinstance(gen, NoiseStream):
        x = gen.take(n)
    else:
        x = torch.randn((n,), generator=gen, dtype=torch.float32, device=gen.device)
    return torch.sign(x) * torch.sqrt(torch.abs(x))


def noisy_dense_apply(params: Params, x: torch.Tensor, gen=None) -> torch.Tensor:
    """Apply a noisy linear layer: its noise from ``gen`` (a generator or a
    ``NoiseStream``); None -> deterministic (eval) path."""
    if gen is None:
        return x @ params["kernel_mu"] + params["bias_mu"]
    in_dim, out_dim = params["kernel_mu"].shape
    eps_in = _scaled_noise(gen, in_dim)
    eps_out = _scaled_noise(gen, out_dim)
    kernel = params["kernel_mu"] + params["kernel_sigma"] * torch.outer(eps_in, eps_out)
    bias = params["bias_mu"] + params["bias_sigma"] * eps_out
    return x @ kernel + bias


# --------------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------------- #


def layer_norm_init(dim: int, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def layer_norm_apply(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    norm = (x - mean) * torch.rsqrt(var + eps)
    return norm * params["scale"] + params["bias"]


def rms_norm_init(dim: int, device=None) -> Params:
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device)}


def rms_norm_apply(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * params["scale"]


# --------------------------------------------------------------------------- #
# Conv2D (NHWC inputs, HWIO kernels, as the JAX package lays them out)
# --------------------------------------------------------------------------- #


def conv2d_init(gen: torch.Generator, kh: int, kw: int, in_c: int, out_c: int) -> Params:
    fan_in = kh * kw * in_c
    return {
        "kernel": kaiming_uniform(gen, (kh, kw, in_c, out_c), fan_in),
        "bias": kaiming_uniform(gen, (out_c,), fan_in),
    }


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding: output ceil(size / stride), the odd pad at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_apply(params: Params, x: torch.Tensor, stride: int = 1,
                 padding: Union[str, Sequence[Tuple[int, int]]] = "VALID") -> torch.Tensor:
    """x [N, H, W, C] -> [N, H', W', out_c]. ``padding``: "VALID", "SAME" or
    ((top, bottom), (left, right))."""
    kh, kw = params["kernel"].shape[:2]
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            pads = ((0, 0), (0, 0))
        elif padding.upper() == "SAME":
            pads = (_same_pads(x.shape[1], kh, stride), _same_pads(x.shape[2], kw, stride))
        else:
            raise ValueError(f"unknown padding {padding!r}")
    else:
        pads = tuple(tuple(p) for p in padding)
    xc = x.permute(0, 3, 1, 2)  # NCHW
    (top, bottom), (left, right) = pads
    xc = F.pad(xc, (left, right, top, bottom))
    w = params["kernel"].permute(3, 2, 0, 1)  # OIHW
    y = F.conv2d(xc, w, stride=stride)
    return y.permute(0, 2, 3, 1) + params["bias"]


def conv_out_size(size: int, kernel: int, stride: int, padding: int = 0) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def maybe_rescale_image(x: torch.Tensor) -> torch.Tensor:
    """Rescale uint8 images to [0, 1] floats."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x.float()


# --------------------------------------------------------------------------- #
# LSTM (fused gates i, f, g, o)
# --------------------------------------------------------------------------- #


def lstm_cell_init(gen: torch.Generator, in_dim: int, hidden: int) -> Params:
    return {
        "wi": kaiming_uniform(gen, (in_dim, 4 * hidden), in_dim),
        "wh": kaiming_uniform(gen, (hidden, 4 * hidden), hidden),
        "bi": kaiming_uniform(gen, (4 * hidden,), in_dim),
        "bh": kaiming_uniform(gen, (4 * hidden,), hidden),
    }


def lstm_cell_apply(params: Params, carry: Tuple[torch.Tensor, torch.Tensor],
                    x: torch.Tensor) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    h, c = carry
    gates = x @ params["wi"] + params["bi"] + h @ params["wh"] + params["bh"]
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    h_new = o * torch.tanh(c_new)
    return (h_new, c_new), h_new


def lstm_scan(params: Params, x_seq: torch.Tensor, h0: torch.Tensor,
              c0: torch.Tensor) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One LSTM layer over a [T, B, D] sequence (the JAX ``lax.scan`` as a
    loop). Returns (outputs [T, B, H], (h, c))."""
    carry, outs = (h0, c0), []
    for x in x_seq:
        carry, h = lstm_cell_apply(params, carry, x)
        outs.append(h)
    return torch.stack(outs), carry


# --------------------------------------------------------------------------- #
# Embedding
# --------------------------------------------------------------------------- #


def embedding_init(gen: torch.Generator, vocab: int, dim: int, scale: float = 0.02) -> Params:
    x = torch.randn((vocab, dim), generator=gen, dtype=torch.float32, device=gen.device)
    return {"embedding": scale * x}


def embedding_apply(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["embedding"][ids.long()]
