"""MakeEvolvable: the port of ``agilerl_tpu/wrappers/make_evolvable.py``,
which reflects an arbitrary ``torch.nn.Module`` into an evolvable clone.

Two entry modes, as in the JAX package:

1. **Module introspection**: pass a ``torch.nn`` module plus an example
   ``input_tensor``. Forward hooks record the Linear / Conv2d / activation /
   norm sequence in call order; the detected architecture is rebuilt as an
   ``EvolvableMLP`` or ``EvolvableCNN`` and the module's weights are copied
   into the clone's parameters, so the clone is forward-equivalent to the
   original network. The weights are torch tensors already: they are only
   laid out as the port's modules hold them (dense kernels ``[in, out]``,
   conv kernels HWIO, and the head's input features from torch's NCHW
   flatten order into the NHWC one of the port's CNN).

2. **Architecture description** (kwargs): an ``EvolvableMLP`` /
   ``EvolvableCNN`` built directly from sizes (deprecated, as in the
   reference).

``device=None`` puts the clone on the card, and raises without one. This
wrapper is a migration aid: prefer constructing Evolvable modules directly.
"""

from __future__ import annotations

import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch

from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.utils.rng import derive_key

SUPPORTED_ACTIVATIONS = {
    "ReLU": "ReLU",
    "Tanh": "Tanh",
    "Sigmoid": "Sigmoid",
    "GELU": "GELU",
    "ELU": "ELU",
    "LeakyReLU": "LeakyReLU",
    "Softsign": "Softsign",
    "Softplus": "Softplus",
    "PReLU": "PReLU",
    "Identity": "Identity",
    "Mish": "Mish",
    "SiLU": "SiLU",
}


def _detect_torch_architecture(network, input_tensor):
    """Run one forward pass with hooks and return the layer record in call
    order."""
    import torch.nn as nn

    records = []

    def hook(module, args, output):
        if isinstance(module, nn.Linear):
            records.append(("linear", module))
        elif isinstance(module, nn.Conv2d):
            records.append(("conv", module))
        elif isinstance(module, nn.LayerNorm):
            records.append(("layernorm", module))
        elif type(module).__name__ in SUPPORTED_ACTIVATIONS:
            records.append(("act", module))
        elif isinstance(module, (nn.Flatten, nn.Identity, nn.Dropout)):
            pass
        elif len(list(module.children())) == 0 and not isinstance(
            module, (nn.Sequential, nn.ModuleList)
        ):
            records.append(("unsupported", module))

    handles = [m.register_forward_hook(hook) for m in network.modules()]
    try:
        with torch.no_grad():
            network(input_tensor)
    finally:
        for h in handles:
            h.remove()
    return records


def _nhwc_permutation(c: int, h: int, w: int) -> np.ndarray:
    """Index map from torch's flattened NCHW features to the NHWC flatten
    order: perm[j] = the NCHW flat index that lands at NHWC flat position j."""
    idx = np.arange(c * h * w).reshape(c, h, w)  # value = torch flat index
    return idx.transpose(1, 2, 0).reshape(-1)  # NHWC order


def _conv_stack_spatial(h: int, w: int, convs) -> tuple:
    for m in convs:
        k, s = m.kernel_size[0], m.stride[0]
        h = (h - k) // s + 1
        w = (w - k) // s + 1
    return h, w


def _from_torch_module(network, input_tensor, key, device):
    """Rebuild a torch module as an evolvable clone holding its weights."""
    records = _detect_torch_architecture(network, input_tensor)
    unsupported = [type(m).__name__ for k, m in records if k == "unsupported"]
    if unsupported:
        raise ValueError(
            f"MakeEvolvable cannot reflect layers {sorted(set(unsupported))}; "
            "supported: Linear, Conv2d, LayerNorm, Flatten and standard "
            "activations")

    convs = [m for k, m in records if k == "conv"]
    linears = [m for k, m in records if k == "linear"]
    if not linears:
        raise ValueError("network must end in at least one Linear layer")

    # the hidden activation is the one seen BEFORE the final linear (one
    # appearing only after it is the output activation); Evolvable modules
    # apply ONE activation network-wide, so mixed hidden activations raise
    last_linear_pos = max(i for i, (k, _) in enumerate(records) if k == "linear")
    hidden_acts = sorted({type(m).__name__ for k, m in records[:last_linear_pos]
                          if k == "act"})
    if len(hidden_acts) > 1:
        raise ValueError(
            f"MakeEvolvable needs a single hidden activation (found {hidden_acts}); "
            "Evolvable modules apply one activation network-wide")
    hidden_act = SUPPORTED_ACTIVATIONS.get(hidden_acts[0], "ReLU") if hidden_acts else "Identity"
    out_acts = [type(m).__name__ for k, m in records[last_linear_pos + 1:] if k == "act"]
    output_activation = SUPPORTED_ACTIVATIONS.get(out_acts[0]) if out_acts else None
    for k, m in records:
        # a torch PReLU's slope is learnable; the port's PReLU is fixed at
        # 0.25, and anything else would break forward equivalence
        if k == "act" and type(m).__name__ == "PReLU":
            w = m.weight.detach().cpu()
            if w.numel() != 1 or abs(float(w.reshape(-1)[0]) - 0.25) > 1e-6:
                raise ValueError("MakeEvolvable cannot reflect PReLU with a trained/"
                                 "per-channel slope (the Evolvable PReLU is fixed at 0.25)")
    norms = [m for k, m in records if k == "layernorm"]
    dev = resolve_device(device)

    def weight(t, like=None, fill=0.0) -> torch.Tensor:
        if t is None:  # bias=False / affine-less layers
            return torch.full(like, fill, dtype=torch.float32, device=dev)
        return t.detach().to(device=dev, dtype=torch.float32).clone()

    if convs:
        if len(linears) != 1:
            raise ValueError("conv networks must end in exactly one Linear head to map onto "
                             "EvolvableCNN (conv stack + dense output)")
        if norms:
            # EvolvableCNN's layer_norm is channels-last over conv features:
            # torch LayerNorms in a conv net do not map 1:1
            raise ValueError("MakeEvolvable cannot reflect LayerNorm inside conv networks; "
                             "remove the norm or construct EvolvableCNN directly")
        for m in convs:
            kh, kw = m.kernel_size
            if kh != kw:
                raise ValueError("only square conv kernels are supported")
            if m.stride[0] != m.stride[1]:
                raise ValueError("only symmetric conv strides are supported")
            if any(p != 0 for p in m.padding):
                raise ValueError("only padding=0 (VALID) convs are supported")
            if tuple(m.dilation) != (1, 1):
                raise ValueError("only dilation=1 convs are supported")
            if m.groups != 1:
                raise ValueError("only groups=1 convs are supported")
        from agilerl_tpu_torch.modules.cnn import EvolvableCNN

        n, c, h, w = input_tensor.shape
        head = linears[0]
        module = EvolvableCNN(
            input_shape=(h, w, c), num_outputs=head.out_features,
            channel_size=tuple(m.out_channels for m in convs),
            kernel_size=tuple(m.kernel_size[0] for m in convs),
            stride_size=tuple(m.stride[0] for m in convs),
            activation=hidden_act, output_activation=output_activation,
            layer_norm=False,  # torch norms do not map 1:1; keep exact parity
            key=key, device=dev)
        params = module.params
        for i, m in enumerate(convs):
            params[f"conv_{i}"]["kernel"] = weight(m.weight).permute(2, 3, 1, 0).contiguous()
            params[f"conv_{i}"]["bias"] = weight(m.bias, like=(m.out_channels,))
        # the head's input features from NCHW-flat to NHWC-flat order
        fh, fw = _conv_stack_spatial(h, w, convs)
        perm = torch.as_tensor(_nhwc_permutation(convs[-1].out_channels, fh, fw), device=dev)
        params["output"]["kernel"] = weight(head.weight)[:, perm].t().contiguous()
        params["output"]["bias"] = weight(head.bias, like=(head.out_features,))
        module.load_state_dict(params)
        return module

    from agilerl_tpu_torch.modules.mlp import EvolvableMLP

    if len(linears) < 2:
        raise ValueError("MLP networks need at least one hidden Linear + output")
    # EvolvableMLP computes Linear -> LayerNorm -> activation: a torch net
    # ordered otherwise would import cleanly but compute something else
    for i, (k, m) in enumerate(records):
        if k == "layernorm" and (i == 0 or records[i - 1][0] != "linear"):
            raise ValueError("MakeEvolvable needs each LayerNorm directly after a Linear "
                             "(Evolvable modules compute Linear -> LayerNorm -> activation)")
    if norms and len(norms) != len(linears) - 1:
        # EvolvableMLP norms every hidden layer or none
        raise ValueError(f"MakeEvolvable needs a LayerNorm after every hidden Linear or "
                         f"none (found {len(norms)} norms for {len(linears) - 1} hidden "
                         "layers)")
    module = EvolvableMLP(
        num_inputs=linears[0].in_features, num_outputs=linears[-1].out_features,
        hidden_size=tuple(m.out_features for m in linears[:-1]), activation=hidden_act,
        output_activation=output_activation, layer_norm=bool(norms), key=key, device=dev)
    params = module.params
    for i, m in enumerate(linears[:-1]):
        params[f"layer_{i}"]["kernel"] = weight(m.weight).t().contiguous()
        params[f"layer_{i}"]["bias"] = weight(m.bias, like=(m.out_features,))
    params["output"]["kernel"] = weight(linears[-1].weight).t().contiguous()
    params["output"]["bias"] = weight(linears[-1].bias, like=(linears[-1].out_features,))
    for i, m in enumerate(norms):
        dim = (m.normalized_shape[-1],)
        # elementwise_affine=False means scale 1 / bias 0 exactly
        params[f"norm_{i}"]["scale"] = weight(m.weight, like=dim, fill=1.0)
        params[f"norm_{i}"]["bias"] = weight(m.bias, like=dim)
    module.load_state_dict(params)
    return module


def MakeEvolvable(
    network: Any = None,
    input_tensor: Any = None,
    num_inputs: Optional[int] = None,
    num_outputs: Optional[int] = None,
    hidden_layers: Optional[Sequence[int]] = None,
    input_shape: Optional[Sequence[int]] = None,
    channels: Optional[Sequence[int]] = None,
    kernels: Optional[Sequence[int]] = None,
    strides: Optional[Sequence[int]] = None,
    activation: str = "ReLU",
    key: Optional[torch.Generator] = None,
    device: DeviceLike = None,
):
    """An evolvable net by introspecting a torch module (``network`` +
    ``input_tensor``, on the module's own device) or from a plain
    architecture description (kwargs), on ``device``."""
    key = derive_key(key)
    if network is not None:
        if input_tensor is None:
            raise ValueError("MakeEvolvable(network=...) needs an example input_tensor to "
                             "trace the architecture")
        return _from_torch_module(network, input_tensor, key, device)

    warnings.warn(
        "MakeEvolvable from an architecture description is deprecated (as in the "
        "reference); construct EvolvableMLP/EvolvableCNN directly.",
        DeprecationWarning, stacklevel=2)
    if input_shape is not None and channels is not None:
        from agilerl_tpu_torch.modules.cnn import EvolvableCNN

        return EvolvableCNN(
            input_shape=tuple(input_shape), num_outputs=num_outputs,
            channel_size=tuple(channels), kernel_size=tuple(kernels or [3] * len(channels)),
            stride_size=tuple(strides or [1] * len(channels)), activation=activation,
            key=key, device=device)
    from agilerl_tpu_torch.modules.mlp import EvolvableMLP

    return EvolvableMLP(num_inputs=num_inputs, num_outputs=num_outputs,
                        hidden_size=tuple(hidden_layers or (64, 64)), activation=activation,
                        key=key, device=device)
