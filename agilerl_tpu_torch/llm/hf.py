"""Hugging Face checkpoint import for Llama/Qwen2-class causal LMs: the port of
``agilerl_tpu/llm/hf.py``.

``load_hf_model`` needs neither ``transformers`` nor ``safetensors``: it reads
``config.json`` with ``json`` and the weights from ``model.safetensors`` (or
the shards that ``model.safetensors.index.json`` names) with the small reader
below, which parses the 8-byte little-endian header length and the JSON
header and takes each tensor's bytes with ``torch.frombuffer`` (F32, F16,
BF16). The weights are mapped to the model's keys and ``[in, out]`` layout,
with the q/k projection columns permuted from HF's rotate-half RoPE pairs to
the model's interleaved pairs. ``convert_hf_model`` (an in-memory HF model),
``verify_against_hf`` and ``load_hf_tokenizer`` work on ``transformers``
objects and raise ``ImportError`` where that package is missing.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from agilerl_tpu_torch.llm.model import GPTConfig, Params, apply, head_dtype_of
from agilerl_tpu_torch.ops import DeviceLike, resolve_device

_ST_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}


def _require_transformers(what: str) -> None:
    try:
        import transformers  # noqa: F401
    except ImportError as e:
        raise ImportError(
            f"{what} works on Hugging Face transformers objects, and the transformers "
            "package is not installed; load_hf_model reads a checkpoint directory "
            "without it") from e


def config_from_hf(hf_config: Any) -> GPTConfig:
    """Map an HF LlamaConfig/Qwen2Config, or its ``config.json`` as a dict, to
    GPTConfig (dtype left at the default, bf16)."""
    if isinstance(hf_config, Mapping):
        get = hf_config.get
    else:
        def get(name, default=None):
            return getattr(hf_config, name, default)
    return GPTConfig(
        vocab_size=get("vocab_size"),
        n_layer=get("num_hidden_layers"),
        n_head=get("num_attention_heads"),
        n_kv_head=get("num_key_value_heads", None),
        d_model=get("hidden_size"),
        d_ff=get("intermediate_size"),
        max_seq_len=min(get("max_position_embeddings", 4096), 8192),
        rope_theta=float(get("rope_theta", 10000.0)),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
        qkv_bias=bool(get("attention_bias", False)) or get("model_type") in ("qwen2",),
        rms_eps=float(get("rms_norm_eps", 1e-6)),
    )


def _rotate_half_to_interleaved(w, n_heads: int, head_dim: int):
    """Permute the last axis (``n_heads * head_dim`` projection outputs) from
    HF's rotate-half RoPE layout (pairs (i, i + hd/2)) to the model's
    interleaved pairs (2i, 2i + 1). ``w``: numpy array or tensor."""
    half = head_dim // 2
    perm = np.empty(head_dim, np.int64)
    perm[0::2] = np.arange(half)
    perm[1::2] = np.arange(half) + half
    full = np.concatenate([perm + h * head_dim for h in range(n_heads)])
    if isinstance(w, torch.Tensor):
        return w[..., torch.as_tensor(full, device=w.device)]
    return w[..., full]


def _convert_state_dict(sd: Mapping[str, torch.Tensor], config: GPTConfig,
                        device: torch.device) -> Params:
    """HF state dict -> model params: f32 arithmetic, then each weight stored
    as the model stores it (blocks and norms in ``config.dtype``, the head in
    f32)."""
    hd = config.head_dim

    def t(name, transpose=False, heads=None):
        w = sd[name].to(device=device, dtype=torch.float32)
        if transpose:  # torch Linear stores [out, in]; the model is [in, out]
            w = w.t()
        if heads is not None:
            w = _rotate_half_to_interleaved(w, heads, hd)
        return w.contiguous()

    def store(name, w):
        return w.to(head_dtype_of(config, name))

    params: Params = {
        "tok_emb": store("tok_emb", t("model.embed_tokens.weight")),
        "blocks": {},
        "ln_f": store("ln_f", t("model.norm.weight")),
    }
    for i in range(config.n_layer):
        p = f"model.layers.{i}."
        blk = {
            "ln1": t(p + "input_layernorm.weight"),
            "wq": t(p + "self_attn.q_proj.weight", True, config.n_head),
            "wk": t(p + "self_attn.k_proj.weight", True, config.kv_heads),
            "wv": t(p + "self_attn.v_proj.weight", True),
            "wo": t(p + "self_attn.o_proj.weight", True),
            "ln2": t(p + "post_attention_layernorm.weight"),
            "w_gate": t(p + "mlp.gate_proj.weight", True),
            "w_up": t(p + "mlp.up_proj.weight", True),
            "w_down": t(p + "mlp.down_proj.weight", True),
        }
        if config.qkv_bias:
            blk["bq"] = t(p + "self_attn.q_proj.bias", heads=config.n_head)
            blk["bk"] = t(p + "self_attn.k_proj.bias", heads=config.kv_heads)
            blk["bv"] = t(p + "self_attn.v_proj.bias")
        params["blocks"][str(i)] = {k: w.to(config.dtype) for k, w in blk.items()}
    if not config.tie_embeddings:
        params["lm_head"] = store("lm_head", t("lm_head.weight", True))
    return params


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU, in its stored
    dtype (F32, F16 or BF16)."""
    with open(path, "rb") as fh:
        (n,) = struct.unpack("<Q", fh.read(8))
        header = json.loads(fh.read(n))
        data = bytearray(fh.read())
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        if meta["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {meta['dtype']}; the reader "
                             f"takes {sorted(_ST_DTYPES)}")
        dtype = _ST_DTYPES[meta["dtype"]]
        start, end = meta["data_offsets"]
        count = (end - start) // torch.empty((), dtype=dtype).element_size()
        if count == 0:
            out[name] = torch.empty(meta["shape"], dtype=dtype)
            continue
        # a copy: the tensor must not alias (or keep alive) the whole file
        flat = torch.frombuffer(data, dtype=dtype, count=count, offset=start).clone()
        out[name] = flat.reshape(meta["shape"])
    return out


def read_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint directory: ``model.safetensors``, or
    every shard listed by ``model.safetensors.index.json``."""
    index = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as fh:
            shards = sorted(set(json.load(fh)["weight_map"].values()))
    else:
        shards = ["model.safetensors"]
    sd: Dict[str, torch.Tensor] = {}
    for shard in shards:
        sd.update(read_safetensors(os.path.join(path, shard)))
    return sd


def load_hf_model(path: str, dtype: torch.dtype = torch.bfloat16,
                  device: DeviceLike = None) -> Tuple[GPTConfig, Params]:
    """Load a Llama/Qwen2-class checkpoint directory (``config.json`` plus
    safetensors weights) into (config, params) on ``device`` (None: the
    card). ``config.dtype`` is ``dtype``; the block weights and norms are
    stored in it and the head in f32 (see ``llm/model.py``)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as fh:
        config = dataclasses.replace(config_from_hf(json.load(fh)), dtype=dtype)
    return config, _convert_state_dict(read_checkpoint(path), config, dev)


def convert_hf_model(model, hf_cfg=None,
                     device: DeviceLike = None) -> Tuple[GPTConfig, Params]:
    """Convert an in-memory HF Llama/Qwen2-class causal LM to (config,
    params); every weight is f32 (config.dtype stays at its default)."""
    _require_transformers("convert_hf_model")
    config = config_from_hf(hf_cfg or model.config)
    f32 = dataclasses.replace(config, dtype=torch.float32)
    params = _convert_state_dict(model.state_dict(), f32, resolve_device(device))
    return config, params


def load_hf_tokenizer(name_or_path: str):
    _require_transformers("load_hf_tokenizer")
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(name_or_path)
    if tok.pad_token_id is None:
        tok.pad_token = tok.eos_token
    return tok


def verify_against_hf(model, config: GPTConfig, params: Params, n_tokens: int = 8) -> float:
    """Max |logit| deviation between the HF torch forward and this model in
    f32 on the same weights: a load-time sanity check."""
    _require_transformers("verify_against_hf")
    ids = torch.arange(1, n_tokens + 1)[None, :]
    with torch.no_grad():
        ref = model(ids).logits.float().cpu()
        dev = params["ln_f"].device
        got, _ = apply(dataclasses.replace(config, dtype=torch.float32), params, ids.to(dev))
    return float((got.cpu() - ref).abs().max())
