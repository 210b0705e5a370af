"""EvolvableBERT: the port of ``agilerl_tpu/modules/bert.py``.

A compact pre-norm encoder-decoder: bidirectional encoder self-attention,
causal decoder self-attention and cross-attention, GELU MLPs. Blocks are
name-keyed (``params["encoder"][str(i)]``, ``params["decoder"][str(i)]``),
so layer mutations preserve weights, and node mutations morph ``d_model``
slab-wise. Torch ops throughout (the JAX module reaches no Pallas kernel).
The MLP's GELU is the tanh approximation, ``jax.nn.gelu``'s default, and a
masked score is -1e9 before the softmax, as in the JAX module. Parameters
are f32 on ``device`` (the card when None, raising without one); the
weights are drawn from the module's generator (normal 0.02 for the
embeddings, attention and head, ``modules/layers.py``'s dense init for the
MLP), so they match the JAX package's by distribution only: carry JAX
weights with ``llm/convert.f32_tree_from_numpy``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from agilerl_tpu_torch.modules import layers as L
from agilerl_tpu_torch.modules.base import EvolvableModule, mutation
from agilerl_tpu_torch.typing import MutationType
from agilerl_tpu_torch.utils.rng import derive_key, derive_rng


@dataclasses.dataclass(frozen=True)
class BERTConfig:
    vocab_size: int
    n_encoder_layers: int = 2
    n_decoder_layers: int = 2
    n_head: int = 4
    d_model: int = 128
    d_ff: Optional[int] = None
    max_seq_len: int = 256

    @property
    def ff_dim(self) -> int:
        return self.d_ff or 4 * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head


def _normal(gen: torch.Generator, shape, std: float = 0.02) -> torch.Tensor:
    return std * torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)


def _attn_init(gen: torch.Generator, d: int) -> Dict:
    return {name: _normal(gen, (d, d)) for name in ("wq", "wk", "wv", "wo")}


def _attn(params: Dict, q_in: torch.Tensor, kv_in: torch.Tensor, n_head: int,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, Tq, D = q_in.shape
    Tk = kv_in.shape[1]
    hd = D // n_head
    q = (q_in @ params["wq"]).reshape(B, Tq, n_head, hd)
    k = (kv_in @ params["wk"]).reshape(B, Tk, n_head, hd)
    v = (kv_in @ params["wv"]).reshape(B, Tk, n_head, hd)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        scores = torch.where(mask, scores, -1e9)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, Tq, D)
    return out @ params["wo"]


def _mlp_init(gen: torch.Generator, d: int, ff: int) -> Dict:
    return {"fc1": L.dense_init(gen, d, ff), "fc2": L.dense_init(gen, ff, d)}


def _mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return L.dense_apply(params["fc2"],
                         F.gelu(L.dense_apply(params["fc1"], x), approximate="tanh"))


class EvolvableBERT(EvolvableModule):
    Config = BERTConfig

    def __init__(
        self,
        vocab_size: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        config: Optional[BERTConfig] = None,
        min_layers: int = 1,
        max_layers: int = 8,
        min_d_model: int = 64,
        max_d_model: int = 1024,
        device=None,
        **kwargs,
    ):
        if config is None:
            config = BERTConfig(vocab_size=vocab_size, **kwargs)
        self.min_layers = min_layers
        self.max_layers = max_layers
        self.min_d_model = min_d_model
        self.max_d_model = max_d_model
        super().__init__(config, derive_key(key), device)

    @staticmethod
    def init_params(gen: torch.Generator, config: BERTConfig) -> Dict:
        d, ff, dev = config.d_model, config.ff_dim, gen.device
        params: Dict = {
            "tok_emb": _normal(gen, (config.vocab_size, d)),
            "pos_emb": _normal(gen, (config.max_seq_len, d)),
            "encoder": {},
            "decoder": {},
            "ln_f": L.layer_norm_init(d, dev),
            "lm_head": _normal(gen, (d, config.vocab_size)),
        }
        for i in range(config.n_encoder_layers):
            params["encoder"][str(i)] = {
                "ln1": L.layer_norm_init(d, dev),
                "attn": _attn_init(gen, d),
                "ln2": L.layer_norm_init(d, dev),
                "mlp": _mlp_init(gen, d, ff),
            }
        for i in range(config.n_decoder_layers):
            params["decoder"][str(i)] = {
                "ln1": L.layer_norm_init(d, dev),
                "self_attn": _attn_init(gen, d),
                "ln_x": L.layer_norm_init(d, dev),
                "cross_attn": _attn_init(gen, d),
                "ln2": L.layer_norm_init(d, dev),
                "mlp": _mlp_init(gen, d, ff),
            }
        return params

    @staticmethod
    def encode(config: BERTConfig, params: Dict, src: torch.Tensor,
               src_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        T = src.shape[1]
        h = F.embedding(src.long(), params["tok_emb"]) + params["pos_emb"][None, :T]
        mask = None if src_mask is None else src_mask[:, None, None, :].bool()
        for i in range(config.n_encoder_layers):
            blk = params["encoder"][str(i)]
            x = L.layer_norm_apply(blk["ln1"], h)
            h = h + _attn(blk["attn"], x, x, config.n_head, mask)
            h = h + _mlp(blk["mlp"], L.layer_norm_apply(blk["ln2"], h))
        return h

    @staticmethod
    def apply(config: BERTConfig, params: Dict, src: torch.Tensor,
              tgt: Optional[torch.Tensor] = None, src_mask: Optional[torch.Tensor] = None,
              **_) -> torch.Tensor:
        """Encoder-decoder forward: decoder logits [B, Tt, V] (``tgt`` None:
        the encoder states [B, Ts, D])."""
        enc = EvolvableBERT.encode(config, params, src, src_mask)
        if tgt is None:
            return enc
        Tt = tgt.shape[1]
        h = F.embedding(tgt.long(), params["tok_emb"]) + params["pos_emb"][None, :Tt]
        t_ids = torch.arange(Tt, device=h.device)
        causal = (t_ids[:, None] >= t_ids[None, :])[None, None]
        cross_mask = None if src_mask is None else src_mask[:, None, None, :].bool()
        for i in range(config.n_decoder_layers):
            blk = params["decoder"][str(i)]
            x = L.layer_norm_apply(blk["ln1"], h)
            h = h + _attn(blk["self_attn"], x, x, config.n_head, causal)
            x = L.layer_norm_apply(blk["ln_x"], h)
            h = h + _attn(blk["cross_attn"], x, enc, config.n_head, cross_mask)
            h = h + _mlp(blk["mlp"], L.layer_norm_apply(blk["ln2"], h))
        h = L.layer_norm_apply(params["ln_f"], h)
        return h @ params["lm_head"]

    # -- mutations ------------------------------------------------------ #
    @mutation(MutationType.LAYER)
    def add_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        cfg = self.config
        if bool(rng.integers(0, 2)) and cfg.n_encoder_layers < self.max_layers:
            self._morph(dataclasses.replace(cfg, n_encoder_layers=cfg.n_encoder_layers + 1))
            return {"stack": "encoder"}
        if cfg.n_decoder_layers < self.max_layers:
            self._morph(dataclasses.replace(cfg, n_decoder_layers=cfg.n_decoder_layers + 1))
            return {"stack": "decoder"}
        return self.add_node(rng=rng)

    @mutation(MutationType.LAYER, shrink_params=True)
    def remove_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        cfg = self.config
        if bool(rng.integers(0, 2)) and cfg.n_encoder_layers > self.min_layers:
            self._morph(dataclasses.replace(cfg, n_encoder_layers=cfg.n_encoder_layers - 1))
            return {"stack": "encoder"}
        if cfg.n_decoder_layers > self.min_layers:
            self._morph(dataclasses.replace(cfg, n_decoder_layers=cfg.n_decoder_layers - 1))
            return {"stack": "decoder"}
        return self.add_node(rng=rng)

    @mutation(MutationType.NODE)
    def add_node(self, numb_new_nodes: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        cfg = self.config
        if numb_new_nodes is None:
            numb_new_nodes = cfg.n_head * int(rng.choice([4, 8]))
        new_d = min(cfg.d_model + numb_new_nodes, self.max_d_model)
        new_d -= new_d % cfg.n_head
        self._morph(dataclasses.replace(cfg, d_model=new_d, d_ff=None))
        return {"numb_new_nodes": numb_new_nodes}

    @mutation(MutationType.NODE, shrink_params=True)
    def remove_node(self, numb_new_nodes: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        cfg = self.config
        if numb_new_nodes is None:
            numb_new_nodes = cfg.n_head * int(rng.choice([4, 8]))
        new_d = max(cfg.d_model - numb_new_nodes, self.min_d_model)
        new_d -= new_d % cfg.n_head
        if new_d < self.min_d_model:  # the head-divisible floor must not undershoot
            new_d += cfg.n_head
        self._morph(dataclasses.replace(cfg, d_model=new_d, d_ff=None))
        return {"numb_new_nodes": numb_new_nodes}
