"""Decoder-only transformer (Llama-class: RMSNorm, RoPE, SwiGLU, GQA) as plain
functions over a nested dict of tensors: the port of
``agilerl_tpu/llm/model.py`` (dense and MoE layers, dense KV cache).

Parameters carry the JAX package's keys and ``[in, out]`` layout
(``x @ w``), so weights move between the two through numpy with no transpose
(``llm/convert.py``). The JAX model keeps f32 parameters and casts every block
weight to ``config.dtype`` at use; the port stores block weights in
``config.dtype`` to begin with (the same values reach every product) and keeps
the lm head (or the tied embedding) in f32, because the logits are an f32
product with an f32 head. LoRA adapters stay f32 and are cast at use.

A layer ``i`` with ``config.is_moe_layer(i)`` replaces the SwiGLU FFN by the
routed experts of ``llm/moe.py`` (stacked ``[E, ...]`` weights and a
``router``); ``forward(..., return_aux=True)`` also returns the sum of the
layers' load-balance losses.

The paged KV cache (``PagedKVCache``, the ``paged_*`` helpers and
``forward_paged``) serves ``llm/serving.ContinuousGenerator``: one block pool
shared by every in-flight sequence, written IN PLACE (the JAX version donates
the pool and returns a new one).

Not ported here: ``scan_layers``/``remat`` (XLA compile-time devices with no
eager counterpart), the ``*_shard_axes`` fields (distribution slice) and the
dense-attention kill switch of the paged forward
(``AGILERL_TPU_DISABLE_CHUNKED_DECODE``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from agilerl_tpu_torch.llm.moe import moe_ffn
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.ops.decode_attention import chunked_cached_attention
from agilerl_tpu_torch.ops.flash_attention_vjp import flash_attention_diff
from agilerl_tpu_torch.ops.fused_loss import fused_token_logprob_diff

Params = Dict
GeneratorLike = Union[int, torch.Generator]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int
    n_layer: int = 4
    n_head: int = 4
    n_kv_head: Optional[int] = None  # grouped-query attention; None -> n_head
    d_model: int = 256
    d_ff: Optional[int] = None  # None -> 8/3 * d_model rounded up to 128
    max_seq_len: int = 1024
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    qkv_bias: bool = False  # Qwen2-style attention biases
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    use_flash_attention: bool = False  # flash kernel on the non-cached path
    n_experts: int = 0  # 0 = dense FFN everywhere
    expert_top_k: int = 2
    capacity_factor: float = 1.25
    moe_every: int = 1  # layer i is MoE iff (i + 1) % moe_every == 0
    router_aux_weight: float = 0.01

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and (i + 1) % self.moe_every == 0

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head or self.n_head

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def ff_dim(self) -> int:
        return self.d_ff or int(8 * self.d_model / 3 + 127) // 128 * 128


class KVCache(NamedTuple):
    """All layers' KV cache, stacked on a leading layer axis. ``length`` is a
    host int shared by every row (left-pad ragged prompts); ``mask`` marks the
    slots that hold a real token. ``forward`` writes k, v and mask in place."""

    k: torch.Tensor  # [L, B, S, KV, hd]
    v: torch.Tensor  # [L, B, S, KV, hd]
    length: int
    mask: torch.Tensor  # [B, S] int32


def init_kv_cache(config: GPTConfig, batch: int, max_len: Optional[int] = None,
                  device: DeviceLike = None) -> KVCache:
    dev = resolve_device(device)
    s = max_len or config.max_seq_len
    shape = (config.n_layer, batch, s, config.kv_heads, config.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=config.dtype, device=dev),
        v=torch.zeros(shape, dtype=config.dtype, device=dev),
        length=0,
        mask=torch.zeros((batch, s), dtype=torch.int32, device=dev),
    )


def init_caches(config: GPTConfig, batch: int, max_len: Optional[int] = None,
                device: DeviceLike = None) -> KVCache:
    """One stacked cache for the whole layer stack (leading axis = layer)."""
    return init_kv_cache(config, batch, max_len, device)


# --------------------------------------------------------------------------- #
# Paged KV cache: ONE physical block pool shared by every in-flight sequence
# + per-slot int32 block tables. The serving tier
# (llm/serving.ContinuousGenerator) owns the tables and the free list on the
# host; the device only sees gathers and scatters through them.
# --------------------------------------------------------------------------- #


class PagedKVCache(NamedTuple):
    """Physical KV block pool, stacked over layers. The ``paged_*`` writers
    update ``k`` and ``v`` in place and return the same cache.

    Block 0 is reserved as a garbage sink: free slots point their whole block
    table at it, so masked writes always have a legal destination. Many
    parked slots may write it in one step (duplicate targets, any of which
    may win): nothing ever reads block 0 as real data."""

    k: torch.Tensor  # [L, n_blocks, block_size, KV, hd]
    v: torch.Tensor  # [L, n_blocks, block_size, KV, hd]

    @property
    def n_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def block_size(self) -> int:
        return self.k.shape[2]


def init_paged_cache(config: GPTConfig, n_blocks: int, block_size: int,
                     device: DeviceLike = None) -> PagedKVCache:
    dev = resolve_device(device)
    shape = (config.n_layer, n_blocks, block_size, config.kv_heads, config.head_dim)
    return PagedKVCache(k=torch.zeros(shape, dtype=config.dtype, device=dev),
                        v=torch.zeros(shape, dtype=config.dtype, device=dev))


def paged_gather(pool_k: torch.Tensor, pool_v: torch.Tensor, block_tables: torch.Tensor):
    """Per-slot contiguous KV slabs from ONE layer's pool ([nb, bs, KV, hd])
    and the block tables [B, max_blocks] -> ([B, S, KV, hd], ...) with
    S = max_blocks * bs: a per-layer temporary; the resident allocation
    stays the shared pool."""
    bs = pool_k.shape[1]
    B, mb = block_tables.shape
    flat = block_tables.reshape(-1).long()

    def slab(pool):
        return pool.index_select(0, flat).reshape(B, mb * bs, *pool.shape[2:])

    return slab(pool_k), slab(pool_v)


def paged_write_index(block_tables: torch.Tensor, write_pos: torch.Tensor,
                      block_size: int) -> torch.Tensor:
    """Flat pool index [B] (int64) of each slot's write position. Positions
    past the table (only released slots, whose lengths keep advancing) clamp
    into the last table entry; a released slot's table is all zero, so the
    write lands in the garbage block."""
    mb = block_tables.shape[1]
    bidx = (write_pos // block_size).clamp_max(mb - 1).long()
    phys = block_tables.gather(1, bidx[:, None])[:, 0].long()
    return phys * block_size + (write_pos % block_size).long()


def paged_scatter_tokens(cache: PagedKVCache, block_tables: torch.Tensor,
                         write_pos: torch.Tensor, new_k: torch.Tensor,
                         new_v: torch.Tensor) -> PagedKVCache:
    """ONE bulk write of the step's new tokens into the pool across all
    layers, in place. new_k/new_v: [L, B, KV, hd]; write_pos: [B]."""
    L, nb, bs, KV, hd = cache.k.shape
    idx = paged_write_index(block_tables, write_pos, bs)
    cache.k.view(L, nb * bs, KV, hd)[:, idx] = new_k
    cache.v.view(L, nb * bs, KV, hd)[:, idx] = new_v
    return cache


def paged_scatter_multi(cache: PagedKVCache, block_tables: torch.Tensor,
                        write_pos: torch.Tensor, new_k: torch.Tensor,
                        new_v: torch.Tensor) -> PagedKVCache:
    """Bulk write of a multi-token verify window into the pool, in place.

    new_k/new_v: [L, B, T, KV, hd]; write_pos: [B, T]. Positions at or past
    the logical extent S are REDIRECTED to the garbage block 0 instead of
    clamping into the last table entry: a full-table slot speculating near
    its budget must never corrupt its own (possibly shared) final block.
    Rejected-draft positions inside the extent are written as-is: they sit
    past the slot's accepted length, are invisible to every mask, and are
    rewritten before the sequence reaches them."""
    L, nb, bs, KV, hd = cache.k.shape
    B, T = write_pos.shape
    mb = block_tables.shape[1]
    bidx = (write_pos // bs).clamp_max(mb - 1).long()
    phys = block_tables.gather(1, bidx).long()
    phys = torch.where(write_pos < mb * bs, phys, 0)
    idx = (phys * bs + (write_pos % bs).long()).reshape(-1)
    cache.k.view(L, nb * bs, KV, hd)[:, idx] = new_k.reshape(L, B * T, KV, hd)
    cache.v.view(L, nb * bs, KV, hd)[:, idx] = new_v.reshape(L, B * T, KV, hd)
    return cache


def paged_scatter_prompt(cache: PagedKVCache, block_ids: torch.Tensor,
                         k_prompt: torch.Tensor, v_prompt: torch.Tensor) -> PagedKVCache:
    """Write one request's prefilled prompt KV ([L, Pb, KV, hd], Pb a whole
    number of blocks) into its physical blocks ([Pb // bs]), in place."""
    L, _, bs, KV, hd = cache.k.shape
    nb_p = k_prompt.shape[1] // bs
    ids = block_ids.long()
    cache.k[:, ids] = k_prompt.reshape(L, nb_p, bs, KV, hd).to(cache.k.dtype)
    cache.v[:, ids] = v_prompt.reshape(L, nb_p, bs, KV, hd).to(cache.v.dtype)
    return cache


def paged_copy_block(cache: PagedKVCache, src, dst) -> PagedKVCache:
    """Copy one physical block, in place (prefix-cache hit: the last prompt
    block is duplicated into a private block so the first decode write
    cannot touch the shared original)."""
    cache.k[:, dst] = cache.k[:, src]
    cache.v[:, dst] = cache.v[:, src]
    return cache


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #


def _generator(generator: GeneratorLike, device: torch.device) -> torch.Generator:
    if isinstance(generator, torch.Generator):
        return generator
    return torch.Generator(device=device).manual_seed(int(generator))


def _normal(gen, shape, std, dtype, device):
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * std).to(dtype)


def head_dtype_of(config: GPTConfig, name: str) -> torch.dtype:
    """Storage dtype of a top-level parameter: the head stays f32."""
    is_head = name == "lm_head" or (name == "tok_emb" and config.tie_embeddings)
    return torch.float32 if is_head else config.dtype


def init_params(generator: GeneratorLike, config: GPTConfig,
                device: DeviceLike = None) -> Params:
    """Random weights as in the JAX ``init_params`` (normal 0.02, output
    projections 0.02 / sqrt(2 n_layer), norms 1, biases 0), drawn from
    ``generator`` (a seed or a torch.Generator on ``device``)."""
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    dt = config.dtype
    d, hd = config.d_model, config.head_dim
    nh, nkv, f = config.n_head, config.kv_heads, config.ff_dim
    std = 0.02
    out_std = std / math.sqrt(2 * config.n_layer)
    ones = lambda n: torch.ones((n,), dtype=dt, device=dev)  # noqa: E731
    zeros = lambda n: torch.zeros((n,), dtype=dt, device=dev)  # noqa: E731
    params: Params = {
        "tok_emb": _normal(gen, (config.vocab_size, d), std,
                           head_dtype_of(config, "tok_emb"), dev),
        "blocks": {},
        "ln_f": ones(d),
    }
    for i in range(config.n_layer):
        blk = {
            "ln1": ones(d),
            "wq": _normal(gen, (d, nh * hd), std, dt, dev),
            "wk": _normal(gen, (d, nkv * hd), std, dt, dev),
            "wv": _normal(gen, (d, nkv * hd), std, dt, dev),
            "wo": _normal(gen, (nh * hd, d), out_std, dt, dev),
            "ln2": ones(d),
        }
        if config.is_moe_layer(i):
            E = config.n_experts
            blk["router"] = _normal(gen, (d, E), std, dt, dev)
            blk["w_gate"] = _normal(gen, (E, d, f), std, dt, dev)
            blk["w_up"] = _normal(gen, (E, d, f), std, dt, dev)
            blk["w_down"] = _normal(gen, (E, f, d), out_std, dt, dev)
        else:
            blk["w_gate"] = _normal(gen, (d, f), std, dt, dev)
            blk["w_up"] = _normal(gen, (d, f), std, dt, dev)
            blk["w_down"] = _normal(gen, (f, d), out_std, dt, dev)
        if config.qkv_bias:
            blk["bq"], blk["bk"], blk["bv"] = zeros(nh * hd), zeros(nkv * hd), zeros(nkv * hd)
        params["blocks"][str(i)] = blk
    if not config.tie_embeddings:
        params["lm_head"] = _normal(gen, (d, config.vocab_size), std, torch.float32, dev)
    return params


# --------------------------------------------------------------------------- #
# LoRA
# --------------------------------------------------------------------------- #

LORA_TARGETS = ("wq", "wk", "wv", "wo")


def init_lora(generator: GeneratorLike, config: GPTConfig, rank: int = 8,
              targets: Tuple[str, ...] = ("wq", "wv"),
              device: DeviceLike = None) -> Params:
    """f32 LoRA adapter subtree mirroring blocks: A ~ normal(0.02), B = 0,
    so a fresh adapter is a no-op. FFN targets are refused on MoE models: the
    expert weights are stacked ``[E, ...]`` and the routed FFN would never
    read a dense-shaped adapter."""
    if config.n_experts > 0 and any(t in ("w_gate", "w_up", "w_down") for t in targets):
        raise ValueError(
            "LoRA on FFN projections is not supported for MoE layers; "
            f"restrict targets to attention projections {LORA_TARGETS}")
    dev = resolve_device(device)
    gen = _generator(generator, dev)
    d, hd = config.d_model, config.head_dim
    dims = {
        "wq": (d, config.n_head * hd),
        "wk": (d, config.kv_heads * hd),
        "wv": (d, config.kv_heads * hd),
        "wo": (config.n_head * hd, d),
        "w_gate": (d, config.ff_dim),
        "w_up": (d, config.ff_dim),
        "w_down": (config.ff_dim, d),
    }
    lora: Params = {"blocks": {}}
    for i in range(config.n_layer):
        layer = {}
        for t in targets:
            din, dout = dims[t]
            layer[t] = {
                "A": _normal(gen, (din, rank), 0.02, torch.float32, dev),
                "B": torch.zeros((rank, dout), dtype=torch.float32, device=dev),
            }
        lora["blocks"][str(i)] = layer
    return lora


def _maybe_lora(x, w, lora_layer, name, scale, dtype):
    y = x @ w.to(dtype)
    if lora_layer is not None and name in lora_layer:
        a = lora_layer[name]["A"].to(dtype)
        b = lora_layer[name]["B"].to(dtype)
        y = y + ((x @ a) @ b) * scale
    return y


def merge_lora(params: Params, lora: Params, scale: float = 2.0) -> Params:
    """Fold the adapter into the base weights (export). The sum is taken in
    f32 and stored back in each weight's dtype; ``params`` is not modified."""
    out = {k: v for k, v in params.items() if k != "blocks"}
    out["blocks"] = {i: dict(blk) for i, blk in params["blocks"].items()}
    for i, layer in lora["blocks"].items():
        for t, ab in layer.items():
            w = params["blocks"][i][t]
            out["blocks"][i][t] = (w.float() + (ab["A"].float() @ ab["B"].float())
                                   * scale).to(w.dtype)
    return out


# --------------------------------------------------------------------------- #
# Apply
# --------------------------------------------------------------------------- #


def _rms(x, scale, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, hd]; positions: [B, T]. Interleaved pairs (2i, 2i+1);
    cos/sin are cast to x's dtype before the products."""
    hd = x.shape[-1]
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs  # [B, T, hd/2]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape)


def _qkv_rope(config: GPTConfig, blk, x, positions, lora_layer, lora_scale):
    B, T = x.shape[:2]
    dtype = x.dtype
    q = _maybe_lora(x, blk["wq"], lora_layer, "wq", lora_scale, dtype)
    k = _maybe_lora(x, blk["wk"], lora_layer, "wk", lora_scale, dtype)
    v = _maybe_lora(x, blk["wv"], lora_layer, "wv", lora_scale, dtype)
    if config.qkv_bias:
        q = q + blk["bq"].to(dtype)
        k = k + blk["bk"].to(dtype)
        v = v + blk["bv"].to(dtype)
    q = q.reshape(B, T, config.n_head, config.head_dim)
    k = k.reshape(B, T, config.kv_heads, config.head_dim)
    v = v.reshape(B, T, config.kv_heads, config.head_dim)
    return _rope(q, positions, config.rope_theta), _rope(k, positions, config.rope_theta), v


def _block_ffn(config: GPTConfig, blk, h, lora_layer, lora_scale):
    """Post-attention half of a block: RMSNorm + (MoE | SwiGLU) FFN + residual.
    Returns (h_out, aux): the MoE layer's load-balance loss, 0.0 for a dense
    layer (a Python float, so a dense forward launches nothing for it)."""
    dtype = h.dtype
    x = _rms(h, blk["ln2"], config.rms_eps)
    if "router" in blk:
        B, T, D = h.shape
        out, aux = moe_ffn(x.reshape(B * T, D), blk["router"], blk["w_gate"], blk["w_up"],
                           blk["w_down"], top_k=config.expert_top_k,
                           capacity_factor=config.capacity_factor)
        return h + out.reshape(B, T, D), aux
    gate = _maybe_lora(x, blk["w_gate"], lora_layer, "w_gate", lora_scale, dtype)
    up = _maybe_lora(x, blk["w_up"], lora_layer, "w_up", lora_scale, dtype)
    return h + _maybe_lora(F.silu(gate) * up, blk["w_down"], lora_layer, "w_down",
                           lora_scale, dtype), 0.0


def _dense_attention(config: GPTConfig, q, k, v, attention_mask):
    """Non-cached dense path: GQA repeat, bf16-rounded scores as the JAX
    einsum gives them, masked scores -1e9. q/k/v: [B, T, H|KV, hd]."""
    B, T = q.shape[:2]
    rep = config.n_head // config.kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, T, d]
    scores = torch.matmul(qh, kh.transpose(-1, -2)).float() / math.sqrt(config.head_dim)
    t_ids = torch.arange(T, device=q.device)
    mask = (t_ids[None, :] <= t_ids[:, None])[None] & attention_mask[:, None, :].bool()
    scores = torch.where(mask[:, None], scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh)  # [B, H, T, d]


def forward(
    config: GPTConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T]
    attention_mask: Optional[torch.Tensor] = None,  # [B, T] 1=valid
    positions: Optional[torch.Tensor] = None,  # [B, T]
    cache: Optional[KVCache] = None,
    lora: Optional[Params] = None,
    lora_scale: float = 2.0,
    flash: Optional[bool] = None,  # override config.use_flash_attention
    return_aux: bool = False,  # also return the MoE load-balance loss
):
    """Returns (hidden [B, T, D] float32, new cache), and with ``return_aux``
    (hidden, cache, aux): aux is the layers' summed MoE load-balance loss
    (f32). With a cache, tokens are appended at ``cache.length`` (all rows
    share it: left-pad ragged prompts). The cache's k, v and mask are
    written IN PLACE (the JAX version returns new arrays): the returned cache
    shares them with the one passed in, with ``length`` advanced by T.

    ``flash`` routes the non-cached attention through the flash kernels
    (CUDA tensors; differentiable, with the backward kernels) or their plain
    versions (CPU tensors); the cached path always uses
    ``chunked_cached_attention``."""
    B, T = tokens.shape
    dtype = config.dtype
    dev = tokens.device
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.int32, device=dev)
    if positions is None:
        positions = (attention_mask.cumsum(dim=-1) - 1).clamp_min(0)
    use_flash = config.use_flash_attention if flash is None else flash
    h = F.embedding(tokens, params["tok_emb"]).to(dtype)

    if cache is not None:
        start = cache.length
        cache.mask[:, start:start + T] = attention_mask.to(torch.int32)

    H, hd = config.n_head, config.head_dim
    aux_total = 0.0
    for i in range(config.n_layer):
        blk = params["blocks"][str(i)]
        lora_layer = lora["blocks"].get(str(i)) if lora is not None else None
        x = _rms(h, blk["ln1"], config.rms_eps)
        q, k, v = _qkv_rope(config, blk, x, positions, lora_layer, lora_scale)
        if cache is not None:
            cache.k[i, :, start:start + T] = k
            cache.v[i, :, start:start + T] = v
            attn = chunked_cached_attention(q, cache.k[i], cache.v[i], cache.mask, start)
            attn = attn.reshape(B, T, H * hd)
        else:
            if use_flash:
                # the kernel reads KV head h // rep: no repeated copy of K/V
                attn = flash_attention_diff(q.transpose(1, 2), k.transpose(1, 2),
                                            v.transpose(1, 2), attention_mask, True)
            else:
                attn = _dense_attention(config, q, k, v, attention_mask)
            attn = attn.transpose(1, 2).reshape(B, T, H * hd)
        attn = _maybe_lora(attn, blk["wo"], lora_layer, "wo", lora_scale, dtype)
        h, aux = _block_ffn(config, blk, h + attn, lora_layer, lora_scale)
        aux_total = aux_total + aux

    new_cache = None
    if cache is not None:
        new_cache = KVCache(cache.k, cache.v, start + T, cache.mask)
    hidden = _rms(h, params["ln_f"], config.rms_eps).float()
    if return_aux:
        return hidden, new_cache, torch.as_tensor(aux_total, dtype=torch.float32, device=dev)
    return hidden, new_cache


def forward_paged(
    config: GPTConfig,
    params: Params,
    tokens: torch.Tensor,       # [B, T] the current token(s) per slot
    positions: torch.Tensor,    # [B] or [B, T] RoPE position(s)
    write_pos: torch.Tensor,    # [B] or [B, T] logical cache slot(s) for K/V
    cache: PagedKVCache,
    block_tables: torch.Tensor,  # [B, max_blocks] int32
    slot_mask: torch.Tensor,    # [B, S] 1 where the LOGICAL slot holds a real
    # token, including the current token at write_pos (caller pre-sets it)
    lora: Optional[Params] = None,
    lora_scale: float = 2.0,
    live: Optional[int] = None,
):
    """One decode forward over the slot pool: returns (hidden [B, T, D]
    float32, (new_k, new_v)); the caller scatters the new KV into the pool
    (``paged_scatter_tokens`` / ``paged_scatter_multi``) exactly once. The
    pool is only read here.

    Per-slot ``write_pos`` replaces forward-with-cache's shared length:
    continuous batching admits slots at different times. Attention sees the
    gathered slab with this step's K/V inserted (forward's pre-update
    discipline); the projection/FFN maths is forward's own code and masked
    slab positions contribute exact zeros, so greedy outputs match the dense
    path.

    T == 1 is the per-token decode step (positions/write_pos [B]; new KV
    [L, B, KV, hd]). T > 1 is the speculative verify window (positions and
    write_pos [B, T], consecutive per row, write_pos[:, 0] = lengths; new KV
    [L, B, T, KV, hd]): query t attends to logical slots <= write_pos[:, 0]
    + t that slot_mask marks valid. ``live``: a host upper bound of
    max(write_pos[:, 0]) + T, which spares chunked attention its read of the
    maximum."""
    B, T = tokens.shape
    dtype = config.dtype
    dev = tokens.device
    H, hd = config.n_head, config.head_dim
    multi = write_pos.dim() == 2
    pos2d = positions if positions.dim() == 2 else positions[:, None]
    wp = write_pos if multi else write_pos[:, None]  # [B, T]
    S = block_tables.shape[1] * cache.block_size
    # the slab insert drops positions past the extent S (a released slot
    # whose lengths ran on), as the JAX scatter does out of bounds: a row's T
    # positions are consecutive and T <= S, so their residues mod S are
    # distinct; a dropped position rewrites its residue's own old value
    col = (wp % S).long()
    keep = (wp < S)[..., None, None]
    rows = torch.arange(B, device=dev)[:, None].expand(B, T)
    h = F.embedding(tokens, params["tok_emb"]).to(dtype)
    new_k, new_v = [], []
    for i in range(config.n_layer):
        blk = params["blocks"][str(i)]
        lora_layer = lora["blocks"].get(str(i)) if lora is not None else None
        x = _rms(h, blk["ln1"], config.rms_eps)
        q, k, v = _qkv_rope(config, blk, x, pos2d, lora_layer, lora_scale)
        k_slab, v_slab = paged_gather(cache.k[i], cache.v[i], block_tables)
        k_slab[rows, col] = torch.where(keep, k, k_slab[rows, col])
        v_slab[rows, col] = torch.where(keep, v, v_slab[rows, col])
        attn = chunked_cached_attention(q, k_slab, v_slab, slot_mask, wp[:, 0], live=live)
        attn = _maybe_lora(attn.reshape(B, T, H * hd), blk["wo"], lora_layer, "wo",
                           lora_scale, dtype)
        h, _ = _block_ffn(config, blk, h + attn, lora_layer, lora_scale)
        new_k.append(k if multi else k[:, 0])
        new_v.append(v if multi else v[:, 0])
    hidden = _rms(h, params["ln_f"], config.rms_eps).float()
    return hidden, (torch.stack(new_k), torch.stack(new_v))


def _head(config: GPTConfig, params: Params) -> torch.Tensor:
    """[D, V] head, a view (transposed for tied embeddings)."""
    return params["tok_emb"].t() if config.tie_embeddings else params["lm_head"]


def logits_fn(config: GPTConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, T, D] -> logits [B, T, V] (float32, f32 head)."""
    return hidden @ _head(config, params).float()


def apply(config: GPTConfig, params: Params, tokens: torch.Tensor, **kw):
    """Full forward to logits: (logits [B, T, V] float32, cache), and with
    ``return_aux=True`` (logits, cache, MoE load-balance loss)."""
    if kw.get("return_aux"):
        hidden, caches, aux = forward(config, params, tokens, **kw)
        return logits_fn(config, params, hidden), caches, aux
    hidden, caches = forward(config, params, tokens, **kw)
    return logits_fn(config, params, hidden), caches


# --------------------------------------------------------------------------- #
# Token log-probs
# --------------------------------------------------------------------------- #


def token_logprobs(
    config: GPTConfig,
    params: Params,
    tokens: torch.Tensor,  # [B, T]
    attention_mask: Optional[torch.Tensor] = None,
    lora: Optional[Params] = None,
    lora_scale: float = 2.0,
    temperature: float = 1.0,
    chunk_size: int = 128,
    use_fused: bool = False,
    flash: Optional[bool] = None,
) -> torch.Tensor:
    """log p(tokens[:, t] | tokens[:, <t]) for t >= 1, shape [B, T-1].

    ``use_fused`` is the JAX function's ``use_pallas``: the lm head and the
    log-softmax go through ``ops/fused_loss.fused_token_logprob_diff`` (the
    fused kernels on CUDA tensors, forward and backward), else through row
    chunks of ``chunk_size`` whose [chunk, V] logits are materialised. Both
    kernel paths serve the no-grad passes and the differentiable GRPO loss."""
    hidden, _ = forward(config, params, tokens, attention_mask=attention_mask,
                        lora=lora, lora_scale=lora_scale, flash=flash)
    B, T, D = hidden.shape
    flat_h = hidden[:, :-1].reshape(-1, D)  # predict the next token
    flat_t = tokens[:, 1:].reshape(-1)
    head = _head(config, params)
    if use_fused:
        lp = fused_token_logprob_diff(flat_h, head.float().contiguous(), flat_t, temperature)
        return lp.reshape(B, T - 1)
    head = head.float()
    out = []
    for c0 in range(0, flat_h.shape[0], chunk_size):
        logits = (flat_h[c0:c0 + chunk_size] @ head) / temperature  # [chunk, V]
        logz = torch.logsumexp(logits, dim=-1)
        chosen = logits.gather(1, flat_t[c0:c0 + chunk_size].long()[:, None])[:, 0]
        out.append(chosen - logz)
    return torch.cat(out).reshape(B, T - 1)
