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

Under a mesh (``parallel/plan.py``) the parameters are DTensors. A block's
weights are gathered where they are used, over every mesh axis but ``tp``
(``_at_use``: fsdp's all-gather per layer, through ``parallel/comm``'s plain
c10d gathers, never DTensor's own), so the projections run column- and
row-parallel over tp by DTensor's sharding propagation; a tp that does not
divide the head counts leaves the attention weights whole over tp (the
plan's ``heads``), and attention then runs replicated over tp; activations are
DTensors with rows over the data axes, and plain tensors beside them count
as replicated (``implicit_replication``). The hand-written kernels cannot
take a DTensor: the flash call and the fused log-probability call run
through ``local_map``, on placements from ``flash_shard_axes`` ((batch
axes, head axes)) and ``fused_loss_shard_axes`` (row axes), as the JAX
package wraps them in ``shard_map``. A dimension that the axes do not tile
stays whole. With plain activations and plain caches every DTensor weight
is gathered whole where it is used.

KV caches placed on a mesh (DTensor ``k`` / ``v`` / ``mask``, as the serving
tier allocates them by the plan's ``kv`` / ``kv_paged`` rules) make the
cached forwards run as the learn runs: the tokens become DTensors with
rows over the cache's data axes, the projections stay tp-parallel, the
embedding is a vocab-parallel lookup, and the cache write, the paged
gather and ``chunked_cached_attention`` run on each rank's own rows and KV
heads through ``local_map``. Writes go to the local shards in place.
``serving_logits`` keeps the head's tp placement and brings the logits
back whole (``parallel/comm.all_gather_cat``), so every rank samples every
row at its global index.

``GPTConfig.remat`` is the JAX package's per-block rematerialisation:
``torch.utils.checkpoint`` (non-reentrant) around each block of the
non-cached forward while grad is enabled. The block takes its weights where
it uses them inside the checkpoint, so under fsdp a gathered weight is freed
after the block's forward and gathered again in the recompute; the flash
forward runs again in each block's backward. The cached and no-grad forwards
never checkpoint (``jax.checkpoint`` outside differentiation is nothing).

Not ported here: ``scan_layers`` (an XLA compile-time device with no eager
counterpart) and the dense-attention kill switch of the paged forward
(``AGILERL_TPU_DISABLE_CHUNKED_DECODE``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

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
    remat: bool = False  # checkpoint each block of the learn (memory <-> FLOPs)
    use_flash_attention: bool = False  # flash kernel on the non-cached path
    # ((batch axes...), (head axes...)) mesh-axis names: under a mesh the
    # flash call runs through local_map with q/k/v [B, H, T, d] sharded on
    # dim 0 over the batch axes and dim 1 over the head axes. None = the
    # data axes ("dp", "fsdp") and ("tp",).
    flash_shard_axes: Any = None
    # (row axes...) of the fused lm-head loss: under a mesh the rows shard
    # over these axes inside local_map and the head stays whole per rank.
    # None = the data axes.
    fused_loss_shard_axes: Any = None
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
    layers, in place. new_k/new_v: [L, B, KV, hd]; write_pos: [B]. A placed
    pool takes every row's new tokens at its own KV heads."""
    pk, pv = local_shard(cache.k), local_shard(cache.v)
    L, nb, bs, KV, hd = pk.shape
    idx = paged_write_index(block_tables, write_pos, bs)
    pk.view(L, nb * bs, KV, hd)[:, idx] = _as_pool_local(cache.k, new_k, 2)
    pv.view(L, nb * bs, KV, hd)[:, idx] = _as_pool_local(cache.v, new_v, 2)
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
    pk, pv = local_shard(cache.k), local_shard(cache.v)
    L, nb, bs, KV, hd = pk.shape
    B, T = write_pos.shape
    mb = block_tables.shape[1]
    bidx = (write_pos // bs).clamp_max(mb - 1).long()
    phys = block_tables.gather(1, bidx).long()
    phys = torch.where(write_pos < mb * bs, phys, 0)
    idx = (phys * bs + (write_pos % bs).long()).reshape(-1)
    pk.view(L, nb * bs, KV, hd)[:, idx] = _as_pool_local(cache.k, new_k, 3).reshape(
        L, B * T, KV, hd)
    pv.view(L, nb * bs, KV, hd)[:, idx] = _as_pool_local(cache.v, new_v, 3).reshape(
        L, B * T, KV, hd)
    return cache


def paged_scatter_prompt(cache: PagedKVCache, block_ids: torch.Tensor,
                         k_prompt: torch.Tensor, v_prompt: torch.Tensor,
                         local: bool = False) -> PagedKVCache:
    """Write one request's prefilled prompt KV ([L, Pb, KV, hd], Pb a whole
    number of blocks) into its physical blocks ([Pb // bs]), in place. A
    placed pool takes its own KV heads of a whole (or DTensor) prompt KV;
    ``local=True`` says the prompt KV already holds exactly those heads."""
    pk, pv = local_shard(cache.k), local_shard(cache.v)
    L, _, bs, KV, hd = pk.shape
    nb_p = k_prompt.shape[1] // bs
    ids = block_ids.long()
    if not local:
        k_prompt = _as_pool_local(cache.k, k_prompt, 2)
        v_prompt = _as_pool_local(cache.v, v_prompt, 2)
    pk[:, ids] = k_prompt.reshape(L, nb_p, bs, KV, hd).to(pk.dtype)
    pv[:, ids] = v_prompt.reshape(L, nb_p, bs, KV, hd).to(pv.dtype)
    return cache


def paged_copy_block(cache: PagedKVCache, src, dst) -> PagedKVCache:
    """Copy one physical block, in place (prefix-cache hit: the last prompt
    block is duplicated into a private block so the first decode write
    cannot touch the shared original)."""
    for pool in (local_shard(cache.k), local_shard(cache.v)):
        pool[:, dst] = pool[:, src]
    return cache


def cache_bytes(cache: Union[KVCache, PagedKVCache]) -> int:
    """Bytes of this rank's ``k`` and ``v`` (its shards of a placed cache)."""
    return sum(t.numel() * t.element_size() for t in map(local_shard, (cache.k, cache.v)))


def kv_head_range(pool: torch.Tensor) -> Tuple[int, int]:
    """The global KV heads ``[lo, hi)`` that this rank's shard of a dense
    cache or paged pool (``[L, *, *, KV, hd]``) holds: all of them unplaced."""
    n = pool.shape[_KV_DIM]
    if not isinstance(pool, DTensor):
        return 0, n
    lo, size = 0, n
    mesh = pool.device_mesh
    for md, p in enumerate(pool.placements):
        if isinstance(p, Shard) and p.dim == _KV_DIM:
            size //= mesh.size(md)
            lo += mesh.get_local_rank(md) * size
    return lo, lo + size


# --------------------------------------------------------------------------- #
# Init
# --------------------------------------------------------------------------- #


def _generator(generator: GeneratorLike, device: torch.device) -> Optional[torch.Generator]:
    if isinstance(generator, torch.Generator):
        return generator
    if device.type == "meta":  # shapes only: nothing is drawn
        return None
    return torch.Generator(device=device).manual_seed(int(generator))


def _normal(gen, shape, std, dtype, device):
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
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
    ``generator`` (a seed or a torch.Generator on ``device``). On the
    ``"meta"`` device the tree holds shapes only."""
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
# Under a mesh
# --------------------------------------------------------------------------- #

_DATA_AXES = ("dp", "fsdp")


def _gather(w: DTensor, keep: Tuple[str, ...] = ()) -> DTensor:
    """``w`` whole over every mesh dim but ``keep`` (``comm.gather_dtensor``:
    never DTensor's own all-gather)."""
    from agilerl_tpu_torch.parallel.comm import gather_dtensor

    return gather_dtensor(w, keep)


def _at_use(w: Any, x: Any) -> Any:
    """A weight where it is used with activations ``x``. A DTensor weight
    beside DTensor activations is gathered over every mesh axis but ``tp``
    (its tp placement stays, so the product is tp-parallel); beside plain
    activations it is gathered whole. Anything else passes."""
    if not isinstance(w, DTensor):
        return w
    if not isinstance(x, DTensor):
        return _gather(w).to_local()
    return _gather(w, keep=("tp",))


def _whole(w: Any, x: Any) -> Any:
    """A weight gathered whole where it is used (embedding table, head):
    a replicated DTensor beside DTensor activations, else a plain tensor."""
    if not isinstance(w, DTensor):
        return w
    return _gather(w) if isinstance(x, DTensor) else _gather(w).to_local()


def _tree_at_use(tree: Any, x: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_at_use(v, x) for k, v in tree.items()}
    return _at_use(tree, x)


def _under_mesh(x: Any):
    """``implicit_replication`` while the activations are DTensors: the plain
    tensors a forward makes (positions, masks, RoPE tables) count as
    replicated."""
    if isinstance(x, DTensor):
        from torch.distributed.tensor.experimental import implicit_replication

        return implicit_replication()
    return contextlib.nullcontext()


def _axes_size(mesh, axes: Tuple[str, ...]) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n = 1
    for ax in axes:
        n *= int(sizes.get(ax, 1))
    return n


def _placements(mesh, dims: Dict[int, Tuple[str, ...]]) -> list:
    """One placement per mesh dim: ``Shard(d)`` where ``dims[d]`` lists the
    axis, else ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dim = next((d for d, axes in dims.items() if name in axes), None)
        out.append(Shard(dim) if dim is not None else Replicate())
    return out


def _axes(value, default) -> Tuple[str, ...]:
    if value is None:
        return tuple(default)
    return (value,) if isinstance(value, str) else tuple(value)


def _flash_mapped(config: "GPTConfig", q, k, v, attention_mask):
    """The flash call on DTensors [B, H, T, d] through ``local_map``: batch
    over the first of ``flash_shard_axes``, heads over the second (q heads
    and kv heads alike, so each rank keeps whole GQA groups)."""
    from torch.distributed.tensor.experimental import local_map

    bax, hax = config.flash_shard_axes or (_DATA_AXES, ("tp",))
    bax, hax = _axes(bax, _DATA_AXES), _axes(hax, ("tp",))
    mesh = q.device_mesh
    nh = _axes_size(mesh, hax)
    dims = {0: bax if q.shape[0] % _axes_size(mesh, bax) == 0 else (),
            1: hax if q.shape[1] % nh == 0 and k.shape[1] % nh == 0 else ()}
    qpl = _placements(mesh, dims)
    mpl = _placements(mesh, {0: dims[0]})
    mapped = local_map(
        lambda qq, kk, vv, mm: flash_attention_diff(qq, kk, vv, mm, True),
        out_placements=qpl, in_placements=(qpl, qpl, qpl, mpl),
        redistribute_inputs=True, device_mesh=mesh)
    return mapped(q, k, v, attention_mask)


def _fused_mapped(config: "GPTConfig", flat_h, head, flat_t, temperature: float):
    """The fused log-probability call on DTensors through ``local_map``: rows
    over ``fused_loss_shard_axes`` when they tile them, the head whole."""
    from torch.distributed.tensor.experimental import local_map

    mesh = flat_h.device_mesh
    rax = _axes(config.fused_loss_shard_axes, _DATA_AXES)
    rpl = _placements(mesh, {0: rax if flat_h.shape[0] % _axes_size(mesh, rax) == 0 else ()})
    whole = [Replicate()] * mesh.ndim
    mapped = local_map(
        lambda hh, ww, tt: fused_token_logprob_diff(hh, ww, tt, temperature),
        out_placements=rpl, in_placements=(rpl, whole, rpl),
        redistribute_inputs=True, device_mesh=mesh)
    return mapped(flat_h, head, flat_t)


#: the KV-head dim of a dense cache [L, B, S, KV, hd] and of a paged pool
#: [L, n_blocks, block_size, KV, hd]
_KV_DIM = 3


def local_shard(x: Any) -> Any:
    """A DTensor's local shard (a view: writes to it reach the DTensor),
    anything else as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def _like(pool: DTensor, dims: Dict[int, int]) -> list:
    """Placements on ``pool``'s mesh for another tensor: ``Shard(dims[d])``
    where the pool shards its dim ``d``, else ``Replicate()``."""
    return [Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in pool.placements]


def _as_pool_local(pool: Any, x: Any, kv_dim: int) -> Any:
    """``x``, whole over its rows, at the KV heads (its dim ``kv_dim``) that
    this rank's shard of ``pool`` holds, as a plain tensor: a DTensor is
    redistributed, a plain tensor sliced. Unplaced, ``x`` as it is."""
    if not isinstance(pool, DTensor):
        return x
    from torch.distributed.tensor import distribute_tensor

    pl = _like(pool, {_KV_DIM: kv_dim})
    if isinstance(x, DTensor):
        # rows gathered through comm (_gather); what is left of the move is
        # a local slice
        keep = tuple(n for n, a, b in zip(x.device_mesh.mesh_dim_names, x.placements, pl)
                     if a == b)
        return _gather(x, keep).redistribute(pool.device_mesh, pl).to_local()
    return distribute_tensor(x, pool.device_mesh, pl, src_data_rank=None).to_local()


def _row_placements(mesh, rows: int) -> list:
    """Rows over the mesh's data axes when they tile ``rows``, else whole."""
    axes = tuple(a for a in _DATA_AXES if a in mesh.mesh_dim_names)
    return _placements(mesh, {0: axes if rows % _axes_size(mesh, axes) == 0 else ()})


def _onto(mesh, placements, *tensors):
    """Plain tensors that every rank holds whole as DTensors with
    ``placements``: each rank keeps its own slice, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return tuple(t if t is None or isinstance(t, DTensor)
                 else distribute_tensor(t, mesh, placements, src_data_rank=None)
                 for t in tensors)


def _reduced(x: Any) -> Any:
    """A DTensor with its pending sums done (``Partial`` -> ``Replicate``)."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_partial() else p for p in x.placements])


def _mapped(fn, pool: DTensor, rows: list, heads: Dict[int, int], args, kinds):
    """``fn`` on each rank's own rows and KV heads through ``local_map``.
    ``kinds`` names each argument's layout: ``"qkv"`` ([B, T, H|KV, hd]:
    rows on dim 0, heads on dim 2), ``"pool"`` (the pool's own placements)
    or ``"rows"`` (rows on dim 0). The output is laid out as ``"qkv"``."""
    from torch.distributed.tensor.experimental import local_map

    row_dims = {m: p for m, p in enumerate(rows) if isinstance(p, Shard)}
    qkv = [row_dims.get(m, p) for m, p in enumerate(_like(pool, heads))]
    layouts = {"qkv": qkv, "pool": list(pool.placements), "rows": rows}
    mapped = local_map(fn, out_placements=qkv, in_placements=tuple(layouts[k] for k in kinds),
                       redistribute_inputs=True, device_mesh=pool.device_mesh)
    return mapped(*args)


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


def _attention(config: GPTConfig, q, k, v, attention_mask, use_flash: bool):
    """Non-cached attention of q/k/v [B, T, H|KV, hd] -> [B, H, T, hd]."""
    if use_flash and isinstance(q, DTensor):
        return _flash_mapped(config, q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), attention_mask)
    if use_flash:
        # the kernel reads KV head h // rep: no repeated copy of K/V
        return flash_attention_diff(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), attention_mask, True)
    return _dense_attention(config, q, k, v, attention_mask)


def _block(config: GPTConfig, blk: Params, lora_layer: Optional[Params], h, attention_mask,
           positions, use_flash: bool, lora_scale: float):
    """One block of the non-cached forward: (h_out, MoE aux). The weights
    and the adapter are taken where they are used in here, so that under
    ``remat`` an fsdp gather is freed after the forward and repeated in the
    recompute (which runs outside ``forward``'s mesh context: hence the
    block's own)."""
    with _under_mesh(h):
        blk = _tree_at_use(blk, h)
        lora_layer = _tree_at_use(lora_layer, h)
        B, T = h.shape[:2]
        x = _rms(h, blk["ln1"], config.rms_eps)
        q, k, v = _qkv_rope(config, blk, x, positions, lora_layer, lora_scale)
        attn = _attention(config, q, k, v, attention_mask, use_flash)
        attn = attn.transpose(1, 2).reshape(B, T, config.n_head * config.head_dim)
        attn = _maybe_lora(attn, blk["wo"], lora_layer, "wo", lora_scale, config.dtype)
        return _block_ffn(config, blk, h + attn, lora_layer, lora_scale)


def block_apply_dense(config: GPTConfig, blk: Params, h: torch.Tensor,
                      attention_mask: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """One dense block with no cache, LoRA or MoE: the stage body of
    ``parallel/pipeline.py``, the block ``forward`` runs on its non-cached
    dense path. h: [B, T, d]."""
    return _block(config, blk, None, h, attention_mask, positions, False, 0.0)[0]


def _cached_attention(q, k, v, cache: KVCache, i: int, start: int):
    """Write layer ``i``'s new k/v at ``[start, start + T)`` of the dense
    cache (in place) and attend over it: [B, T, H, hd]. A placed cache runs
    this on each rank's rows and KV heads."""
    T = q.shape[1]

    def attend(q, k, v, ck, cv, cmask):
        ck[i, :, start:start + T] = k
        cv[i, :, start:start + T] = v
        return chunked_cached_attention(q, ck[i], cv[i], cmask, start)

    if not isinstance(cache.k, DTensor):
        return attend(q, k, v, cache.k, cache.v, cache.mask)
    return _mapped(attend, cache.k, _like(cache.k, {1: 0}), {_KV_DIM: 2},
                   (q, k, v, cache.k, cache.v, cache.mask),
                   ("qkv", "qkv", "qkv", "pool", "pool", "rows"))


def _paged_attention(q, k, v, cache: PagedKVCache, i: int, block_tables, slot_mask, wp,
                     rows: Optional[list], live: Optional[int]):
    """Layer ``i``'s attention over each slot's gathered slab with this
    step's k/v inserted (the pool is only read): [B, T, H, hd]. A placed
    pool runs this on each rank's rows and KV heads (``rows``: the rows'
    placements)."""

    def attend(q, k, v, pool_k, pool_v, block_tables, slot_mask, wp):
        B, T = q.shape[:2]
        S = block_tables.shape[1] * pool_k.shape[2]
        # the slab insert drops positions past the extent S (a released
        # slot whose lengths ran on), as the JAX scatter does out of
        # bounds: a row's T positions are consecutive and T <= S, so their
        # residues mod S are distinct; a dropped position rewrites its
        # residue's own old value
        col = (wp % S).long()
        keep = (wp < S)[..., None, None]
        r = torch.arange(B, device=q.device)[:, None].expand(B, T)
        k_slab, v_slab = paged_gather(pool_k[i], pool_v[i], block_tables)
        k_slab[r, col] = torch.where(keep, k, k_slab[r, col])
        v_slab[r, col] = torch.where(keep, v, v_slab[r, col])
        return chunked_cached_attention(q, k_slab, v_slab, slot_mask, wp[:, 0], live=live)

    args = (q, k, v, cache.k, cache.v, block_tables, slot_mask, wp)
    if not isinstance(cache.k, DTensor):
        return attend(*args)
    return _mapped(attend, cache.k, rows, {_KV_DIM: 2}, args,
                   ("qkv", "qkv", "qkv", "pool", "pool", "rows", "rows", "rows"))


def _serving_block(config: GPTConfig, blk: Params, lora_layer: Optional[Params], h, positions,
                   lora_scale: float, attend):
    """One block of a cached forward: ``attend(q, k, v)`` is the cache's
    attention. Returns (h_out, MoE aux, k, v). Under a mesh the two
    row-parallel outputs (``wo``, ``w_down``) are summed where they join the
    residual stream (one all-reduce each over tp), so the stream stays
    replicated over tp and every projection reads it as it is."""
    blk = _tree_at_use(blk, h)
    lora_layer = _tree_at_use(lora_layer, h)
    B, T = h.shape[:2]
    x = _rms(h, blk["ln1"], config.rms_eps)
    q, k, v = _qkv_rope(config, blk, x, positions, lora_layer, lora_scale)
    attn = attend(q, k, v).reshape(B, T, config.n_head * config.head_dim)
    attn = _maybe_lora(attn, blk["wo"], lora_layer, "wo", lora_scale, config.dtype)
    h, aux = _block_ffn(config, blk, h + _reduced(attn), lora_layer, lora_scale)
    return _reduced(h), aux, k, v


def _embed(config: GPTConfig, params: Params, tokens, placed: bool):
    """Token embeddings in ``config.dtype``. Under a placed cache the lookup
    is vocab-parallel (the table keeps its tp shard; the partial rows are
    summed at once), else the table is gathered whole where it is used."""
    if placed:
        return _reduced(F.embedding(tokens, _at_use(params["tok_emb"], tokens))).to(config.dtype)
    return F.embedding(tokens, _whole(params["tok_emb"], tokens)).to(config.dtype)


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
    ``chunked_cached_attention``. DTensor tokens and parameters, or a placed
    cache, run under a mesh (see the module's docstring); the hidden then
    is a DTensor with rows over the data axes. ``config.remat`` checkpoints
    each block of the non-cached forward while grad is enabled."""
    B, T = tokens.shape
    if attention_mask is None:
        attention_mask = torch.ones((B, T), dtype=torch.int32, device=tokens.device)
    if positions is None:
        positions = (attention_mask.cumsum(dim=-1) - 1).clamp_min(0)
    if cache is not None and isinstance(cache.k, DTensor):
        tokens, attention_mask, positions = _onto(
            cache.k.device_mesh, _like(cache.k, {1: 0}), tokens, attention_mask, positions)
    with _under_mesh(tokens):
        return _forward(config, params, tokens, attention_mask, positions, cache, lora,
                        lora_scale, flash, return_aux)


def _forward(config, params, tokens, attention_mask, positions, cache, lora, lora_scale,
             flash, return_aux):
    B, T = tokens.shape
    use_flash = config.use_flash_attention if flash is None else flash
    placed = cache is not None and isinstance(cache.k, DTensor)
    h = _embed(config, params, tokens, placed)
    remat = config.remat and cache is None and torch.is_grad_enabled()

    if cache is not None:
        start = cache.length
        local_shard(cache.mask)[:, start:start + T] = local_shard(attention_mask).to(torch.int32)

    aux_total = 0.0
    for i in range(config.n_layer):
        blk = params["blocks"][str(i)]
        layer = lora["blocks"].get(str(i)) if lora is not None else None
        if cache is not None:
            h, aux, _, _ = _serving_block(
                config, blk, layer, h, positions, lora_scale,
                lambda q, k, v, i=i: _cached_attention(q, k, v, cache, i, start))
        elif remat:
            h, aux = checkpoint(_block, config, blk, layer, h, attention_mask, positions,
                                use_flash, lora_scale, use_reentrant=False,
                                preserve_rng_state=False)  # a block draws nothing
        else:
            h, aux = _block(config, blk, layer, h, attention_mask, positions, use_flash,
                            lora_scale)
        aux_total = aux_total + aux

    new_cache = None
    if cache is not None:
        new_cache = KVCache(cache.k, cache.v, start + T, cache.mask)
    hidden = _rms(h, _at_use(params["ln_f"], h), config.rms_eps).float()
    if return_aux:
        return hidden, new_cache, torch.as_tensor(aux_total, dtype=torch.float32,
                                                  device=tokens.device)
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
    maximum.

    A placed pool (DTensors by the plan's ``kv_paged`` rules: KV heads over
    tp, the block axis whole) runs the slots' rows over the mesh's data
    axes when they tile them; hidden and the new KV are then DTensors."""
    B, T = tokens.shape
    multi = write_pos.dim() == 2
    pos2d = positions if positions.dim() == 2 else positions[:, None]
    wp = write_pos if multi else write_pos[:, None]  # [B, T]
    rows = None
    placed = isinstance(cache.k, DTensor)
    if placed:
        rows = _row_placements(cache.k.device_mesh, B)
        tokens, pos2d, wp, block_tables, slot_mask = _onto(
            cache.k.device_mesh, rows, tokens, pos2d, wp, block_tables, slot_mask)
    with _under_mesh(tokens):
        h = _embed(config, params, tokens, placed)
        new_k, new_v = [], []
        for i in range(config.n_layer):
            layer = lora["blocks"].get(str(i)) if lora is not None else None
            h, _, k, v = _serving_block(
                config, params["blocks"][str(i)], layer, h, pos2d, lora_scale,
                lambda q, k, v, i=i: _paged_attention(q, k, v, cache, i, block_tables,
                                                      slot_mask, wp, rows, live))
            new_k.append(k if multi else k[:, 0])
            new_v.append(v if multi else v[:, 0])
        hidden = _rms(h, _at_use(params["ln_f"], h), config.rms_eps).float()
        return hidden, (torch.stack(new_k), torch.stack(new_v))


def _head(config: GPTConfig, params: Params, x: Any = None) -> torch.Tensor:
    """[D, V] head, a view (transposed for tied embeddings); a DTensor head
    is gathered whole for activations ``x``."""
    head = params["tok_emb"] if config.tie_embeddings else params["lm_head"]
    head = _whole(head, x)
    return head.t() if config.tie_embeddings else head


def logits_fn(config: GPTConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, T, D] -> logits [B, T, V] (float32, f32 head)."""
    with _under_mesh(hidden):
        return hidden @ _head(config, params, hidden).float()


def serving_logits(config: GPTConfig, params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """``logits_fn`` for generation, as a plain tensor on every rank. A
    DTensor hidden (a placed cache's forward) meets the head at its tp
    placement (a vocab-parallel product: the head is not gathered), and the
    logits come back whole, so every rank samples every row at its global
    index as the unplaced generator does."""
    if not isinstance(hidden, DTensor):
        return logits_fn(config, params, hidden)
    with _under_mesh(hidden):
        head = _at_use(params["tok_emb"] if config.tie_embeddings else params["lm_head"], hidden)
        logits = _reduced(hidden @ (head.t() if config.tie_embeddings else head).float())
    return _gathered(logits)


def _gathered(x: DTensor) -> torch.Tensor:
    """A DTensor without pending sums as this rank's whole plain tensor,
    gathered over each sharding mesh dim's group, innermost first
    (``parallel/comm.all_gather_cat``, which stages card tensors through
    host buffers on a gloo group)."""
    from agilerl_tpu_torch.parallel.comm import all_gather_cat

    mesh, t = x.device_mesh, x.to_local()
    for md in reversed(range(mesh.ndim)):
        p = x.placements[md]
        if isinstance(p, Shard):
            t = all_gather_cat(t, mesh.get_group(md), p.dim)
    return t


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
    with _under_mesh(tokens):
        return _token_logprobs(config, params, tokens, attention_mask, lora, lora_scale,
                               temperature, chunk_size, use_fused, flash)


def _token_logprobs(config, params, tokens, attention_mask, lora, lora_scale, temperature,
                    chunk_size, use_fused, flash):
    hidden, _ = forward(config, params, tokens, attention_mask=attention_mask,
                        lora=lora, lora_scale=lora_scale, flash=flash)
    B, T, D = hidden.shape
    flat_h = hidden[:, :-1].reshape(-1, D)  # predict the next token
    flat_t = tokens[:, 1:].reshape(-1)
    head = _head(config, params, hidden)
    if use_fused:
        if isinstance(flat_h, DTensor):
            lp = _fused_mapped(config, flat_h, head.float().contiguous(), flat_t, temperature)
        else:
            lp = fused_token_logprob_diff(flat_h, head.float().contiguous(), flat_t,
                                          temperature)
        return lp.reshape(B, T - 1)
    head = head.float()
    out = []
    for c0 in range(0, flat_h.shape[0], chunk_size):
        logits = (flat_h[c0:c0 + chunk_size] @ head) / temperature  # [chunk, V]
        logz = torch.logsumexp(logits, dim=-1)
        chosen = logits.gather(1, flat_t[c0:c0 + chunk_size].long()[:, None])[:, 0]
        out.append(chosen - logz)
    return torch.cat(out).reshape(B, T - 1)
