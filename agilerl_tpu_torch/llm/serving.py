"""The single-replica serving tier: the port of ``agilerl_tpu/llm/serving.py``
(``BucketedGenerator``, and ``ContinuousGenerator`` with the paged KV pool,
the prefix cache, admission control, speculative decoding and decode-captured
logprobs).

1. **Prompt/row bucketing** (``BucketedGenerator``): prompt length rounds UP
   to a bucket and rows pad to a row bucket, so an arbitrary stream of ragged
   batches runs at most ``2 x |buckets used|`` distinct programs (one prefill
   + one decode chunk per bucket shape), and decode runs in fixed-size chunks
   with an all-rows-done check between chunks: a batch whose completions all
   hit EOS stops within ``decode_chunk`` tokens.
2. **Continuous batching on a paged pool** (``ContinuousGenerator``): ONE
   decode program over a fixed ``[slots, ...]`` width; the host scheduler
   admits queued requests into freed slots BETWEEN decode chunks.

The JAX package counts programs in XLA's jit caches; the port runs eagerly,
so ``compiled_programs`` counts the distinct ``(callable, input shapes,
greedy, adapter present)`` signatures a generator has run: the set a CUDA
graph per bucket would capture. ``compile_cache=`` raises
``NotImplementedError``: the port runs eagerly.

``sharding_plan=`` / ``mesh=`` (``parallel/plan.py``): ``place_params``
places weight trees by the plan's ``params`` / ``lora`` rules (DTensors,
which the model gathers whole where it uses them: every decode step
all-gathers each sharded weight). The KV caches stay whole on every rank and
the plan's ``kv`` / ``kv_paged`` rules are not applied: the decode step runs
on plain tensors.

Host state: the scheduler keeps the per-slot state (block tables, slot mask,
lengths, previous token, positions, step indices, done flags, keys) in numpy
mirrors, as the JAX package does; each chunk copies them to the device and
back (a few KiB). The KV pool lives on the device and is written in place.
Latency telemetry (TTFT, decode time per token) is taken after the tokens
reach the host.

Greedy decoding is token for token ``llm/generate.generate``'s at the same
prompt bucket (same prefill maths, same per-step decode maths).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from agilerl_tpu_torch import observability
from agilerl_tpu_torch.llm import model as M
from agilerl_tpu_torch.llm.convert import tensor_from_host
from agilerl_tpu_torch.llm.generate import (
    decode_step,
    fold_in,
    left_pad,
    paged_decode_step,
    prefill_head,
    request_key,
)
from agilerl_tpu_torch.llm.speculate import (
    CompletionCache,
    NgramProposer,
    as_spec_config,
    paged_verify_step,
)
from agilerl_tpu_torch.ops import DeviceLike, resolve_device

#: TTFT buckets (s)
TTFT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                2.5, 5.0, 10.0, 30.0, 60.0, 120.0)
#: per-token decode buckets (s): 10µs .. 1s
DECODE_BUCKETS = (1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3,
                  5e-3, 1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0)
#: queue-depth buckets (rows in flight), the row bucket grid
QUEUE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
#: accepted-draft-length buckets (tokens); 0 is a real outcome
SPEC_LEN_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32)
#: queue-wait buckets (s)
QUEUE_WAIT_BUCKETS = (0.0001, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                      1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _round_up(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} exceeds the largest bucket {buckets[-1]}")


def _sampling_knobs(gen, greedy: bool, lora) -> Dict[str, Any]:
    """The per-call knob dict both generators hand to the shared
    prefill/decode building blocks: ONE home so the two tiers cannot sample
    differently."""
    return dict(
        lora=lora, lora_scale=gen.lora_scale,
        temperature=0.0 if greedy else gen.temperature,
        top_k=gen.top_k, top_p=gen.top_p, eos_id=gen.eos_id,
        pad_id=gen.pad_id, min_new_tokens=gen.min_new_tokens,
    )


def _no_compile_cache(compile_cache) -> None:
    if compile_cache is not None:
        raise NotImplementedError(
            "compile_cache= is not ported yet: the port runs eagerly")


def _resolve_serving_plan(sharding_plan, mesh, device):
    """The (plan, mesh) pair both generators accept: a plan name resolves
    through the registry and a plan without a mesh builds its own. Neither
    keeps the plan-free path."""
    if sharding_plan is None:
        return None, mesh
    from agilerl_tpu_torch.parallel.plan import resolve_plan_and_mesh

    return resolve_plan_and_mesh(sharding_plan, mesh, device=device)


class _PlanPlacement:
    """``place_params`` of a generator under a plan."""

    sharding_plan = None
    mesh = None

    def place_params(self, params, lora=None):
        """Place weight trees by the plan's ``params`` / ``lora`` rules (as
        they are without a plan)."""
        if self.sharding_plan is None:
            return (params, lora) if lora is not None else params
        params = self.sharding_plan.place("params", params, self.mesh)
        if lora is not None:
            return params, self.sharding_plan.place("lora", lora, self.mesh)
        return params


def _generator_for(key, device: torch.device, greedy: bool) -> Optional[torch.Generator]:
    """The batch stream of a ``BucketedGenerator`` call: a ``torch.Generator``
    on the generator's device as given, or one seeded from an int."""
    if isinstance(key, torch.Generator):
        return key
    if key is None:
        if not greedy:
            raise ValueError("sampled generation needs a key (a seed or a torch.Generator)")
        return None
    return torch.Generator(device=device).manual_seed(int(key))


def _raw_key(key) -> np.ndarray:
    """A ``ContinuousGenerator`` base key: an int seed, a counter key pair
    ([2]), or a ``torch.Generator`` (one draw from it becomes the seed)."""
    if isinstance(key, torch.Generator):
        seed = torch.randint(0, 2 ** 31 - 1, (1,), generator=key, device=key.device)
        return request_key(int(seed.item()))
    arr = np.asarray(key)
    if arr.shape == (2,):
        return arr.astype(np.int64)
    return request_key(int(arr))


class BucketedGenerator(_PlanPlacement):
    """Bounded ragged serving over one (config, sampling recipe). Sampling
    knobs are fixed at construction; params/lora ride as call arguments, so
    training steps between calls change nothing here. ``device=None`` means
    the card (raises without one)."""

    def __init__(
        self,
        config: M.GPTConfig,
        max_new_tokens: int = 64,
        pad_id: int = 0,
        eos_id: Optional[int] = None,
        prompt_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
        row_buckets: Sequence[int] = (8, 16, 32, 64, 128),
        decode_chunk: int = 32,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        min_new_tokens: Optional[int] = None,
        lora_scale: float = 2.0,
        metrics=None,
        sharding_plan=None,
        mesh=None,
        device: DeviceLike = None,
    ):
        self.dev = resolve_device(device)
        self.sharding_plan, self.mesh = _resolve_serving_plan(sharding_plan, mesh, self.dev)
        self.config = config
        self.metrics = metrics if metrics is not None else observability.get_registry()
        self._pending_rows = 0
        self._pending_lock = threading.Lock()
        self.pad_id = int(pad_id)
        self.eos_id = eos_id
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.row_buckets = tuple(sorted(row_buckets))
        # a chunk larger than the whole budget would waste decode forwards
        self.decode_chunk = min(int(decode_chunk), int(max_new_tokens))
        # cache length is fixed per prompt bucket: bucket + whole chunks
        self.n_chunks = -(-int(max_new_tokens) // self.decode_chunk)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_new_tokens = min_new_tokens
        self.lora_scale = lora_scale
        # the distinct program signatures run (compiled_programs)
        self._programs = set()

    def _knobs(self, greedy: bool, lora) -> Dict[str, Any]:
        return _sampling_knobs(self, greedy, lora)

    def _prefill(self, params, lora, prompt, prompt_mask, row_valid, generator, greedy):
        B, P = prompt.shape
        self._programs.add(("prefill", B, P, bool(greedy), lora is None))
        caches = M.init_caches(self.config, B, P + self.n_chunks * self.decode_chunk,
                               device=self.dev)
        return prefill_head(self.config, params, prompt, prompt_mask, caches, generator,
                            row_valid=row_valid, **self._knobs(greedy, lora))

    def _decode(self, params, lora, carry, start_step: int, greedy):
        """One fixed-size decode chunk, restartable through the carry."""
        cache = carry[0]
        self._programs.add(("decode", cache.k.shape[1], cache.k.shape[2], bool(greedy),
                            lora is None))
        knobs = self._knobs(greedy, lora)
        toks, emits = [], []
        for i in range(start_step, start_step + self.decode_chunk):
            carry, (tok, emit) = decode_step(self.config, params, carry, i, **knobs)
            toks.append(tok)
            emits.append(emit)
        return carry, (torch.stack(toks, dim=1), torch.stack(emits, dim=1))

    @torch.no_grad()
    def generate(
        self,
        sequences: List[Any],
        key,
        params,
        lora=None,
        greedy: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
        """sequences: list of 1-D token id arrays (ragged). ``key``: a
        ``torch.Generator`` on the generator's device or an int seed (None
        only when greedy). Returns (completions [B, max_new_tokens], mask,
        info) as numpy, trimmed back to the true row count; info reports
        bucketing and early-exit telemetry."""
        B = len(sequences)
        if B == 0:
            raise ValueError(
                "BucketedGenerator.generate got an empty sequence list; "
                "callers should gate batches with fits(n_rows, longest)")
        longest = max(len(s) for s in sequences)
        if not self.fits(B, longest):
            raise ValueError(
                f"batch of {B} rows / longest prompt {longest} exceeds the "
                f"bucket grid (row_buckets<= {self.row_buckets[-1]}, "
                f"prompt_buckets<= {self.prompt_buckets[-1]}); check "
                "fits() and fall back to the dense generate path")
        generator = _generator_for(key, self.dev, greedy)
        Pb = _round_up(longest, self.prompt_buckets)
        Bb = _round_up(B, self.row_buckets)
        toks, mask = left_pad(sequences, self.pad_id, Pb)
        if Bb > B:
            toks = np.concatenate([toks, np.full((Bb - B, Pb), self.pad_id, np.int32)])
            mask = np.concatenate([mask, np.zeros((Bb - B, Pb), np.int32)])
        row_valid = torch.as_tensor(np.arange(Bb) < B, device=self.dev)

        with self._pending_lock:
            self._pending_rows += B
            pending = self._pending_rows
            self.metrics.gauge("serving/queue_depth").set(pending)
        self.metrics.histogram(
            "serving/queue_depth_rows", buckets=QUEUE_BUCKETS,
            help="rows in flight when a batch is admitted",
        ).observe(pending)
        t0 = time.perf_counter()

        steps = 1
        decode_elapsed_s = 0.0
        try:
            carry, (tok0, emit0) = self._prefill(
                params, lora, torch.as_tensor(toks, device=self.dev),
                torch.as_tensor(mask, device=self.dev), row_valid, generator, greedy)
            out_toks = [tok0.cpu().numpy()[:, None]]
            out_masks = [emit0.cpu().numpy()[:, None]]
            # the first token is on the host: that is TTFT
            ttft_s = time.perf_counter() - t0
            self.metrics.histogram(
                "serving/ttft_s", buckets=TTFT_BUCKETS,
                help="prefill-to-first-token latency").observe(ttft_s)
            for _ in range(self.n_chunks):
                if bool(carry[4].all()):
                    break  # every live row hit EOS: skip the remaining chunks
                if steps >= self.max_new_tokens:
                    break
                t_chunk = time.perf_counter()
                carry, (toks_c, emits_c) = self._decode(params, lora, carry, steps, greedy)
                out_toks.append(toks_c.cpu().numpy())
                out_masks.append(emits_c.cpu().numpy())
                dt_chunk = time.perf_counter() - t_chunk
                decode_elapsed_s += dt_chunk
                # the final chunk may overshoot max_new_tokens: meter the
                # DELIVERED tokens
                delivered_chunk = min(steps + self.decode_chunk, self.max_new_tokens) - steps
                self.metrics.histogram(
                    "serving/decode_time_per_token_s", buckets=DECODE_BUCKETS,
                    help="decode-chunk wall time / delivered chunk tokens",
                ).observe(dt_chunk / max(delivered_chunk, 1))
                steps += self.decode_chunk
        finally:
            with self._pending_lock:
                self._pending_rows -= B
                self.metrics.gauge("serving/queue_depth").set(self._pending_rows)
        comp = np.concatenate(out_toks, axis=1).astype(np.int32)
        cmask = np.concatenate(out_masks, axis=1).astype(np.int32)
        # trim: decode may stop early or overshoot the last chunk boundary;
        # rows beyond B are bucket padding
        N = self.max_new_tokens
        if comp.shape[1] < N:
            pad = N - comp.shape[1]
            comp = np.pad(comp, ((0, 0), (0, pad)), constant_values=self.pad_id)
            cmask = np.pad(cmask, ((0, 0), (0, pad)))
        info = {
            "prompt_bucket": Pb,
            "row_bucket": Bb,
            "decode_steps": steps,
            "max_new_tokens": N,
            "compiled_programs": self.compiled_programs,
            "ttft_s": round(ttft_s, 6),
            # delivered decode tokens beyond tok0 = min(steps, N) - 1
            "decode_time_per_token_s": (
                round(decode_elapsed_s / (min(steps, N) - 1), 8)
                if min(steps, N) > 1 else None
            ),
        }
        self.metrics.counter("serving/requests_total").inc()
        self.metrics.counter("serving/rows_total").inc(B)
        self.metrics.counter("serving/tokens_decoded_total").inc(B * min(steps, N))
        self.metrics.emit("serving", rows=B, **info)
        return comp[:B, :N], cmask[:B, :N], info

    def latency_summary(self) -> Dict[str, Any]:
        """p50/p95/p99 for TTFT and per-token decode time plus request/row
        counters: the serving SLO readout."""
        reg = self.metrics
        return {
            "ttft_s": reg.histogram("serving/ttft_s", buckets=TTFT_BUCKETS).summary(),
            "decode_time_per_token_s": reg.histogram(
                "serving/decode_time_per_token_s", buckets=DECODE_BUCKETS).summary(),
            "queue_depth_rows": reg.histogram(
                "serving/queue_depth_rows", buckets=QUEUE_BUCKETS).summary(),
            "requests_total": reg.counter("serving/requests_total").value,
            "rows_total": reg.counter("serving/rows_total").value,
        }

    def fits(self, n_rows: int, longest_prompt: int) -> bool:
        """Whether a batch can be served inside the bucket grid (callers
        fall back to dense generation otherwise)."""
        return (0 < n_rows <= self.row_buckets[-1]
                and 0 < longest_prompt <= self.prompt_buckets[-1])

    @property
    def compiled_programs(self) -> int:
        """Distinct (prefill + decode) program signatures run: the bounded
        set the bucketing exists to guarantee."""
        return len(self._programs)


# --------------------------------------------------------------------------- #
# Continuous (in-flight) batching on a paged KV pool: Orca's iteration-level
# scheduling + vLLM's PagedAttention (Yu et al. OSDI 2022; Kwon et al. SOSP
# 2023). ONE decode program over a fixed [slots, ...] width; the host
# scheduler admits queued requests into freed slots BETWEEN decode chunks.
# --------------------------------------------------------------------------- #


def chain_hashes(toks_row: np.ndarray, mask_row: np.ndarray,
                 block_size: int) -> List[bytes]:
    """Block-hash chain over a LEFT-PADDED prompt layout (sha1 over the
    previous hash, the block's int32 tokens and its int32 mask, byte for
    byte the JAX function's). The chain covers content AND pad pattern, so a
    hit guarantees every real position's KV is identical."""
    toks_row = np.asarray(toks_row, np.int32)
    mask_row = np.asarray(mask_row, np.int32)
    hashes, h = [], b""
    for i in range(toks_row.size // block_size):
        m = hashlib.sha1()
        m.update(h)
        m.update(toks_row[i * block_size:(i + 1) * block_size].tobytes())
        m.update(mask_row[i * block_size:(i + 1) * block_size].tobytes())
        h = m.digest()
        hashes.append(h)
    return hashes


class AdmissionPolicy:
    """The admission decision as ONE reusable object. Splitting *decide*
    (:meth:`reason`: pure, no counters) from *record* (:meth:`shed`: counts
    ``serving/shed_requests_total`` exactly once) lets a router probe
    replicas without double-counting a request."""

    def __init__(
        self,
        max_queue: int = 256,
        ttft_slo_s: Optional[float] = None,
        min_slo_samples: int = 20,
        free_block_watermark: float = 0.0,
        metrics=None,
    ):
        self.max_queue = int(max_queue)
        self.ttft_slo_s = ttft_slo_s
        self.min_slo_samples = int(min_slo_samples)
        self.free_block_watermark = float(free_block_watermark)
        self._metrics = metrics

    @property
    def metrics(self):
        return self._metrics if self._metrics is not None else observability.get_registry()

    def bind_metrics(self, metrics) -> "AdmissionPolicy":
        """Adopt an owner's registry when constructed without one."""
        if self._metrics is None:
            self._metrics = metrics
        return self

    def reason(
        self,
        *,
        queue_len: int,
        recent_ttft: Sequence[float] = (),
        available_blocks: Optional[int] = None,
        n_blocks: Optional[int] = None,
    ) -> Optional[str]:
        """Why a request arriving NOW would be shed, or None to admit. Pure
        read: no counter moves."""
        if queue_len >= self.max_queue:
            return "queue_full"
        if self.free_block_watermark > 0 and available_blocks is not None:
            watermark = int(self.free_block_watermark * int(n_blocks or 0))
            if available_blocks < watermark:
                return "free_block_watermark"
        if self.ttft_slo_s is not None:
            recent = list(recent_ttft)
            if (len(recent) >= self.min_slo_samples
                    and float(np.percentile(np.asarray(recent), 95)) > self.ttft_slo_s):
                return "ttft_slo"
        return None

    def shed(self, reason: str, *, source: str = "generator", **fields: Any) -> None:
        """Record ONE shed decision (counter + structured event)."""
        self.metrics.counter(
            "serving/shed_requests_total",
            help="requests dropped by admission control").inc()
        self.metrics.emit("serving_shed", reason=reason, source=source, **fields)


class BlockAllocator:
    """Host-side physical-block free list with a refcounted prefix cache.

    Block 0 is the garbage sink and is never handed out. Prompt blocks
    registered in the prefix cache survive their request: at refcount 0 they
    become EVICTABLE (still hit-able) and are reclaimed LRU-first when the
    free list runs dry."""

    def __init__(self, n_blocks: int):
        if n_blocks < 2:
            raise ValueError("need at least 2 blocks (block 0 is reserved)")
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))  # LIFO: low ids first
        self._ref: Dict[int, int] = {}        # cached block -> refcount
        self._by_hash: Dict[bytes, int] = {}  # chain hash -> block id
        self._hash_of: Dict[int, bytes] = {}
        # refcount-0 cached blocks in eviction order (oldest first)
        self._lru: "collections.OrderedDict[int, None]" = collections.OrderedDict()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def evictable_blocks(self) -> int:
        return len(self._lru)

    def available(self) -> int:
        return len(self._free) + len(self._lru)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n private blocks, evicting cold cached blocks if needed; None (and
        no state change) when even eviction cannot cover the request."""
        if self.available() < n:
            return None
        out = []
        for _ in range(n):
            if self._free:
                out.append(self._free.pop())
            else:
                bid, _ = self._lru.popitem(last=False)
                del self._by_hash[self._hash_of.pop(bid)]
                del self._ref[bid]
                out.append(bid)
        return out

    def free(self, ids: Sequence[int]) -> None:
        """Return PRIVATE (decode / copy) blocks to the free list."""
        self._free.extend(ids)

    def register(self, chain_hash: bytes, bid: int) -> bool:
        """Enter a freshly prefilled prompt block into the prefix cache with
        one reference. First writer wins: a hash already served by another
        block refuses the new one, which the caller keeps private."""
        if chain_hash in self._by_hash:
            return False
        self._by_hash[chain_hash] = bid
        self._hash_of[bid] = chain_hash
        self._ref[bid] = self._ref.get(bid, 0) + 1
        self._lru.pop(bid, None)
        return True

    def lookup_chain(self, hashes: Sequence[bytes]) -> Optional[List[int]]:
        """All-or-nothing hit on a full block-hash chain; a hit takes one
        reference on every block."""
        ids = []
        for h in hashes:
            bid = self._by_hash.get(h)
            if bid is None:
                return None
            ids.append(bid)
        for bid in ids:
            self._ref[bid] += 1
            self._lru.pop(bid, None)
        return ids

    def release_shared(self, ids: Sequence[int]) -> None:
        """Drop one reference per block; refcount-0 blocks stay CACHED but
        evictable. Blocks whose hash was forgotten by invalidate_cache() go
        straight back to the free list."""
        for bid in ids:
            self._ref[bid] -= 1
            if self._ref[bid] == 0:
                if bid in self._hash_of:
                    self._lru[bid] = None
                else:
                    del self._ref[bid]
                    self._free.append(bid)

    def invalidate_cache(self) -> None:
        """Flush the prefix cache (weight update: every cached block is
        stale). Evictable blocks return to the free list now; blocks still
        referenced by in-flight slots forget their hashes."""
        for bid in list(self._lru):
            del self._by_hash[self._hash_of.pop(bid)]
            del self._ref[bid]
            self._free.append(bid)
        self._lru.clear()
        for bid, h in list(self._hash_of.items()):
            del self._by_hash[h]
            del self._hash_of[bid]


@dataclasses.dataclass
class _Request:
    ticket: int
    tokens: np.ndarray          # [plen] int32
    key: np.ndarray             # [2] int64 raw counter key (seed, 0)
    max_new: int
    arrival_s: float
    ttft_observed: bool = False
    toks: List[np.ndarray] = dataclasses.field(default_factory=list)
    emits: List[np.ndarray] = dataclasses.field(default_factory=list)
    n_emitted: int = 0
    #: per-request speculation opt-out: the slot rides the verify step with
    #: zero drafts, exactly one plain decode step
    speculate: bool = True
    #: decode-captured per-token logprobs (same per-chunk layout as toks)
    lps: List[np.ndarray] = dataclasses.field(default_factory=list)
    hashes: Optional[List[bytes]] = None  # chain hashes, computed once
    #: externally prefilled prompt KV (disaggregated import): k/v
    #: [L, Pb, KV, hd], tok0, done0, key_next, lp0
    prefilled: Optional[Dict[str, Any]] = None
    #: distributed-tracing parent context (a SpanContext or injected dict)
    trace_ctx: Optional[Any] = None
    #: the per-request root span a bare generator opens when tracing is on
    span: Any = None


class ContinuousGenerator(_PlanPlacement):
    """Continuous-batching serving over one (config, sampling recipe).

    - **Slot pool**: ``slots`` decode lanes; ONE decode chunk over
      ``[slots, ...]`` (plus a greedy variant) whatever the request count,
      arrival order or lengths. Free slots are parked ``done=True`` with an
      all-zero block table (writes land in the garbage block 0).
    - **Paged KV**: ``llm/model.PagedKVCache``; requests own whole
      ``block_size``-token blocks through per-slot block tables, returned to
      the free list at the chunk boundary the request finishes in.
    - **Prefix cache**: prompt blocks keyed by a hash chain over the
      left-padded block contents; a FULL-chain hit skips prefill (one
      private copy of the last prompt block, so decode writes cannot touch
      shared state): GRPO group repeats, best-of-N, retries.
    - **Admission control**: a bounded queue shedding on overflow, on p95
      TTFT above ``ttft_slo_s`` and on the free-block watermark;
      ``submit(..., no_shed=True)`` bypasses it for training rollouts.

    ``device=None`` means the card and raises without one. Greedy decoding
    is token for token ``llm/generate.generate``'s at the same prompt
    bucket."""

    def __init__(
        self,
        config: M.GPTConfig,
        max_new_tokens: int = 64,
        pad_id: int = 0,
        eos_id: Optional[int] = None,
        prompt_buckets: Sequence[int] = (64, 128, 256, 512, 1024, 2048),
        slots: int = 8,
        block_size: int = 32,
        n_blocks: Optional[int] = None,
        decode_chunk: int = 32,
        temperature: float = 1.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        min_new_tokens: Optional[int] = None,
        lora_scale: float = 2.0,
        metrics=None,
        max_queue: int = 256,
        ttft_slo_s: Optional[float] = None,
        min_slo_samples: int = 20,
        free_block_watermark: float = 0.0,
        prefix_cache: bool = True,
        sharding_plan=None,
        mesh=None,
        admission: Optional[AdmissionPolicy] = None,
        tracer=None,
        compile_cache=None,
        speculate=None,
        capture_logprobs: bool = False,
        device: DeviceLike = None,
    ):
        _no_compile_cache(compile_cache)
        self.dev = resolve_device(device)
        self.sharding_plan, self.mesh = _resolve_serving_plan(sharding_plan, mesh, self.dev)
        self.config = config
        self.metrics = metrics if metrics is not None else observability.get_registry()
        self._tracer = tracer
        self.pad_id = int(pad_id)
        self.eos_id = eos_id
        self.prompt_buckets = tuple(sorted(prompt_buckets))
        self.block_size = int(block_size)
        for b in self.prompt_buckets:
            if b % self.block_size:
                raise ValueError(
                    f"block_size {self.block_size} must divide every prompt "
                    f"bucket (got {b}): prompt KV is written whole blocks at "
                    "a time and prefix hashes chain at block granularity")
        self.decode_chunk = min(int(decode_chunk), int(max_new_tokens))
        self.n_chunks = -(-int(max_new_tokens) // self.decode_chunk)
        self.max_new_tokens = int(max_new_tokens)
        self.slots = int(slots)
        # per-slot logical extent mirrors the bucketed/dense cache sizing
        # (bucket + whole chunks): the greedy-parity contract
        self._decode_extent = self.n_chunks * self.decode_chunk
        self.max_blocks = -(-(self.prompt_buckets[-1] + self._decode_extent)
                            // self.block_size)
        if n_blocks is None:
            # full provisioning: every slot can hold a worst-case request
            # (+1 for the garbage block)
            n_blocks = 1 + self.slots * self.max_blocks
        self.n_blocks = int(n_blocks)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.min_new_tokens = min_new_tokens
        self.lora_scale = lora_scale
        self.admission = (
            admission.bind_metrics(self.metrics) if admission is not None
            else AdmissionPolicy(
                max_queue=max_queue, ttft_slo_s=ttft_slo_s,
                min_slo_samples=min_slo_samples,
                free_block_watermark=free_block_watermark,
                metrics=self.metrics))
        self.prefix_cache = bool(prefix_cache)
        # draft-free speculative decoding (llm/speculate.py): None/False off,
        # True/dict/SpecConfig on. Greedy streams are identical either way;
        # sampled streams keep the distribution but consume other draws.
        self.speculate = as_spec_config(speculate)
        #: capture per-token behavior logprobs during decode
        self.capture_logprobs = bool(capture_logprobs)
        self._proposer = NgramProposer(self.speculate) if self.speculate is not None else None
        self._completions = (
            CompletionCache(self.speculate.completion_cache_size)
            if self.speculate is not None and self.speculate.completion_cache
            else None)
        # the distinct program signatures run (compiled_programs)
        self._programs = set()

        # -- host scheduler state --
        # submit()/result() may be called from request threads; step(),
        # run_until_drained() and generate() from ONE scheduler thread.
        self._submit_lock = threading.Lock()
        self._last_shed_span_s = float("-inf")  # shed-span 1/s throttle
        self.allocator = BlockAllocator(self.n_blocks)
        self._queue: "collections.deque[_Request]" = collections.deque()
        # shed decisions read a ROLLING window of recent TTFTs
        self._recent_ttft: "collections.deque[float]" = collections.deque(
            maxlen=max(self.admission.min_slo_samples, 64))
        self._next_ticket = 0
        self._results: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._pool: Optional[M.PagedKVCache] = None
        S = self.max_blocks * self.block_size
        self._tables = np.zeros((self.slots, self.max_blocks), np.int32)
        self._mask = np.zeros((self.slots, S), np.int32)
        self._lengths = np.zeros(self.slots, np.int32)
        self._prev_tok = np.zeros(self.slots, np.int32)
        self._prev_ok = np.zeros(self.slots, bool)
        self._pos = np.zeros(self.slots, np.int32)
        self._step_idx = np.zeros(self.slots, np.int32)
        self._done = np.ones(self.slots, bool)
        self._keys = np.zeros((self.slots, 2), np.int64)
        self._slot_req: List[Optional[_Request]] = [None] * self.slots
        self._slot_shared: List[List[int]] = [[] for _ in range(self.slots)]
        self._slot_private: List[List[int]] = [[] for _ in range(self.slots)]
        # speculation host state: per-slot token history (prompt + emitted)
        # and the finished completion the slot is following
        self._slot_hist: List[List[int]] = [[] for _ in range(self.slots)]
        self._slot_plen: List[int] = [0] * self.slots
        self._slot_follow: List[Optional[np.ndarray]] = [None] * self.slots
        self._result_lps: Dict[int, np.ndarray] = {}
        # the last-served weight trees: cached prompt KV is only valid for
        # the weights that prefilled it
        self._weights: Optional[Tuple[Any, Any]] = None

    # -- device pieces -----------------------------------------------------
    def _knobs(self, greedy: bool, lora) -> Dict[str, Any]:
        return _sampling_knobs(self, greedy, lora)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.dev)

    def _prefill_admit(self, params, lora, prompt, prompt_mask, key, block_ids, greedy):
        """Prefill ONE request at its prompt bucket (the shared prefill_head
        at the dense cache extent) and scatter its prompt KV into the
        assigned blocks. Returns device tensors (tok0, pos0, done0, key_next,
        lp0 or None): nothing here waits for the device."""
        Pb = prompt.shape[1]
        self._programs.add(("prefill", Pb, bool(greedy), lora is None))
        dense = M.init_caches(self.config, 1, Pb + self._decode_extent, device=self.dev)
        carry, _, last_logits = prefill_head(
            self.config, params, prompt, prompt_mask, dense, key[None],
            return_logits=True, **self._knobs(greedy, lora))
        filled, tok0, _rv, pos, done0, key_next = carry
        M.paged_scatter_prompt(self._pool, block_ids, filled.k[:, 0, :Pb], filled.v[:, 0, :Pb])
        lp0 = None
        if self.capture_logprobs:
            # raw log p(tok0): the token_logprobs convention
            lp0 = torch.log_softmax(last_logits, dim=-1)[0, tok0[0].long()]
        return tok0[0], pos[0], done0[0], key_next[0], lp0

    def _decode_chunk(self, params, lora, carry, greedy, live0: int):
        """One fixed-size decode chunk over the WHOLE slot pool. ``live0``:
        the host's max(lengths) at the chunk start (every step adds one)."""
        self._programs.add(("decode", bool(greedy), lora is None))
        knobs = self._knobs(greedy, lora)
        ys = []
        for i in range(self.decode_chunk):
            carry, y = paged_decode_step(self.config, params, carry,
                                         capture_lp=self.capture_logprobs,
                                         live=live0 + i + 1, **knobs)
            ys.append(y)
        return carry, tuple(torch.stack(parts, dim=1) for parts in zip(*ys))

    def _verify(self, params, lora, carry, drafts, draft_len, greedy, live: int):
        """Score K drafted tokens per slot in ONE forward and advance each
        slot by its accepted length (llm/speculate.paged_verify_step)."""
        self._programs.add(("verify", bool(greedy), lora is None))
        return paged_verify_step(self.config, params, carry, drafts, draft_len,
                                 capture_lp=self.capture_logprobs, live=live,
                                 **self._knobs(greedy, lora))

    def _copy_block(self, src: int, dst: int) -> None:
        self._programs.add(("copy_block",))
        M.paged_copy_block(self._pool, src, dst)

    def _scatter_import(self, block_ids: np.ndarray, k: np.ndarray, v: np.ndarray) -> None:
        self._programs.add(("scatter_import", k.shape[1]))
        # a bf16 pool's KV travels as its uint16 bit pattern (numpy has no bf16)
        dtype = "bfloat16" if self.config.dtype == torch.bfloat16 else None
        M.paged_scatter_prompt(self._pool, self._t(block_ids),
                               tensor_from_host(k, dtype, self.dev),
                               tensor_from_host(v, dtype, self.dev))

    def _device_carry(self):
        return (self._pool, self._t(self._tables), self._t(self._mask),
                self._t(self._lengths), self._t(self._prev_tok), self._t(self._prev_ok),
                self._t(self._pos), self._t(self._step_idx), self._t(self._done),
                self._t(self._keys))

    def _host_carry(self, carry) -> None:
        """Host mirrors for the next chunk (copies: admissions mutate them)."""
        (_pool, _tables, slot_mask, lengths, prev_tok, prev_ok, pos, step_idx, done,
         keys) = carry
        self._mask = slot_mask.cpu().numpy().astype(np.int32)
        self._lengths = lengths.cpu().numpy().astype(np.int32)
        self._prev_tok = prev_tok.cpu().numpy().astype(np.int32)
        self._prev_ok = prev_ok.cpu().numpy().astype(bool)
        self._pos = pos.cpu().numpy().astype(np.int32)
        self._step_idx = step_idx.cpu().numpy().astype(np.int32)
        self._done = done.cpu().numpy().astype(bool)
        self._keys = keys.cpu().numpy().astype(np.int64)

    # -- host API ----------------------------------------------------------
    @property
    def tracer(self):
        """The distributed tracer (construction-time override, else the
        process default, read lazily)."""
        return self._tracer if self._tracer is not None else observability.get_tracer()

    def fits(self, n_rows: int, longest_prompt: int) -> bool:
        """Row count is unbounded (the queue absorbs it); only the prompt
        must fit the bucket grid."""
        return n_rows > 0 and 0 < longest_prompt <= self.prompt_buckets[-1]

    def _enqueue(self, tokens: np.ndarray, *, max_new: Optional[int],
                 key, no_shed: bool, hashes: Optional[List[bytes]],
                 arrival_s: Optional[float] = None,
                 prefilled: Optional[Dict[str, Any]] = None,
                 shed_source: str = "generator",
                 trace_ctx: Optional[Any] = None,
                 speculate: bool = True) -> Optional[int]:
        """The shared admission preamble behind :meth:`submit` and
        :meth:`submit_prefilled`: bucket validation, the shed probe/record,
        budget clamping, ticket allocation, key defaulting and the
        queue-depth telemetry."""
        if tokens.size == 0 or tokens.size > self.prompt_buckets[-1]:
            raise ValueError(
                f"prompt of {tokens.size} tokens outside the bucket grid "
                f"(1..{self.prompt_buckets[-1]}); check fits() and fall "
                "back to the dense generate path")
        if not no_shed:
            reason = self._shed_reason()
            if reason is not None:
                tr = self.tracer
                now_s = time.perf_counter()
                if tr.enabled and now_s - self._last_shed_span_s >= 1.0:
                    # a shed is an anomaly: always sampled, throttled to ~1/s
                    self._last_shed_span_s = now_s
                    tr.start_span(
                        "serving.shed", parent=trace_ctx, force=True,
                        attributes={"reason": reason, "source": shed_source}).end()
                self.admission.shed(reason, queue_len=len(self._queue), source=shed_source)
                return None
        if max_new is None:
            budget = self.max_new_tokens
        else:
            budget = min(int(max_new), self.max_new_tokens)
            if budget <= 0:
                raise ValueError(f"max_new must be positive, got {max_new}")
        with self._submit_lock:
            ticket = self._next_ticket
            self._next_ticket += 1
        key = request_key(ticket) if key is None else _raw_key(key)
        span = None
        if trace_ctx is None:
            tr = self.tracer
            if tr.enabled:
                # bare-generator usage: this request IS the trace root; the
                # generator ends it at _finish_slot
                span = tr.start_span(
                    "serving.request",
                    attributes={"ticket": ticket, "prompt_tokens": int(tokens.size)})
                trace_ctx = span.context()
        self._queue.append(_Request(
            ticket=ticket, tokens=tokens, key=key, max_new=budget,
            arrival_s=(float(arrival_s) if arrival_s is not None else time.perf_counter()),
            hashes=list(hashes) if hashes is not None else None,
            prefilled=prefilled, trace_ctx=trace_ctx, span=span,
            speculate=bool(speculate)))
        self.metrics.histogram(
            "serving/queue_depth_rows", buckets=QUEUE_BUCKETS,
            help="rows in flight when a batch is admitted",
        ).observe(len(self._queue) + self._occupancy())
        return ticket

    def submit(self, tokens, *, max_new: Optional[int] = None, key=None,
               no_shed: bool = False, hashes: Optional[List[bytes]] = None,
               trace_ctx: Optional[Any] = None, speculate: bool = True) -> Optional[int]:
        """Enqueue one request; returns a ticket, or None when admission
        control sheds it. ``key``: an int seed or a counter key pair
        (default: the ticket). ``no_shed`` bypasses shedding (training
        rollouts). ``hashes`` lets a caller that already computed the
        prompt's block chain skip the re-hash. ``speculate=False`` opts this
        request out of speculation (zero drafts: exactly the plain decode
        step, same tokens and same draws)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        return self._enqueue(tokens, max_new=max_new, key=key, no_shed=no_shed,
                             hashes=hashes, trace_ctx=trace_ctx, speculate=speculate)

    def submit_prefilled(
        self,
        tokens,
        *,
        k_prompt: np.ndarray,
        v_prompt: np.ndarray,
        tok0: int,
        done0: bool,
        key_next,
        lp0: Optional[float] = None,
        key=None,
        max_new: Optional[int] = None,
        arrival_s: Optional[float] = None,
        no_shed: bool = False,
        hashes: Optional[List[bytes]] = None,
        trace_ctx: Optional[Any] = None,
        speculate: bool = True,
    ) -> Optional[int]:
        """Enqueue a request whose prompt KV a prefill worker already
        computed (the disaggregated topology's decode-side entry).
        ``k_prompt``/``v_prompt`` are host arrays ``[L, Pb, KV, hd]`` at THIS
        generator's prompt bucket, in ``llm/convert.tensor_to_host``'s form
        (a bf16 pool's KV as its ``uint16`` bit pattern).
        ``tok0``/``done0``/``key_next`` are the prefill head's first token,
        its EOS state and the advanced counter key; admission seeds the slot
        with them as the local miss path would. ``key`` is
        the RAW request key, kept so a prefix-cache HIT resumes the same
        stream without the import."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if key is None:
            raise ValueError(
                "submit_prefilled needs the ORIGINAL request key (the one "
                "the prefill worker sampled tok0/key_next from)")
        if 0 < tokens.size <= self.prompt_buckets[-1]:
            Pb = _round_up(tokens.size, self.prompt_buckets)
            if k_prompt.shape[1] != Pb:
                raise ValueError(
                    f"imported prompt KV covers {k_prompt.shape[1]} "
                    f"positions but this generator buckets the prompt to "
                    f"{Pb}; prefill workers must share the decode "
                    "replica's bucket grid")
        return self._enqueue(
            tokens, max_new=max_new, key=key, no_shed=no_shed,
            hashes=hashes, arrival_s=arrival_s,
            shed_source="decode_import", trace_ctx=trace_ctx, speculate=speculate,
            prefilled=dict(
                k=np.asarray(k_prompt), v=np.asarray(v_prompt),
                tok0=int(tok0), done0=bool(done0),
                key_next=np.asarray(key_next, np.int64).reshape(2),
                lp0=(float(lp0) if lp0 is not None else None),
            ))

    def _shed_reason(self) -> Optional[str]:
        with self._submit_lock:
            recent = list(self._recent_ttft)
        return self.admission.reason(
            queue_len=len(self._queue), recent_ttft=recent,
            available_blocks=self.allocator.available(), n_blocks=self.n_blocks)

    def admission_reason(self) -> Optional[str]:
        """Why a request arriving NOW would be shed, or None (pure probe)."""
        return self._shed_reason()

    def _observe_ttft(self, ttft_s: float) -> None:
        with self._submit_lock:
            self._recent_ttft.append(ttft_s)
        self.metrics.histogram(
            "serving/ttft_s", buckets=TTFT_BUCKETS,
            help="submit-to-first-token latency").observe(ttft_s)

    def _occupancy(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def backlog(self) -> int:
        """Queued + in-flight rows: the load signal the fleet router
        dispatches on."""
        return len(self._queue) + self._occupancy()

    def _ensure_pool(self) -> None:
        if self._pool is None:
            self._pool = M.init_paged_cache(self.config, self.n_blocks, self.block_size,
                                            device=self.dev)

    @property
    def pool_bytes(self) -> int:
        """Bytes of the paged KV pool (0 before the first admission)."""
        if self._pool is None:
            return 0
        return 2 * self._pool.k.numel() * self._pool.k.element_size()

    def warm_start(self, params=None, lora=None, greedy: Optional[bool] = None,
                   only_cached: bool = False) -> List[Dict[str, Any]]:
        """The port keeps no persistent executable store (``compile_cache=``
        raises): nothing to warm."""
        return []

    def _chain_hashes(self, toks_row: np.ndarray, mask_row: np.ndarray) -> List[bytes]:
        return chain_hashes(toks_row, mask_row, self.block_size)

    def _admit(self, params, lora, greedy: bool) -> List[int]:
        """Fill free slots from the queue head; returns tickets completed AT
        admission (immediate-EOS / budget-1 requests never enter a chunk).
        Prefills are launched without waiting; their first tokens are read
        once after every admission was dispatched."""
        finished: List[int] = []
        pending: List[Tuple[int, _Request, Any, Any, Any, Any]] = []
        while self._queue:
            try:
                slot = self._slot_req.index(None)
            except ValueError:
                break  # no free slot: decode must free one first
            req = self._queue[0]
            Pb = _round_up(req.tokens.size, self.prompt_buckets)
            nb_p = Pb // self.block_size
            req_chunks = -(-req.max_new // self.decode_chunk)
            n_dec = -(-(req_chunks * self.decode_chunk) // self.block_size)
            toks_row, mask_row = left_pad([req.tokens], self.pad_id, Pb)
            toks_row, mask_row = toks_row[0], mask_row[0]
            if self.prefix_cache and req.hashes is None:
                req.hashes = self._chain_hashes(toks_row, mask_row)
            shared = self.allocator.lookup_chain(req.hashes) if self.prefix_cache else None
            if shared is not None:
                private = self.allocator.alloc(1 + n_dec)
                if private is None:
                    # hit unaffordable: fall back to a MISS (the released
                    # shared blocks become evictable)
                    self.allocator.release_shared(shared)
                    shared = None
            if shared is None:
                private = self.allocator.alloc(nb_p + n_dec)
                if private is None:
                    break
            self._queue.popleft()
            now = time.perf_counter()
            self.metrics.histogram(
                "serving/queue_wait_s", buckets=QUEUE_WAIT_BUCKETS,
                help="submit-to-admission wait").observe(now - req.arrival_s)
            if req.trace_ctx is not None:
                tr = self.tracer
                if tr.enabled:
                    tr.start_span(
                        "serving.admit", parent=req.trace_ctx,
                        attributes={
                            "slot": slot,
                            "path": ("prefix_hit" if shared is not None
                                     else "import" if req.prefilled is not None
                                     else "prefill"),
                            "queue_wait_s": now - req.arrival_s,
                        }).end()
            self._ensure_pool()
            plen = int(mask_row.sum())  # graftcheck: disable=GX001 — host numpy row
            table = np.zeros(self.max_blocks, np.int32)
            if shared is not None:
                # full prefix hit: reuse every prompt block; the LAST one is
                # copied into a private block (the first decode write, the
                # re-entering last prompt token, lands inside it)
                self.metrics.counter("serving/prefix_cache_hits_total").inc()
                copy_dst = private[0]
                self._copy_block(shared[-1], copy_dst)
                table[:nb_p - 1] = shared[:-1]
                table[nb_p - 1] = copy_dst
                table[nb_p:nb_p + n_dec] = private[1:]
                self._slot_shared[slot] = list(shared)
                self._slot_private[slot] = list(private)
                # resume: the last prompt token re-enters the cache on the
                # first decode step, drawing from the RAW request key as
                # prefill_head would have
                self._lengths[slot] = Pb - 1
                self._prev_tok[slot] = toks_row[-1]
                self._pos[slot] = plen - 1
                self._step_idx[slot] = 0
                self._done[slot] = False
                self._keys[slot] = req.key
                self._mask[slot] = 0
                self._mask[slot, :Pb] = mask_row
                self._mask[slot, Pb - 1] = 0  # set by the first decode step
                self._seed_spec_slot(slot, req)
            elif req.prefilled is not None:
                self._admit_import(slot, req, table, private, nb_p, n_dec, Pb, plen, mask_row)
            else:
                self.metrics.counter("serving/prefix_cache_misses_total").inc()
                prompt_blocks, dec_blocks = private[:nb_p], private[nb_p:]
                tok0, _pos0, done0, key_next, lp0 = self._prefill_admit(
                    params, lora, self._t(toks_row[None]), self._t(mask_row[None]),
                    self._t(req.key), self._t(np.asarray(prompt_blocks, np.int32)),
                    greedy)  # graftcheck: disable=GX001 — prompt_blocks: a host list
                pending.append((slot, req, tok0, done0, key_next, lp0))
                self._register_prompt(slot, req, table, prompt_blocks, dec_blocks, nb_p, n_dec)
                req.emits.append(np.asarray([1], np.int32))
                req.n_emitted = 1
                self._lengths[slot] = Pb
                self._pos[slot] = plen
                self._step_idx[slot] = 1
                self._mask[slot] = 0
                self._mask[slot, :Pb] = mask_row
                self._seed_spec_slot(slot, req)
            self._tables[slot] = table
            self._prev_ok[slot] = True
            self._slot_req[slot] = req
            req.prefilled = None  # the imported KV (if any) now lives in the pool
            self.metrics.counter("serving/requests_total").inc()
            self.metrics.counter("serving/rows_total").inc()
        # ONE read pass over every prefill launched above: one device->host
        # copy per field for the whole pass, not one per request and field
        if pending:
            tok0s = torch.stack([p[2] for p in pending]).cpu().numpy()
            done0s = torch.stack([p[3] for p in pending]).cpu().numpy()
            keys = torch.stack([p[4] for p in pending]).cpu().numpy()
            lp0s = (None if pending[0][5] is None
                    else torch.stack([p[5] for p in pending]).cpu().numpy())
        for i, (slot, req, *_) in enumerate(pending):
            tok0 = int(tok0s[i])  # graftcheck: disable=GX001 — host: read above in one copy
            # TTFT from ARRIVAL (includes queue wait), as on the hit path
            req.ttft_observed = True
            self._observe_ttft(time.perf_counter() - req.arrival_s)
            req.toks.append(np.asarray([tok0], np.int32))
            self._prev_tok[slot] = tok0
            self._done[slot] = bool(done0s[i])  # graftcheck: disable=GX001 — host, as above
            self._keys[slot] = keys[i]
            self._record_lp0(req, None if lp0s is None
                             else float(lp0s[i]))  # graftcheck: disable=GX001 — host
            if self._proposer is not None:
                self._slot_hist[slot].append(tok0)
        for slot in range(self.slots):
            req = self._slot_req[slot]
            if req is not None and (self._done[slot] or req.n_emitted >= req.max_new):
                finished.append(self._finish_slot(slot))
        self.metrics.gauge("serving/slot_occupancy").set(self._occupancy())
        self.metrics.gauge("serving/free_blocks").set(self.allocator.available())
        return finished

    def _register_prompt(self, slot, req, table, prompt_blocks, dec_blocks, nb_p, n_dec):
        """Enter freshly written prompt blocks into the prefix cache (first
        writer wins; refused duplicates stay private) and fill the table."""
        shared_blocks, dup_private = [], []
        if self.prefix_cache:
            for h, bid in zip(req.hashes[:nb_p], prompt_blocks):
                (shared_blocks if self.allocator.register(h, bid) else dup_private).append(bid)
        else:
            dup_private = list(prompt_blocks)
        table[:nb_p] = prompt_blocks
        table[nb_p:nb_p + n_dec] = dec_blocks
        self._slot_shared[slot] = shared_blocks
        self._slot_private[slot] = list(dec_blocks) + dup_private

    def _admit_import(self, slot: int, req: _Request, table: np.ndarray,
                      private: List[int], nb_p: int, n_dec: int, Pb: int,
                      plen: int, mask_row: np.ndarray) -> None:
        """Admit ONE externally prefilled request: scatter the imported
        prompt KV into the assigned blocks and seed the slot as the miss
        path does after its local prefill."""
        pf = req.prefilled
        prompt_blocks, dec_blocks = private[:nb_p], private[nb_p:]
        self._scatter_import(np.asarray(prompt_blocks, np.int32), pf["k"], pf["v"])
        self.metrics.counter(
            "serving/prefilled_imports_total",
            help="admissions whose prompt KV was imported from a prefill worker").inc()
        self._register_prompt(slot, req, table, prompt_blocks, dec_blocks, nb_p, n_dec)
        tok0 = int(pf["tok0"])
        req.toks.append(np.asarray([tok0], np.int32))
        req.emits.append(np.asarray([1], np.int32))
        req.n_emitted = 1
        req.ttft_observed = True
        self._observe_ttft(time.perf_counter() - req.arrival_s)
        self._lengths[slot] = Pb
        self._pos[slot] = plen
        self._step_idx[slot] = 1
        self._prev_tok[slot] = tok0
        self._done[slot] = bool(pf["done0"])
        self._keys[slot] = np.asarray(pf["key_next"], np.int64)
        self._mask[slot] = 0
        self._mask[slot, :Pb] = mask_row
        self._seed_spec_slot(slot, req, tok0)
        self._record_lp0(req, pf.get("lp0"))

    # ---- speculative decoding: host-side proposer plumbing --------------- #

    def _seed_spec_slot(self, slot: int, req: _Request, tok0: Optional[int] = None) -> None:
        """Seed the slot's token history (the prompt, plus the first token
        when the admission path already has it) and look up a cached
        completion of this exact prompt."""
        if self._proposer is None:
            return
        hist = req.tokens.tolist()
        if tok0 is not None:
            hist.append(int(tok0))
        self._slot_hist[slot] = hist
        self._slot_plen[slot] = int(req.tokens.size)
        follow = None
        if self._completions is not None and req.speculate and req.hashes:
            follow = self._completions.get(req.hashes[-1])
        self._slot_follow[slot] = follow

    def _record_lp0(self, req: _Request, lp0) -> None:
        """First-token logprob into the request's captured stream."""
        if not self.capture_logprobs:
            return
        if lp0 is None:
            # imported payload without lp0: keep the stream aligned
            req.lps.append(np.zeros(1, np.float32))
            return
        req.lps.append(np.asarray(lp0, np.float32).reshape(1))

    def _propose_slot(self, slot: int) -> List[int]:
        """Draft tokens for ONE slot: the completion-cache follow while the
        cached completion agrees with what the slot emitted, else the n-gram
        suffix match over the slot's history. [] for parked/done/opted-out/
        budget-exhausted slots and proposer misses."""
        req = self._slot_req[slot]
        if req is None or not req.speculate or self._done[slot]:
            return []
        # cap: n_emit <= cap + 1, so a full accept never overshoots max_new
        cap = min(self.speculate.k, req.max_new - req.n_emitted - 1)
        if cap <= 0:
            return []
        hist = self._slot_hist[slot]
        emitted = hist[self._slot_plen[slot]:]
        follow = self._slot_follow[slot]
        if follow is not None:
            n = len(emitted)
            if follow.size > n and (n == 0 or np.array_equal(
                    follow[:n], np.asarray(emitted, follow.dtype))):
                self.metrics.counter(
                    "serving/spec_follow_hits_total",
                    help="draft windows served by the completion cache").inc()
                return follow[n:n + cap].tolist()
            self._slot_follow[slot] = None  # diverged: stop consulting it
        d = self._proposer.propose(np.asarray(hist, np.int32), cap)
        if d.size:
            self.metrics.counter(
                "serving/spec_ngram_hits_total",
                help="draft windows served by the n-gram proposer").inc()
            return d.tolist()
        self.metrics.counter(
            "serving/spec_proposer_misses_total",
            help="live slots with no draft this verify step").inc()
        return []

    def _propose_all(self) -> Tuple[np.ndarray, np.ndarray]:
        """(drafts [slots, K], draft_len [slots]): fixed verify shapes."""
        K = self.speculate.k
        drafts = np.full((self.slots, K), self.pad_id, np.int32)
        dlens = np.zeros(self.slots, np.int32)
        for slot in range(self.slots):
            d = self._propose_slot(slot)
            if d:
                drafts[slot, :len(d)] = d
                dlens[slot] = len(d)
        return drafts, dlens

    def _harvest_hist(self, slot: int, toks_row: np.ndarray, emits_row: np.ndarray) -> None:
        """Append a step's emitted tokens to the slot's proposer history."""
        if self._proposer is None:
            return
        self._slot_hist[slot].extend(toks_row[emits_row.astype(bool)].tolist())

    def _finish_slot(self, slot: int) -> int:
        """Assemble the result, release the slot's blocks to the free list /
        prefix cache, and park the slot."""
        req = self._slot_req[slot]
        toks = np.concatenate(req.toks) if req.toks else np.zeros(0, np.int32)
        emits = np.concatenate(req.emits) if req.emits else np.zeros(0, np.int32)
        N = req.max_new
        toks, emits = toks[:N], emits[:N].astype(np.int32)
        if toks.size < N:  # immediate-EOS rows may undershoot the budget
            toks = np.pad(toks, (0, N - toks.size), constant_values=self.pad_id)
            emits = np.pad(emits, (0, N - emits.size))
        # masked positions are pad (the dense path's post-EOS convention)
        toks = np.where(emits.astype(bool), toks, self.pad_id).astype(np.int32)
        self._results[req.ticket] = (toks, emits)
        if self.capture_logprobs:
            lps = np.concatenate(req.lps) if req.lps else np.zeros(0, np.float32)
            lps = lps[:N].astype(np.float32)
            if lps.size < N:
                lps = np.pad(lps, (0, N - lps.size))
            self._result_lps[req.ticket] = np.where(
                emits.astype(bool), lps, 0.0).astype(np.float32)
        if self._completions is not None and req.speculate and req.hashes:
            # a finished completion becomes the next repeat's draft stream
            self._completions.put(req.hashes[-1], toks[emits.astype(bool)])
        self._slot_hist[slot] = []
        self._slot_plen[slot] = 0
        self._slot_follow[slot] = None
        self.metrics.counter("serving/tokens_decoded_total").inc(int(emits.sum()))
        if req.span is not None:
            req.span.set_attribute("tokens_emitted", int(emits.sum()))
            req.span.end()
            req.span = None
        self.allocator.release_shared(self._slot_shared[slot])
        self.allocator.free(self._slot_private[slot])
        self._slot_shared[slot] = []
        self._slot_private[slot] = []
        self._slot_req[slot] = None
        self._tables[slot] = 0
        self._mask[slot] = 0
        self._lengths[slot] = 0
        self._prev_tok[slot] = self.pad_id
        self._prev_ok[slot] = False
        self._pos[slot] = 0
        self._step_idx[slot] = 0
        self._done[slot] = True
        return req.ticket

    def _check_weight_epoch(self, params, lora) -> None:
        """Cached prompt KV is a function of (weights, chain prefix): a NEW
        params/lora tree (GRPO's functional optimizer returns a new adapter
        tree every learn) invalidates every cached block. Identity is the
        contract: callers that mutate a tree in place must call
        allocator.invalidate_cache() themselves. Queued imports computed
        under the old weights drop their payload (admission recomputes the
        prefill locally)."""
        if self._weights is not None and (self._weights[0] is params
                                          and self._weights[1] is lora):
            return
        if self._weights is not None:
            if self.prefix_cache:
                self.allocator.invalidate_cache()
                self.metrics.counter(
                    "serving/prefix_cache_invalidations_total",
                    help="prefix-cache flushes on weight updates").inc()
            stale = 0
            for req in list(self._queue):
                if req.prefilled is not None:
                    req.prefilled = None
                    stale += 1
            if stale:
                self.metrics.counter(
                    "serving/stale_imports_dropped_total",
                    help="queued prefilled imports dropped on a weight "
                         "update (recomputed by local prefill)").inc(stale)
            if self._completions is not None:
                self._completions.clear()
                self._slot_follow = [None] * self.slots
        self._weights = (params, lora)

    @torch.no_grad()
    def step(self, params, lora=None, greedy: bool = False) -> List[int]:
        """ONE scheduler iteration: admit into free slots, then run one
        decode chunk (or one verify step) over the pool. Returns tickets
        finished this step (fetch results with ``result()``)."""
        self._check_weight_epoch(params, lora)
        finished = self._admit(params, lora, greedy)
        if self._occupancy() == 0:
            if self._queue and not finished:
                raise RuntimeError(
                    f"scheduler wedged: {len(self._queue)} queued requests "
                    f"but none admittable (pool of {self.n_blocks} blocks "
                    "too small for a single request?)")
            return finished
        if self._proposer is not None:
            # any drafted slot => ONE verify step (the others ride it at
            # draft_len 0); no drafts anywhere => the plain decode chunk
            drafts, dlens = self._propose_all()
            if int(dlens.sum()):
                return self._step_verify(params, lora, greedy, drafts, dlens, finished)
        t0 = time.perf_counter()
        carry, ys = self._decode_chunk(params, lora, self._device_carry(), greedy,
                                       int(self._lengths.max()))
        toks, emits = ys[0].cpu().numpy(), ys[1].cpu().numpy()
        lps = ys[2].cpu().numpy() if self.capture_logprobs else None
        dt_chunk = time.perf_counter() - t0
        self._host_carry(carry)
        delivered = 0
        now = time.perf_counter()
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            req.toks.append(toks[slot])
            req.emits.append(emits[slot])
            if lps is not None:
                req.lps.append(lps[slot])
            chunk_emitted = int(emits[slot].sum())  # graftcheck: disable=GX001 — host numpy chunk
            delivered += min(chunk_emitted, req.max_new - req.n_emitted)
            req.n_emitted += chunk_emitted
            if not req.ttft_observed and chunk_emitted:
                # prefix-hit requests produce their first token here
                req.ttft_observed = True
                self._observe_ttft(now - req.arrival_s)
            self._harvest_hist(slot, toks[slot], emits[slot])
        if delivered:
            self.metrics.histogram(
                "serving/decode_time_per_token_s", buckets=DECODE_BUCKETS,
                help="decode-chunk wall time / delivered chunk tokens",
            ).observe(dt_chunk / delivered)
        return self._finish_step(finished)

    def _finish_step(self, finished: List[int]) -> List[int]:
        for slot, req in enumerate(self._slot_req):
            if req is not None and (self._done[slot] or req.n_emitted >= req.max_new):
                finished.append(self._finish_slot(slot))
        self.metrics.gauge("serving/slot_occupancy").set(self._occupancy())
        self.metrics.gauge("serving/free_blocks").set(self.allocator.available())
        return finished

    def _step_verify(self, params, lora, greedy: bool, drafts: np.ndarray,
                     dlens: np.ndarray, finished: List[int]) -> List[int]:
        """ONE verify step over the pool: score every slot's pending token
        plus its drafts in a single forward and advance each slot by its
        accepted length + 1."""
        t0 = time.perf_counter()
        live = int(self._lengths.max()) + self.speculate.k + 1
        carry, ys = self._verify(params, lora, self._device_carry(), self._t(drafts),
                                 self._t(dlens), greedy, live)
        toks, emits = ys[0].cpu().numpy(), ys[1].cpu().numpy()
        n_emit_l, n_acc_l = ys[2].cpu().tolist(), ys[3].cpu().tolist()
        lps = ys[4].cpu().numpy() if self.capture_logprobs else None
        dt_step = time.perf_counter() - t0
        self._host_carry(carry)
        dlens_l = dlens.tolist()
        proposed = int(dlens.sum())
        accepted = 0
        delivered = 0
        now = time.perf_counter()
        acc_hist = self.metrics.histogram(
            "serving/spec_accepted_len", buckets=SPEC_LEN_BUCKETS,
            help="accepted draft tokens per drafted slot per verify step")
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            # harvest ONLY the emitted prefix (a verify row's tail is filler)
            ne = n_emit_l[slot]
            req.toks.append(toks[slot][:ne])
            req.emits.append(emits[slot][:ne].astype(np.int32))
            if lps is not None:
                req.lps.append(lps[slot][:ne])
            # the draft cap bounds n_emit by the remaining budget
            delivered += ne
            req.n_emitted += ne
            accepted += n_acc_l[slot]
            if dlens_l[slot]:
                acc_hist.observe(n_acc_l[slot])
            if not req.ttft_observed and ne:
                req.ttft_observed = True
                self._observe_ttft(now - req.arrival_s)
            self._harvest_hist(slot, toks[slot], emits[slot])
        self.metrics.counter(
            "serving/spec_proposed_tokens_total",
            help="draft tokens submitted to verify").inc(proposed)
        self.metrics.counter(
            "serving/spec_accepted_tokens_total",
            help="draft tokens accepted by verify").inc(accepted)
        self.metrics.counter(
            "serving/spec_rejected_tokens_total",
            help="draft tokens rejected by verify").inc(proposed - accepted)
        if delivered:
            self.metrics.histogram(
                "serving/decode_time_per_token_s", buckets=DECODE_BUCKETS,
                help="decode-chunk wall time / delivered chunk tokens",
            ).observe(dt_step / delivered)
        return self._finish_step(finished)

    def result(self, ticket: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens [max_new], emit mask [max_new]) for a finished ticket (pops it)."""
        return self._results.pop(ticket)

    def result_logprobs(self, ticket: int) -> Optional[np.ndarray]:
        """Decode-captured behavior logprobs [max_new] for a finished ticket
        (pops the record; None unless ``capture_logprobs``). Masked positions
        are 0.0."""
        return self._result_lps.pop(ticket, None)

    def run_until_drained(self, params, lora=None, greedy: bool = False) -> List[int]:
        finished: List[int] = []
        while self._queue or self._occupancy():
            finished.extend(self.step(params, lora=lora, greedy=greedy))
        return finished

    def generate(
        self,
        sequences: List[Any],
        key,
        params,
        lora=None,
        greedy: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, Any]]:
        """Batch convenience with the BucketedGenerator.generate contract:
        (completions [B, max_new_tokens], mask, info). Each row is an
        independent request with key ``fold_in(key, i)`` (``key``: an int
        seed, a counter key pair or a ``torch.Generator``)."""
        B = len(sequences)
        if B == 0:
            raise ValueError(
                "ContinuousGenerator.generate got an empty sequence list; "
                "callers should gate batches with fits(n_rows, longest)")
        # validate EVERY row before enqueueing ANY
        lengths = [len(s) for s in sequences]
        if not self.fits(B, max(lengths)) or min(lengths) == 0:
            raise ValueError(
                f"prompt lengths {min(lengths)}..{max(lengths)} outside the "
                f"bucket grid (1..{self.prompt_buckets[-1]}); check fits() "
                "and fall back to the dense generate path")
        base = _raw_key(key)
        hits0 = self.metrics.counter("serving/prefix_cache_hits_total").value
        tickets = [self.submit(s, key=fold_in(base, i), no_shed=True)
                   for i, s in enumerate(sequences)]
        self.run_until_drained(params, lora=lora, greedy=greedy)
        N = self.max_new_tokens
        comp = np.full((B, N), self.pad_id, np.int32)
        cmask = np.zeros((B, N), np.int32)
        lps = np.zeros((B, N), np.float32) if self.capture_logprobs else None
        for i, t in enumerate(tickets):
            toks, emits = self.result(t)
            comp[i, :toks.size] = toks
            cmask[i, :emits.size] = emits
            if lps is not None:
                row = self.result_logprobs(t)
                if row is not None:
                    lps[i, :row.size] = row
        info = {
            "slots": self.slots,
            "block_size": self.block_size,
            "compiled_programs": self.compiled_programs,
            "prefix_cache_hits": int(self.metrics.counter(
                "serving/prefix_cache_hits_total").value - hits0),
            "free_blocks": self.allocator.available(),
            "max_new_tokens": N,
        }
        self.metrics.emit("serving", rows=B, **info)
        if lps is not None:
            info["logprobs"] = lps  # after emit(): events carry scalars
        return comp, cmask, info

    def latency_summary(self) -> Dict[str, Any]:
        """The serving SLO readout: BucketedGenerator's percentiles plus the
        occupancy / shed / queue-wait / speculation telemetry."""
        reg = self.metrics
        return {
            "ttft_s": reg.histogram("serving/ttft_s", buckets=TTFT_BUCKETS).summary(),
            "decode_time_per_token_s": reg.histogram(
                "serving/decode_time_per_token_s", buckets=DECODE_BUCKETS).summary(),
            "queue_wait_s": reg.histogram(
                "serving/queue_wait_s", buckets=QUEUE_WAIT_BUCKETS).summary(),
            "queue_depth_rows": reg.histogram(
                "serving/queue_depth_rows", buckets=QUEUE_BUCKETS).summary(),
            "requests_total": reg.counter("serving/requests_total").value,
            "rows_total": reg.counter("serving/rows_total").value,
            "tokens_decoded_total": reg.counter("serving/tokens_decoded_total").value,
            "shed_requests_total": reg.counter("serving/shed_requests_total").value,
            "prefix_cache_hits_total": reg.counter("serving/prefix_cache_hits_total").value,
            "slot_occupancy": reg.gauge("serving/slot_occupancy").value,
            "free_blocks": reg.gauge("serving/free_blocks").value,
            "spec_proposed_tokens_total": reg.counter(
                "serving/spec_proposed_tokens_total").value,
            "spec_accepted_tokens_total": reg.counter(
                "serving/spec_accepted_tokens_total").value,
            "spec_rejected_tokens_total": reg.counter(
                "serving/spec_rejected_tokens_total").value,
            "spec_accepted_len": reg.histogram(
                "serving/spec_accepted_len", buckets=SPEC_LEN_BUCKETS).summary(),
        }

    @property
    def compiled_programs(self) -> int:
        """Prefill (per prompt bucket) + decode chunk (one) + verify (one,
        when speculating) + block copy + import scatter (per prompt bucket)
        signatures run, each per greedy variant: bounded by the grid,
        constant in request count and order."""
        return len(self._programs)
