"""Draft-free speculative decoding for the continuous generator: the port of
``agilerl_tpu/llm/speculate.py`` (Leviathan et al., "Fast Inference from
Transformers via Speculative Decoding", 2023).

- **Host proposer** (:class:`NgramProposer` + :class:`CompletionCache`):
  prompt-lookup speculation, no second model. A slot's draft is read off its
  own token history (suffix n-gram match) or off a FINISHED completion of
  the same prompt, keyed by the prefix cache's tail chain hash (the GRPO
  group-repeat case). Pure numpy between decode steps.
- **Device verify** (:func:`paged_verify_step`): ONE forward scores the K
  drafted tokens of every slot and advances each slot by its accepted
  length, with the per-slot raggedness of ``generate.paged_decode_step``.

Correctness contract:

- **Greedy**: a draft is accepted iff it equals the argmax the sequential
  path would take; the first mismatch emits the argmax instead. Token for
  token identical to plain decoding.
- **Sampled**: per-draft rejection sampling against the sequential
  sampler's ``_filter_logits`` recipe: draft ``d_j`` is accepted with
  probability ``p_j(d_j)`` (the proposal is a point mass); on rejection the
  token is drawn from ``p_j`` with ``d_j`` masked out. The emitted marginal
  at every position is ``p_j``. Draws come from the slot's counter key
  (``llm/generate.py``): sub-streams 1..T give the accept uniforms and
  T+1..2T the residual draws; a slot with no draft draws its one token from
  sub-stream 0, exactly the plain decode step's draw.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

import numpy as np
import torch

from agilerl_tpu_torch.llm import model as M
from agilerl_tpu_torch.llm.generate import (
    _filter_logits,
    _gumbel,
    _split_keys,
    _stream_words,
    _suppress_eos,
    _uniform,
)


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs for ``ContinuousGenerator(speculate=...)``.

    k                      max drafted tokens per slot per verify step (the
                           verify window is k+1 wide: k drafts + the
                           correction/bonus position).
    ngram_max / ngram_min  suffix n-gram lengths tried (longest first) by
                           the prompt-lookup proposer over the slot's own
                           prompt+completion history.
    completion_cache       reuse FINISHED completions of the same prompt
                           (tail-chain-hash keyed) as drafts — the GRPO
                           group-repeat fast path. Invalidated with the
                           prefix cache on every weight-epoch swap.
    completion_cache_size  LRU bound on cached completions.
    """

    k: int = 6
    ngram_max: int = 4
    ngram_min: int = 2
    completion_cache: bool = True
    completion_cache_size: int = 512

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"SpecConfig.k must be >= 1, got {self.k}")
        if not (1 <= self.ngram_min <= self.ngram_max):
            raise ValueError(
                f"need 1 <= ngram_min <= ngram_max, got "
                f"({self.ngram_min}, {self.ngram_max})")


def as_spec_config(spec) -> Optional[SpecConfig]:
    """Normalise the user-facing ``speculate=`` value: None/False -> off,
    True -> defaults, dict -> kwargs, SpecConfig -> itself."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return SpecConfig()
    if isinstance(spec, SpecConfig):
        return spec
    if isinstance(spec, dict):
        return SpecConfig(**spec)
    raise TypeError(f"speculate= expects None/bool/dict/SpecConfig, "
                    f"got {type(spec).__name__}")


class CompletionCache:
    """LRU of finished completions keyed by the prompt's tail chain hash
    (the same sha1 chain the prefix cache routes on, so "same prompt" means
    the same thing in both caches). The proposer FOLLOWS a cached
    completion while the slot's emitted tokens match it — under greedy
    repeats the whole continuation drafts perfectly."""

    def __init__(self, size: int):
        self.size = int(size)
        self._d: "collections.OrderedDict[bytes, np.ndarray]" = (
            collections.OrderedDict())

    def put(self, key: Optional[bytes], tokens: np.ndarray) -> None:
        if key is None or self.size <= 0:
            return
        toks = np.asarray(tokens, np.int32).reshape(-1)
        if toks.size == 0:
            return
        self._d[key] = toks
        self._d.move_to_end(key)
        while len(self._d) > self.size:
            self._d.popitem(last=False)

    def get(self, key: Optional[bytes]) -> Optional[np.ndarray]:
        if key is None:
            return None
        toks = self._d.get(key)
        if toks is not None:
            self._d.move_to_end(key)
        return toks

    def clear(self) -> None:
        self._d.clear()

    def __len__(self) -> int:
        return len(self._d)


class NgramProposer:
    """Prompt-lookup drafting: match the history's trailing n-gram against
    its own earlier content and propose the continuation of the most recent
    earlier occurrence. O(len(history) * ngram span) numpy per slot per
    step — cheap next to a decode forward, and a miss costs nothing (the
    scheduler falls back to the plain decode chunk)."""

    def __init__(self, cfg: SpecConfig):
        self.cfg = cfg

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history, np.int32).reshape(-1)
        L = h.size
        top = min(self.cfg.ngram_max, L - 1)
        for n in range(top, self.cfg.ngram_min - 1, -1):
            if L - n < 1:
                continue
            suffix = h[L - n:]
            # windows over h[:-1]: candidate occurrences strictly before
            # the suffix itself
            windows = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
            hits = np.nonzero((windows == suffix[None, :]).all(axis=1))[0]
            if hits.size:
                start = int(hits[-1]) + n  # most recent occurrence
                cont = h[start:start + k]
                if cont.size:
                    return cont.astype(np.int32)
        return np.zeros(0, np.int32)


# --------------------------------------------------------------------------- #
# Device verify step: the multi-token twin of generate.paged_decode_step.
# --------------------------------------------------------------------------- #


def paged_verify_step(config, params, carry, drafts, draft_len, *, lora,
                      lora_scale, temperature, top_k, top_p, eos_id, pad_id,
                      min_new_tokens, capture_lp=False, live=None):
    """Score K drafted tokens per slot in ONE forward and advance every slot
    by its accepted length.

    carry: the 10-tuple ``generate.paged_decode_step`` carries. drafts:
    [slots, K] int32 (positions past draft_len are ignored); draft_len:
    [slots] int32 in [0, K], 0 for slots that must behave exactly like one
    plain decode step (proposer miss, opt-out, parked slots).

    Window (T = K + 1 input positions per slot, entering length L): input 0
    is prev_tok (KV written at L, as in decode), input j is drafts[j-1] (KV
    at L + j); output j is the token the sequential path would emit given
    the prefix plus drafts[< j]. Drafts accept as a prefix chain, the first
    rejection emits the model's own token instead, and full acceptance emits
    a bonus token from position K. n_emit in [1, draft_len + 1] tokens emit
    per live slot (0 for done slots); lengths/pos/step_idx advance by n_emit
    and the carried slot_mask marks exactly the emitted prefix.

    Returns (carry', (tok [slots, T], emit [slots, T], n_emit [slots],
    n_acc [slots])), plus lp [slots, T] (raw log p of each emitted token)
    when capture_lp=True. ``live``: a host upper bound of max(lengths) + T."""
    (cache, block_tables, slot_mask, lengths, prev_tok, prev_ok, pos,
     step_idx, done, keys) = carry
    B, K = drafts.shape
    T = K + 1
    S = slot_mask.shape[1]
    V = config.vocab_size
    dev = drafts.device
    j = torch.arange(T, device=dev)
    draft_len = draft_len.clamp_max(K)
    dle = torch.where(done, 0, draft_len)  # done slots verify nothing

    # -- forward over the window ------------------------------------------ #
    cand_in = torch.cat([prev_tok[:, None], drafts.to(prev_tok.dtype)], dim=1)  # [B, T]
    positions = pos[:, None] + torch.where(
        j[None, :] == 0, 0, prev_ok.to(pos.dtype)[:, None] + j[None, :] - 1)
    write_pos = lengths[:, None] + j[None, :]
    rel = torch.arange(S, device=dev)[None, :] - lengths[:, None]
    # forward visibility: prev_tok at rel 0 (decode's pre-step insert),
    # drafts at rel 1..dle; candidate j only SEES slots <= lengths + j
    one = torch.ones((), dtype=slot_mask.dtype, device=dev)
    vm = torch.where(rel == 0, prev_ok.to(slot_mask.dtype)[:, None], slot_mask)
    vm = torch.where((rel >= 1) & (rel <= dle[:, None]), one, vm)
    hidden, (new_k, new_v) = M.forward_paged(
        config, params, cand_in, positions, write_pos, cache, block_tables,
        vm, lora=lora, lora_scale=lora_scale, live=live,
    )
    cache = M.paged_scatter_multi(cache, block_tables, write_pos, new_k, new_v)
    logits = M.serving_logits(config, params, hidden)  # [B, T, V] f32
    steps = step_idx[:, None] + j[None, :]
    logits_s = _suppress_eos(logits, steps, eos_id, min_new_tokens)

    # -- accept / emit ----------------------------------------------------- #
    in_window = j[None, :K] < dle[:, None]  # [B, K]
    keys_next, k_s = _split_keys(keys)
    drafts_l = drafts.long()
    if temperature == 0.0:
        # greedy: accepted iff the draft IS the argmax
        cand = logits_s.argmax(dim=-1)  # [B, T]
        accept = (cand[:, :K] == drafts_l) & in_window
        emitted = cand
    else:
        flat = _filter_logits(logits_s.reshape(B * T, V), temperature, top_k,
                              top_p).reshape(B, T, V).float()
        probs = torch.softmax(flat, dim=-1)
        # sub-streams 1..K: the accept uniforms; T+1..2T: the residual and
        # bonus draws
        u = _uniform(_stream_words(k_s[:, None, :].expand(B, K, 2),
                                   1 + j[None, :K].expand(B, K), 1))[..., 0]
        p_draft = probs[:, :K].gather(-1, drafts_l[..., None])[..., 0]
        accept = (u < p_draft) & in_window
        # residual at j < K: p_j with the rejected draft masked out (only
        # inside the window); past the window, and at the bonus position,
        # the full p_j (masking the pad filler would bias the marginal)
        resid = torch.where(
            (torch.arange(V, device=dev)[None, None, :] == drafts_l[..., None])
            & in_window[..., None], -1e9, flat[:, :K])
        resample_logits = torch.cat([resid, flat[:, K:]], dim=1)
        # a draft-len-0 slot's only emission is position 0: it draws from
        # sub-stream 0, the plain decode step's draw, so proposer misses and
        # opt-outs riding a mixed verify step keep the plain stream
        sub = (1 + T + j)[None, :].expand(B, T)
        sub = torch.where((dle == 0)[:, None] & (j[None, :] == 0), 0, sub)
        g = _gumbel(k_s[:, None, :].expand(B, T, 2), sub, V)
        emitted = (resample_logits + g).argmax(dim=-1)
        # accepted positions emit the draft itself
        emitted = torch.where(
            torch.cat([accept, torch.zeros((B, 1), dtype=torch.bool, device=dev)], dim=1),
            torch.cat([drafts_l, drafts_l[:, :1]], dim=1), emitted)
    emitted = emitted.to(prev_tok.dtype)
    chain = torch.cumprod(accept.to(torch.int32), dim=1)
    n_acc = chain.sum(dim=1)  # [B] accepted chain length in [0, K]

    # window = accepted chain + the correction/bonus at position n_acc, then
    # cut at the first EOS and by done
    in_emit = j[None, :] <= n_acc[:, None]
    is_eos = ((emitted == eos_id) if eos_id is not None
              else torch.zeros((B, T), dtype=torch.bool, device=dev))
    e = (is_eos & in_emit).to(torch.int32)
    no_prior_eos = (torch.cumsum(e, dim=1) - e) == 0
    emit = in_emit & no_prior_eos & ~done[:, None]
    n_emit = emit.sum(dim=1).to(lengths.dtype)  # [B]; >= 1 live, 0 done
    tok = torch.where(emit, emitted, pad_id)

    # -- advance the ragged per-slot state -------------------------------- #
    last = emitted.gather(1, (n_emit - 1).clamp_min(0).long()[:, None])[:, 0]
    prev_tok_n = torch.where(n_emit > 0, last, pad_id)
    prev_ok_n = n_emit > 0
    done_n = done | (emit & is_eos).any(dim=1)
    # carried mask: prev_tok's slot becomes prev_ok and emitted tokens except
    # the LAST become valid (the last is the new pending prev_tok, made
    # visible by the NEXT step's rel == 0 write)
    new_mask = torch.where(rel == 0, prev_ok.to(slot_mask.dtype)[:, None], slot_mask)
    new_mask = torch.where((rel >= 1) & (rel <= (n_emit - 1)[:, None]), one, new_mask)
    lengths_n = lengths + n_emit
    pos_n = pos + prev_ok.to(pos.dtype) + (n_emit - 1).clamp_min(0).to(pos.dtype)
    step_idx_n = step_idx + n_emit.to(step_idx.dtype)
    carry_n = (cache, block_tables, new_mask, lengths_n, prev_tok_n,
               prev_ok_n, pos_n, step_idx_n, done_n, keys_next)
    if capture_lp:
        lp = torch.log_softmax(logits, dim=-1).gather(-1, tok.long()[..., None])[..., 0]
        return carry_n, (tok, emit, n_emit, n_acc, lp)
    return carry_n, (tok, emit, n_emit, n_acc)
