"""Generation loop: the port of ``agilerl_tpu/llm/generate.py``.

Left-padded ragged prompts, per-row RoPE positions, EOS handled by done
masking. The JAX loop is a jitted ``lax.scan``; here it is an eager Python
loop of ``max_new_tokens - 1`` decode steps after the prefill, and the JAX
PRNG key becomes a ``torch.Generator`` carried through the steps (the two give
different draws from one seed: compare sampling by distribution only).

The continuous-batching step (``paged_decode_step``, over the paged pool of
``llm/model.py``) gives every slot its own random stream, as the JAX package
splits a key per slot. A batched ``torch.Generator`` has no per-row streams,
so a slot's key here is a counter pair ``(seed, counter)`` (int64 ``[..., 2]``,
both below 2**32): a draw hashes (seed, counter, sub-stream, vocab index)
into 32 bits on the device and samples by Gumbel-max; "splitting" a key
advances its counter. Another request's admission order or slot cannot
change a slot's draws, on the CPU and on the card alike.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from agilerl_tpu_torch.llm import model as M


def left_pad(sequences, pad_id: int,
             max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: list of 1D token arrays -> (tokens [B, P], mask [B, P])."""
    max_len = max_len or max(len(s) for s in sequences)
    B = len(sequences)
    toks = np.full((B, max_len), pad_id, np.int32)
    mask = np.zeros((B, max_len), np.int32)
    for i, s in enumerate(sequences):
        s = np.asarray(s, np.int32)[-max_len:]
        toks[i, max_len - len(s):] = s
        mask[i, max_len - len(s):] = 1
    return toks, mask


def _filter_logits(logits, temperature, top_k, top_p):
    """Temperature, then top-k, then nucleus filtering (temperature first:
    a hotter distribution admits more tokens into the nucleus)."""
    logits = logits / temperature
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, -1e9, logits)
    if top_p is not None:
        # smallest set whose mass reaches top_p: cumulative mass EXCLUSIVE of
        # the current token, so the token that crosses the threshold stays
        sort_idx = torch.argsort(-logits, dim=-1, stable=True)
        sorted_logits = logits.gather(-1, sort_idx)
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = probs.cumsum(dim=-1) - probs
        drop = torch.zeros_like(cum, dtype=torch.bool).scatter(-1, sort_idx, cum >= top_p)
        logits = torch.where(drop, -1e9, logits)
    return logits


def _sample_token(logits, generator, temperature, top_k, top_p=None):
    if temperature == 0.0:
        return logits.argmax(dim=-1)  # greedy: filters cannot change it
    probs = torch.softmax(_filter_logits(logits, temperature, top_k, top_p).float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# --------------------------------------------------------------------------- #
# Per-row counter streams (the per-slot keys of continuous batching)
# --------------------------------------------------------------------------- #

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """x * c mod 2**32 for x in [0, 2**32) (int or int64 tensor) and a 32-bit
    constant, with every product below 2**49 (no signed overflow)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """A bijective 32-bit mix (Wellons' lowbias32) of x in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def request_key(seed: int) -> np.ndarray:
    """A request's raw key: ``(seed mod 2**32, counter 0)`` as int64 [2]."""
    return np.asarray([int(seed) & _M32, 0], np.int64)


def fold_in(key, i: int) -> np.ndarray:
    """A new raw key from ``key`` and an index (``jax.random.fold_in``'s
    role: the i-th row of a batch gets its own stream)."""
    seed, ctr = (int(v) for v in np.asarray(key).reshape(2))
    mixed = _hash32(_hash32(seed ^ _hash32(ctr)) ^ _hash32((int(i) + 0x9E3779B9) & _M32))
    return request_key(mixed)


def _split_keys(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(carried keys, keys to draw with now): the counter advances by one."""
    return torch.stack([keys[..., 0], keys[..., 1] + 1], dim=-1), keys


def _stream_words(keys: torch.Tensor, sub, n: int) -> torch.Tensor:
    """keys [..., 2] int64, sub (int or int64 [...]) a sub-stream id ->
    [..., n] 32-bit words hashed from (seed, counter, sub, j). Sub-stream 0
    is the plain per-step draw."""
    s = _hash32(_hash32(keys[..., 0]) ^ keys[..., 1])
    s = _hash32(s ^ _hash32(torch.as_tensor(sub, dtype=torch.int64, device=keys.device)))
    s = s[..., None]
    j = torch.arange(n, dtype=torch.int64, device=keys.device)
    w = _hash32(s ^ _mul32(j, 0x9E3779B9))
    return _hash32((w + s) & _M32)


def _uniform(words: torch.Tensor) -> torch.Tensor:
    """32-bit words -> f32 uniforms in (0, 1) from their top 24 bits."""
    return ((words >> 8).float() + 0.5) * (1.0 / (1 << 24))


def _gumbel(keys: torch.Tensor, sub, n: int) -> torch.Tensor:
    return -torch.log(-torch.log(_uniform(_stream_words(keys, sub, n))))


def _sample_token_per_row(logits, keys, temperature, top_k, top_p=None):
    """Per-row-key sampling for continuous batching: row b draws from its
    own stream ``keys[b]`` (Gumbel-max over the filtered logits)."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    filtered = _filter_logits(logits, temperature, top_k, top_p).float()
    return (filtered + _gumbel(keys, 0, filtered.shape[-1])).argmax(dim=-1)


def _suppress_eos(logits, step, eos_id, min_new_tokens):
    """EOS logit floor for the first ``min_new_tokens`` sampled tokens.
    step: an int (batch-aligned decode) or a tensor of per-row indices."""
    if eos_id is None or not min_new_tokens:
        return logits
    lt = torch.as_tensor(step, device=logits.device) < min_new_tokens
    if lt.dim():
        lt = lt[..., None]
    is_eos = torch.arange(logits.shape[-1], device=logits.device) == eos_id
    return torch.where(lt & is_eos, -1e9, logits)


def prefill_head(config, params, prompt, prompt_mask, caches, generator, *,
                 lora, lora_scale, temperature, top_k, top_p, eos_id,
                 pad_id, min_new_tokens, row_valid=None, return_logits=False):
    """Prompt forward + first sampled token. Returns the decode carry and the
    first (token, emit_mask) pair. ``generator`` is a ``torch.Generator``
    (the batch stream of ``generate`` and ``BucketedGenerator``) or an int64
    ``[B, 2]`` tensor of per-row counter keys (``ContinuousGenerator``: the
    carry then holds the advanced keys). ``row_valid`` marks real rows
    (bucket padding rows are born done); None means every row is real.
    ``return_logits=True`` appends the raw last-position logits [B, V]."""
    B = prompt.shape[0]
    positions = (prompt_mask.cumsum(dim=-1) - 1).clamp_min(0)
    hidden, caches = M.forward(
        config, params, prompt, attention_mask=prompt_mask,
        positions=positions, cache=caches, lora=lora, lora_scale=lora_scale,
    )
    last_logits = M.serving_logits(config, params, hidden[:, -1:, :])[:, 0, :]
    pos = prompt_mask.sum(dim=-1)
    logits0 = _suppress_eos(last_logits, 0, eos_id, min_new_tokens)
    if isinstance(generator, torch.Tensor):
        generator, k0 = _split_keys(generator)
        tok0 = _sample_token_per_row(logits0, k0, temperature, top_k, top_p)
    else:
        tok0 = _sample_token(logits0, generator, temperature, top_k, top_p)
    if row_valid is None:
        row_valid = torch.ones((B,), dtype=torch.bool, device=prompt.device)
    tok0 = torch.where(row_valid, tok0, pad_id)
    done0 = ~row_valid
    if eos_id is not None:
        done0 = done0 | (tok0 == eos_id)
    carry = (caches, tok0, row_valid, pos, done0, generator)
    if return_logits:
        return carry, (tok0, row_valid), last_logits
    return carry, (tok0, row_valid)


def decode_step(config, params, carry, i, *, lora, lora_scale, temperature,
                top_k, top_p, eos_id, pad_id, min_new_tokens):
    """One decode step: advance with the previous token, sample the next.
    ``i`` is the absolute sampled-token index (drives min_new_tokens)."""
    caches, prev_tok, prev_valid, pos, done, generator = carry
    hidden, caches = M.forward(
        config, params, prev_tok[:, None],
        attention_mask=prev_valid.to(torch.int32)[:, None],
        positions=pos[:, None], cache=caches, lora=lora, lora_scale=lora_scale,
    )
    logits = M.serving_logits(config, params, hidden[:, -1:, :])[:, 0, :]
    pos = pos + prev_valid.to(pos.dtype)
    tok = _sample_token(_suppress_eos(logits, i, eos_id, min_new_tokens),
                        generator, temperature, top_k, top_p)
    if eos_id is not None:
        tok = torch.where(done, pad_id, tok)
    emit = ~done
    if eos_id is not None:
        done = done | (tok == eos_id)
    return (caches, tok, emit, pos, done, generator), (tok, emit)


@torch.no_grad()
def generate(
    config: M.GPTConfig,
    params,
    prompt: torch.Tensor,       # [B, P] left-padded
    prompt_mask: torch.Tensor,  # [B, P]
    generator: Optional[torch.Generator] = None,
    max_new_tokens: int = 64,
    lora=None,
    lora_scale: float = 2.0,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_id: Optional[int] = None,
    pad_id: int = 0,
    min_new_tokens: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (completions [B, max_new_tokens], completion_mask [B, N] int32).
    The mask covers tokens up to and including the first EOS. ``generator``
    lives on the prompt's device; it may be None only for greedy decoding
    (temperature 0)."""
    B, P = prompt.shape
    caches = M.init_caches(config, B, P + max_new_tokens, device=prompt.device)
    knobs = dict(lora=lora, lora_scale=lora_scale, temperature=temperature,
                 top_k=top_k, top_p=top_p, eos_id=eos_id, pad_id=pad_id,
                 min_new_tokens=min_new_tokens)
    # the first token comes from the prefill logits; each step then advances
    # the model with the PREVIOUS token: max_new_tokens - 1 decode forwards
    carry, (tok0, mask0) = prefill_head(config, params, prompt, prompt_mask,
                                        caches, generator, **knobs)
    tokens, masks = [tok0], [mask0]
    for i in range(1, max_new_tokens):
        carry, (tok, emit) = decode_step(config, params, carry, i, **knobs)
        tokens.append(tok)
        masks.append(emit)
    return torch.stack(tokens, dim=1), torch.stack(masks, dim=1).to(torch.int32)


# --------------------------------------------------------------------------- #
# Continuous (in-flight) batching decode step over the paged slot pool: the
# paged twin of decode_step, with per-slot cache depths, RoPE positions, step
# indices and random streams. The host scheduler
# (llm/serving.ContinuousGenerator) admits and releases slots between chunks.
# --------------------------------------------------------------------------- #


def paged_decode_step(config, params, carry, *, lora, lora_scale, temperature,
                      top_k, top_p, eos_id, pad_id, min_new_tokens,
                      capture_lp=False, live=None):
    """One decode step for every slot in the pool.

    carry:
      cache        PagedKVCache, the shared block pool (written in place)
      block_tables [slots, max_blocks] int32 (free slots: all zero, so their
                   writes land in the garbage block 0)
      slot_mask    [slots, S] int32 logical-slot validity
      lengths      [slots] int32 cache fill (incl. left pad; the write slot)
      prev_tok     [slots] previous sampled token (enters the cache now)
      prev_ok      [slots] bool: prev_tok is a real emission
      pos          [slots] int32 RoPE position (count of real tokens)
      step_idx     [slots] int32 absolute sampled-token index
      done         [slots] bool (free slots are parked done=True)
      keys         [slots, 2] int64 per-slot counter keys

    Returns (carry', (tok, emit)), and with capture_lp=True (carry', (tok,
    emit, lp)): lp is log p(tok) under the RAW logits (temperature 1, no EOS
    floor), the ``model.token_logprobs`` convention. ``live``: a host upper
    bound of max(lengths) + 1 (spares a read of the maximum)."""
    (cache, block_tables, slot_mask, lengths, prev_tok, prev_ok, pos,
     step_idx, done, keys) = carry
    S = slot_mask.shape[1]
    # the previous token's slot becomes visible as in the dense path;
    # released slots' lengths may run past S: clamp (their mask rows are all
    # zero and prev_ok is 0, so the write is a masked no-op)
    slot_mask = slot_mask.scatter(1, lengths.clamp_max(S - 1).long()[:, None],
                                  prev_ok.to(slot_mask.dtype)[:, None])
    hidden, (new_k, new_v) = M.forward_paged(
        config, params, prev_tok[:, None], pos, lengths, cache, block_tables,
        slot_mask, lora=lora, lora_scale=lora_scale, live=live,
    )
    cache = M.paged_scatter_tokens(cache, block_tables, lengths, new_k, new_v)
    logits = M.serving_logits(config, params, hidden)[:, 0, :]
    pos = pos + prev_ok.to(pos.dtype)
    keys, k_s = _split_keys(keys)
    tok = _sample_token_per_row(_suppress_eos(logits, step_idx, eos_id, min_new_tokens),
                                k_s, temperature, top_k, top_p).to(prev_tok.dtype)
    tok = torch.where(done, pad_id, tok)
    emit = ~done
    if eos_id is not None:
        done = done | (tok == eos_id)
    carry = (cache, block_tables, slot_mask, lengths + 1, tok, emit, pos,
             step_idx + 1, done, keys)
    if capture_lp:
        lp = torch.log_softmax(logits, dim=-1).gather(1, tok.long()[:, None])[:, 0]
        return carry, (tok, emit, lp)
    return carry, (tok, emit)
