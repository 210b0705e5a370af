"""Generation loop: the port of ``agilerl_tpu/llm/generate.py`` (dense cache).

Left-padded ragged prompts, per-row RoPE positions, EOS handled by done
masking. The JAX loop is a jitted ``lax.scan``; here it is an eager Python
loop of ``max_new_tokens - 1`` decode steps after the prefill, and the JAX
PRNG key becomes a ``torch.Generator`` carried through the steps (the two give
different draws from one seed: compare sampling by distribution only).
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
                 pad_id, min_new_tokens):
    """Prompt forward + first sampled token. Returns the decode carry and the
    first (token, emit_mask) pair. (The JAX version's ``row_valid`` and
    ``return_logits`` serve its serving tier, a later slice.)"""
    B = prompt.shape[0]
    positions = (prompt_mask.cumsum(dim=-1) - 1).clamp_min(0)
    hidden, caches = M.forward(
        config, params, prompt, attention_mask=prompt_mask,
        positions=positions, cache=caches, lora=lora, lora_scale=lora_scale,
    )
    last_logits = M.logits_fn(config, params, hidden[:, -1:, :])[:, 0, :]
    pos = prompt_mask.sum(dim=-1)
    tok0 = _sample_token(_suppress_eos(last_logits, 0, eos_id, min_new_tokens),
                         generator, temperature, top_k, top_p)
    row_valid = torch.ones((B,), dtype=torch.bool, device=prompt.device)
    done0 = ~row_valid
    if eos_id is not None:
        done0 = done0 | (tok0 == eos_id)
    return (caches, tok0, row_valid, pos, done0, generator), (tok0, row_valid)


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
    logits = M.logits_fn(config, params, hidden[:, -1:, :])[:, 0, :]
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
