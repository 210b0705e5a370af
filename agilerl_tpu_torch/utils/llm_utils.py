"""Dataset-as-gym for LLM RL finetuning: the port of
``agilerl_tpu/utils/llm_utils.py`` (``CharTokenizer``, ``HuggingFaceGym``,
``ReasoningGym`` for GRPO and ``PreferenceGym`` for DPO).

Tokenizer protocol: ``encode(str) -> List[int]``, ``decode(List[int]) -> str``,
``pad_token_id``, ``eos_token_id``. Prompt batches, rewards and learn batches
are numpy arrays, as in the JAX package. With a ``torch.distributed`` process
group up, each process seeds its shuffle with its rank and sees a strided
slice of the training rows (the JAX package uses ``jax.process_index()``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from agilerl_tpu_torch.llm.generate import left_pad


def _process_index_count() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CharTokenizer:
    """Tiny char-level tokenizer for tests/demos. id 0 = pad, 1 = eos."""

    def __init__(self, alphabet: str = "0123456789+-*=() abcdefghijklmnopqrstuvwxyz"):
        self.pad_token_id = 0
        self.eos_token_id = 1
        self._c2i = {c: i + 2 for i, c in enumerate(alphabet)}
        self._i2c = {i + 2: c for i, c in enumerate(alphabet)}
        self.vocab_size = len(alphabet) + 2

    def encode(self, text: str) -> List[int]:
        return [self._c2i[c] for c in text if c in self._c2i]

    def decode(self, ids) -> str:
        return "".join(self._i2c.get(int(i), "") for i in ids)


class HuggingFaceGym:
    """Dataset -> gym base."""

    def __init__(
        self,
        train_dataset,
        test_dataset,
        tokenizer,
        data_batch_size: int = 8,
        max_context_length: Optional[int] = None,
        question_key: str = "question",
        answer_key: str = "answer",
        seed: int = 0,
    ):
        self.tokenizer = tokenizer
        self.data_batch_size = int(data_batch_size)
        self.max_context_length = max_context_length
        self.question_key = question_key
        self.answer_key = answer_key
        rank, world = _process_index_count()
        self._rng = np.random.default_rng(seed + rank)
        self.train_rows = self._filter(list(train_dataset))
        self.test_rows = self._filter(list(test_dataset))
        if world > 1:  # each process sees a strided slice
            self.train_rows = self.train_rows[rank::world]
        self._epoch = 0
        self._cursor = 0
        self.num_epochs = 0

    def _filter(self, rows: List[Dict]) -> List[Dict]:
        """Context-length filtering."""
        if self.max_context_length is None:
            return rows
        return [r for r in rows
                if len(self.tokenizer.encode(str(r[self.question_key]))) <= self.max_context_length]

    def eval_row_batches(self):
        """Yield the full test split in data_batch_size windows."""
        for start in range(0, len(self.test_rows), self.data_batch_size):
            yield self.test_rows[start:start + self.data_batch_size]

    def _next_batch(self, eval_mode: bool = False) -> List[Dict]:
        rows = self.test_rows if eval_mode else self.train_rows
        if eval_mode:
            return rows[:self.data_batch_size]
        if self._cursor + self.data_batch_size > len(rows):
            self._cursor = 0
            self._epoch += 1
            self.num_epochs = self._epoch
            order = self._rng.permutation(len(rows))
            self.train_rows = [rows[i] for i in order]
            rows = self.train_rows
        batch = rows[self._cursor:self._cursor + self.data_batch_size]
        self._cursor += self.data_batch_size
        return batch

    def _tokenize_prompts(self, rows: List[Dict]) -> Dict[str, np.ndarray]:
        seqs = [self.tokenizer.encode(str(r[self.question_key])) for r in rows]
        max_len = self.max_context_length
        if max_len is None:
            # prompt length bucketed to a multiple of 32, as the JAX package
            # does (there, to bound its compile cache)
            longest = max(len(s) for s in seqs)
            max_len = ((longest + 31) // 32) * 32
        ids, mask = left_pad(seqs, pad_id=self.tokenizer.pad_token_id, max_len=max_len)
        return {"input_ids": ids, "attention_mask": mask}

    def __len__(self):
        return len(self.train_rows)

    def state_dict(self) -> Dict:
        """Epoch/cursor counters, the shuffle RNG and the current row order."""
        return {
            "rng": self._rng.bit_generator.state,
            "epoch": self._epoch,
            "cursor": self._cursor,
            "num_epochs": self.num_epochs,
            "train_rows": list(self.train_rows),
        }

    def load_state_dict(self, state: Dict) -> None:
        bg = getattr(np.random, state["rng"]["bit_generator"])()
        bg.state = state["rng"]
        self._rng = np.random.Generator(bg)
        self._epoch = int(state["epoch"])
        self._cursor = int(state["cursor"])
        self.num_epochs = int(state["num_epochs"])
        self.train_rows = list(state["train_rows"])


class ReasoningGym(HuggingFaceGym):
    """reset() -> tokenized prompt batch; step(completions) -> rewards."""

    def __init__(self, *args, reward_fn: Callable[[str, Any, str], float], **kwargs):
        super().__init__(*args, **kwargs)
        self.reward_fn = reward_fn
        self._current: Optional[List[Dict]] = None
        self._current_prompts = None

    def reset(self, eval_mode: bool = False) -> Dict[str, np.ndarray]:
        self._current = self._next_batch(eval_mode)
        self._current_prompts = self._tokenize_prompts(self._current)
        return self._current_prompts

    def _rewards(self, completion_ids, completion_mask, group_size: int) -> np.ndarray:
        rewards = []
        for i, row in enumerate(self._current):
            group = []
            for g in range(group_size):
                r = i * group_size + g
                ids = np.asarray(completion_ids[r])
                m = np.asarray(completion_mask[r]).astype(bool)
                text = self.tokenizer.decode(ids[m])
                group.append(float(self.reward_fn(text, row[self.answer_key],
                                                  str(row[self.question_key]))))
            rewards.append(group)
        return np.asarray(rewards, np.float32)

    def step(self, completion_ids, completion_mask) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """completion_ids: [B*G, N]. Returns (next prompt batch, rewards [B, G])."""
        group_size = completion_ids.shape[0] // len(self._current)
        rewards = self._rewards(completion_ids, completion_mask, group_size)
        return self.reset(), rewards

    def step_eval(self, completion_ids, completion_mask):
        rewards = self._rewards(completion_ids, completion_mask, 1)
        return None, rewards.reshape(-1)

    def state_dict(self) -> Dict:
        state = super().state_dict()
        state["current_rows"] = self._current  # what step() will score against
        return state

    def load_state_dict(self, state: Dict) -> None:
        super().load_state_dict(state)
        rows = state.get("current_rows")
        self._current = rows
        self._current_prompts = None if rows is None else self._tokenize_prompts(rows)

    def eval_batches(self):
        """Iterate tokenized prompt batches over the whole test split; each
        becomes current for step_eval. The training state is restored
        afterwards, so the next training step scores against its own rows."""
        saved = (self._current, self._current_prompts)
        try:
            for rows in self.eval_row_batches():
                self._current = rows
                self._current_prompts = self._tokenize_prompts(rows)
                yield self._current_prompts
        finally:
            self._current, self._current_prompts = saved

    def assemble_learn_batch(self, completion_ids, completion_mask):
        """Concatenate the last prompt batch with completions into full
        sequences + action masks for GRPO.learn.

        Returns (ids [B*G, P+N], action_masks [B*G, P+N-1])."""
        prompts = self._current_prompts
        B, P = prompts["input_ids"].shape
        G = completion_ids.shape[0] // B
        prompt_ids = np.repeat(prompts["input_ids"], G, axis=0)
        ids = np.concatenate([prompt_ids, np.asarray(completion_ids)], axis=1)
        N = completion_ids.shape[1]
        action_mask = np.zeros((B * G, P + N - 1), np.float32)
        action_mask[:, P - 1:] = np.asarray(completion_mask, np.float32)
        return ids, action_mask


class PreferenceGym(HuggingFaceGym):
    """Preference-pair batches for DPO. Dataset rows need prompt, chosen and
    rejected keys; ``reset`` returns the chosen and rejected sequences
    (prompt + completion + eos, left-padded) with their attention masks and
    the completion-prediction loss masks ``[B, P-1]``."""

    def __init__(
        self,
        *args,
        prompt_key: str = "prompt",
        chosen_key: str = "chosen",
        rejected_key: str = "rejected",
        max_completion_length: Optional[int] = None,
        **kwargs,
    ):
        kwargs.setdefault("question_key", prompt_key)
        super().__init__(*args, **kwargs)
        self.prompt_key = prompt_key
        self.chosen_key = chosen_key
        self.rejected_key = rejected_key
        self.max_completion_length = max_completion_length

    def reset(self, eval_mode: bool = False) -> Dict[str, np.ndarray]:
        return self._build_batch(self._next_batch(eval_mode))

    def eval_batches(self):
        """Iterate preference batches over the whole test split."""
        for rows in self.eval_row_batches():
            yield self._build_batch(rows)

    def _build_batch(self, rows: List[Dict]) -> Dict[str, np.ndarray]:
        tok = self.tokenizer

        def build(key):
            seqs, prompt_lens = [], []
            for r in rows:
                p = tok.encode(str(r[self.prompt_key]))
                c = tok.encode(str(r[key])) + [tok.eos_token_id]
                if self.max_completion_length:
                    c = c[:self.max_completion_length]
                seqs.append(p + c)
                prompt_lens.append(len(p))
            ids, attn = left_pad(seqs, pad_id=tok.pad_token_id)
            # 1 where the prediction target is a completion token
            P = ids.shape[1]
            loss_mask = np.zeros((len(rows), P - 1), np.float32)
            for i, (seq, plen) in enumerate(zip(seqs, prompt_lens)):
                start = P - len(seq) + plen  # left-pad offset + prompt length
                loss_mask[i, max(start - 1, 0):] = 1.0
            return ids, attn, loss_mask

        c_ids, c_attn, c_lm = build(self.chosen_key)
        r_ids, r_attn, r_lm = build(self.rejected_key)
        return {
            "chosen_ids": c_ids, "chosen_mask": c_attn, "chosen_loss_mask": c_lm,
            "rejected_ids": r_ids, "rejected_mask": r_attn, "rejected_loss_mask": r_lm,
        }
