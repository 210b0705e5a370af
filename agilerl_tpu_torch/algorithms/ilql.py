"""ILQL, implicit-language Q-learning, and BC_LM, the behavioural-cloning
language model (the legacy offline stack): the port of
``agilerl_tpu/algorithms/ilql.py``.

Per-token offline RL on language. The LM head is the policy pi; the V head and
the (twin) Q heads ride the same hidden states. Q is trained by TD toward
r + gamma * V(s'), V by expectile regression toward the (min) target Q, pi by
advantage-weighted behavioural cloning (AWAC); a CQL term and an optional
direct-method margin keep Q conservative. The target Q heads follow the live
ones by polyak averaging.

The whole model trains, so its weights stay f32 and are cast to
``config.dtype`` at use, as the JAX package keeps them. The trunk runs
``llm/model.forward`` with the config's attention (dense unless
``use_flash_attention``) and the materialised lm head; BC_LM's loss goes
through ``token_logprobs`` without the fused head. So no path here launches
the fused dW kernel. The JAX package's jitted ``lax.scan`` generation loops
are Python loops over tensors; greedy and beam search give the same tokens,
and sampling draws from the same scores with a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from agilerl_tpu_torch.algorithms.core.base import EvolvableAlgorithm
from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper, grad_step
from agilerl_tpu_torch.algorithms.core.registry import (
    HyperparameterConfig,
    NetworkGroup,
    OptimizerConfig,
    RLParameter,
)
from agilerl_tpu_torch.llm import model as M
from agilerl_tpu_torch.llm.generate import generate as _generate
from agilerl_tpu_torch.llm.moe import topk_stable
from agilerl_tpu_torch.modules import layers as L
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.utils.tree import tree_copy, tree_map


class _Net:
    def __init__(self, config, params):
        self.config = config
        self.params = params


def _offline_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr=RLParameter(min=1e-6, max=1e-3, dtype=float),
        batch_size=RLParameter(min=4, max=128, dtype=int),
    )


def _f32_params(gen: torch.Generator, config: M.GPTConfig, device) -> M.Params:
    """Model weights kept in f32 (the trainable copy), cast at use."""
    return M.init_params(gen, dataclasses.replace(config, dtype=torch.float32), device=device)


def _offline_batch(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """An ``RL_Dataset`` batch as tensors: tokens long, the attention mask
    int32, rewards and terminals f32."""
    dtypes = {"tokens": torch.long, "attention_mask": torch.int32}
    return {k: torch.as_tensor(np.asarray(v), device=device, dtype=dtypes.get(k, torch.float32))
            for k, v in batch.items()}


def _gather(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return q.gather(-1, a[..., None].long())[..., 0]


def _categorical(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of softmax(logits) (Gumbel-max, as
    ``jax.random.categorical``)."""
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    tiny = torch.finfo(u.dtype).tiny
    return torch.argmax(logits - torch.log(-torch.log(u.clamp_min(tiny))), dim=-1)


class ILQL(EvolvableAlgorithm):
    supports_activation_mutation = False

    def __init__(
        self,
        config: M.GPTConfig,
        index: int = 0,
        batch_size: int = 16,
        lr: float = 1e-4,
        gamma: float = 0.99,
        tau: float = 0.7,  # expectile
        alpha: float = 0.005,  # polyak for target Q
        beta: float = 1.0,  # AWAC temperature
        cql_weight: float = 0.01,
        cql_temp: float = 1.0,
        double_q: bool = True,
        dm_weight: float = 0.0,
        dm_margin: float = 0.0,
        transition_weight: float = 0.0,  # accepted, unused (as in the JAX package)
        seed: Optional[int] = None,
        device: DeviceLike = None,
        **kwargs,
    ):
        super().__init__(index=index, hp_config=_offline_hp_config(), seed=seed, device=device,
                         **kwargs)
        self.dev = resolve_device(device)
        self.model_config = config
        self.batch_size = int(batch_size)
        self.lr = float(lr)
        self.gamma = float(gamma)
        self.tau = float(tau)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.cql_weight = float(cql_weight)
        self.cql_temp = float(cql_temp)
        self.double_q = bool(double_q)
        self.dm_weight = float(dm_weight)
        self.dm_margin = float(dm_margin)
        self.learn_step = 1

        d, v = config.d_model, config.vocab_size
        gen = self.next_key(self.dev)
        params = {
            "gpt": _f32_params(gen, config, self.dev),
            "v_head": L.dense_init(gen, d, 1),
            "q_head": L.dense_init(gen, d, v),
        }
        if self.double_q:
            # twin Q heads: the min over the targets damps overestimation
            params["q2_head"] = L.dense_init(gen, d, v)
        self.actor = _Net(config, params)
        self.target_q = _Net(config, self._live_q())
        self.optimizer = OptimizerWrapper(optimizer="adamw", lr=self.lr)
        self.register_network_group(NetworkGroup(eval="actor", policy=True))
        self.register_optimizer(OptimizerConfig(name="optimizer", networks=["actor"], lr="lr"))
        self.finalize_registry()

    @property
    def init_dict(self) -> Dict[str, Any]:
        return {
            "config": self.model_config,
            "index": self.index,
            "batch_size": self.batch_size,
            "lr": self.lr,
            "gamma": self.gamma,
            "tau": self.tau,
            "alpha": self.alpha,
            "beta": self.beta,
            "cql_weight": self.cql_weight,
            "cql_temp": self.cql_temp,
            "double_q": self.double_q,
            "dm_weight": self.dm_weight,
            "dm_margin": self.dm_margin,
            "device": self.device,
        }

    def _on_clone(self, parent) -> None:
        self.target_q.params = tree_copy(parent.target_q.params)

    def _live_q(self) -> Dict[str, Any]:
        """A copy of the live Q head(s), as the target tree holds them."""
        names = ("q_head", "q2_head") if self.double_q else ("q_head",)
        return {n: tree_copy(self.actor.params[n]) for n in names}

    # ------------------------------------------------------------------ #
    def _loss_fn(self):
        """The train step: (params, tq_params, opt_state, batch) -> (params,
        tq_params, opt_state, total loss, (q_loss, v_loss, cql, pi_loss))."""
        config = self.model_config
        gamma, tau, beta, cql_w = self.gamma, self.tau, self.beta, self.cql_weight
        cql_temp, double_q, alpha = self.cql_temp, self.double_q, self.alpha
        dm_w, dm_margin = self.dm_weight, self.dm_margin
        tx = self.optimizer.tx

        def train_step(params, tq_params, opt_state, batch):
            tokens = batch["tokens"]
            mask = batch["attention_mask"].float()
            a = tokens[:, 1:]  # the action at step t is token t + 1
            valid = mask[:, 1:] * mask[:, :-1]
            denom = valid.sum().clamp_min(1.0)

            def loss(p):
                hidden, _ = M.forward(config, p["gpt"], tokens,
                                      attention_mask=batch["attention_mask"])
                logits = M.logits_fn(config, p["gpt"], hidden)
                vs = L.dense_apply(p["v_head"], hidden)[..., 0]  # [B, T]
                qs = L.dense_apply(p["q_head"], hidden)  # [B, T, V]
                q_a = _gather(qs[:, :-1], a)
                # target-Q head(s) on the same trunk, without its gradient
                sg_hidden = hidden.detach()
                tq_a = _gather(L.dense_apply(tq_params["q_head"], sg_hidden)[:, :-1], a)
                if double_q:
                    qs2 = L.dense_apply(p["q2_head"], hidden)
                    q2_a = _gather(qs2[:, :-1], a)
                    tq2_a = _gather(L.dense_apply(tq_params["q2_head"], sg_hidden)[:, :-1], a)
                    tq_a = torch.minimum(tq_a, tq2_a)
                # transition t's reward and terminal sit at index t + 1
                r = batch["rewards"][:, 1:]
                nonterm = 1.0 - batch["terminals"][:, 1:]
                td_target = (r + gamma * nonterm * vs[:, 1:]).detach()
                q_loss = ((q_a - td_target).square() * valid).sum() / denom
                if double_q:  # both heads regress to the shared target
                    q_loss = q_loss + ((q2_a - td_target).square() * valid).sum() / denom
                # expectile V toward the (min) target Q
                diff = tq_a.detach() - vs[:, :-1]
                w = torch.where(diff > 0, tau, 1.0 - tau)
                v_loss = (w * diff.square() * valid).sum() / denom

                def cql_term(q_all, q_sel):
                    lse = torch.logsumexp(q_all[:, :-1] / cql_temp, dim=-1)
                    return ((lse - q_sel / cql_temp) * valid).sum() / denom

                cql = cql_term(qs, q_a)
                if double_q:
                    cql = cql + cql_term(qs2, q2_a)

                # direct-method margin: non-data actions at least dm_margin
                # below the data action's Q, gradients through both sides
                def dm_term(q_all, q_sel):
                    viol = torch.clamp_min(q_all[:, :-1] - q_sel[..., None] + dm_margin, 0.0)
                    return (viol.square().sum(dim=-1) * valid).sum() / denom

                dm = dm_term(qs, q_a)
                if double_q:
                    dm = dm + dm_term(qs2, q2_a)
                # AWAC: advantage-weighted cross-entropy
                adv = (tq_a - vs[:, :-1]).detach()
                wts = torch.exp(torch.clamp(beta * adv, -5.0, 5.0))
                logp_a = _gather(torch.log_softmax(logits[:, :-1], dim=-1), a)
                pi_loss = -(wts * logp_a * valid).sum() / denom
                total = q_loss + v_loss + cql_w * cql + dm_w * dm + pi_loss
                return total, tuple(x.detach() for x in (q_loss, v_loss, cql, pi_loss))

            params, opt_state, total, aux = grad_step(loss, params, tx, opt_state)
            with torch.no_grad():  # polyak target-Q head(s)
                live = {n: params[n] for n in tq_params}
                tq_params = tree_map(lambda t, p: (1 - alpha) * t + alpha * p, tq_params, live)
            return params, tq_params, opt_state, total, aux

        return train_step

    def hard_update(self) -> None:
        """Copy the live Q head(s) into the target."""
        self.target_q.params = self._live_q()

    def learn(self, batch: Dict[str, np.ndarray]) -> float:
        """batch: ``data/rl_data.RL_Dataset.sample_batch``. Returns the loss."""
        step = self.jit_fn("train", self._loss_fn)
        params, tq, opt_state, loss, _ = step(self.actor.params, self.target_q.params,
                                              self.optimizer.opt_state,
                                              _offline_batch(batch, self.dev))
        self.actor.params = params
        self.target_q.params = tq
        self.optimizer.opt_state = opt_state
        return float(loss)

    # ------------------------------------------------------------------ #
    def _score_fn(self):
        """Per-position policy scores: log pi + q_scale * (Q - V), Q the min
        over the twin heads."""
        config, double_q = self.model_config, self.double_q

        @torch.no_grad()
        def scores(params, tokens, mask, q_scale):
            hidden, _ = M.forward(config, params["gpt"], tokens, attention_mask=mask)
            logits = M.logits_fn(config, params["gpt"], hidden)
            qs = L.dense_apply(params["q_head"], hidden)
            if double_q:
                qs = torch.minimum(qs, L.dense_apply(params["q2_head"], hidden))
            vs = L.dense_apply(params["v_head"], hidden)
            return torch.log_softmax(logits, dim=-1) + q_scale * (qs - vs)

        return scores

    def _as(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.dev, dtype=dtype)

    def get_action(self, tokens: np.ndarray, mask: np.ndarray,
                   key: Optional[torch.Generator] = None, q_scale: float = 1.0) -> np.ndarray:
        """Sample the next token of each row from pi perturbed by the
        Q-advantage at the last position."""
        scores = self.jit_fn("scores", self._score_fn)
        sc = scores(self.actor.params, self._as(tokens, torch.long), self._as(mask, torch.int32),
                    float(q_scale))[:, -1]
        key = key if key is not None else self.next_key(self.dev)
        return _categorical(key, sc).cpu().numpy()

    def _sample_loop(self, tokens, mask, gen, q_scale, temperature, max_new_tokens, pad_id,
                     eos_id):
        scores = self.jit_fn("scores", self._score_fn)
        params = self.actor.params
        B, Lbuf = tokens.shape
        rows = torch.arange(B, device=tokens.device)
        lens = mask.sum(dim=-1).long()
        alive = torch.ones(B, dtype=torch.bool, device=tokens.device)
        out = []
        for _ in range(max_new_tokens):
            last = scores(params, tokens, mask, q_scale)[rows, lens - 1]  # [B, V]
            if temperature > 0:
                tok = _categorical(gen, last / max(temperature, 1e-6))
            else:
                tok = torch.argmax(last, dim=-1)
            tok = torch.where(alive, tok, pad_id)
            write = lens.clamp_max(Lbuf - 1)
            tokens[rows, write] = torch.where(alive, tok, tokens[rows, write])
            mask[rows, write] = torch.where(alive, 1, mask[rows, write])
            lens = lens + alive.long()
            alive = alive & (tok != eos_id) & (lens < Lbuf)
            out.append(tok)
        return tokens, mask, torch.stack(out, dim=1)

    def _beam_loop(self, tokens, mask, q_scale, max_new_tokens, beam_width, pad_id, eos_id):
        scores_fn = self.jit_fn("scores", self._score_fn)
        params = self.actor.params
        B, Lbuf = tokens.shape
        W, V, dev = beam_width, self.model_config.vocab_size, tokens.device
        beams = tokens[:, None].repeat(1, W, 1)  # [B, W, L]
        bmask = mask[:, None].repeat(1, W, 1)
        lens = mask.sum(dim=-1).long()[:, None].repeat(1, W)
        # only beam 0 is live at the first expansion, so the top W are not W
        # copies of one token
        first = torch.where(torch.arange(W, device=dev) == 0, 0.0, -1e9)
        scores = first[None].repeat(B, 1)
        alive = torch.ones((B, W), dtype=torch.bool, device=dev)
        # a finished beam may only "emit" pad, at no cost
        stay = torch.where(torch.arange(V, device=dev) == pad_id, 0.0, -1e9)
        rows, cols = torch.arange(B, device=dev)[:, None], torch.arange(W, device=dev)[None]
        for _ in range(max_new_tokens):
            sc = scores_fn(params, beams.reshape(B * W, Lbuf), bmask.reshape(B * W, Lbuf),
                           q_scale)
            last = sc[torch.arange(B * W, device=dev), lens.reshape(-1) - 1].reshape(B, W, V)
            step = torch.where(alive[..., None], last, stay[None, None])
            top_sc, top_ix = topk_stable((scores[..., None] + step).reshape(B, W * V), W)
            src = top_ix // V
            tok = top_ix % V
            beams = beams.gather(1, src[..., None].expand(B, W, Lbuf))
            bmask = bmask.gather(1, src[..., None].expand(B, W, Lbuf))
            lens, alive = lens.gather(1, src), alive.gather(1, src)
            write = lens.clamp_max(Lbuf - 1)
            put = alive & (tok != pad_id)
            beams[rows, cols, write] = torch.where(put, tok, beams[rows, cols, write])
            bmask[rows, cols, write] = torch.where(put, 1, bmask[rows, cols, write])
            lens = lens + put.long()
            alive = alive & (tok != eos_id) & (tok != pad_id) & (lens < Lbuf)
            scores = top_sc
        best = torch.argmax(scores, dim=-1)
        pick = torch.arange(B, device=dev)
        return beams[pick, best], bmask[pick, best], scores[pick, best]

    def generate(
        self,
        prompt_tokens: np.ndarray,
        prompt_mask: np.ndarray,
        max_new_tokens: int = 16,
        mode: str = "sample",
        q_scale: float = 1.0,
        temperature: float = 1.0,
        beam_width: int = 4,
        eos_id: Optional[int] = None,
        pad_id: int = 0,
        key: Optional[torch.Generator] = None,
    ):
        """Full-sequence acting policy over the Q/V-reweighted LM, re-running
        the whole forward at each step. mode: "sample" (at ``temperature``),
        "greedy", or "beam" (width ``beam_width``, cumulative score search).
        Prompts must be right-padded. Returns (tokens [B, P+N], mask) as
        numpy."""
        if mode not in ("sample", "greedy", "beam"):
            raise ValueError(f"unknown generation mode {mode!r}")
        eos = self.model_config.vocab_size - 1 if eos_id is None else int(eos_id)
        prompt = np.asarray(prompt_tokens)
        B, P = prompt.shape
        Lbuf = P + int(max_new_tokens)
        tokens = np.full((B, Lbuf), pad_id, np.int32)
        tokens[:, :P] = prompt
        mask = np.zeros((B, Lbuf), np.int32)
        mask[:, :P] = np.asarray(prompt_mask)
        tokens, mask = self._as(tokens, torch.long), self._as(mask, torch.int32)
        if mode == "beam":
            toks, msk, _ = self._beam_loop(tokens, mask, float(q_scale), int(max_new_tokens),
                                           int(beam_width), pad_id, eos)
        else:
            temp = 0.0 if mode == "greedy" else float(temperature)
            gen = None
            if temp > 0:
                gen = key if key is not None else self.next_key(self.dev)
            toks, msk, _ = self._sample_loop(tokens, mask, gen, float(q_scale), temp,
                                             int(max_new_tokens), pad_id, eos)
        return toks.cpu().numpy().astype(np.int32), msk.cpu().numpy()


class ILQL_Policy:
    """Thin acting-policy wrapper: ``act`` runs ``ILQL.generate`` in one mode."""

    def __init__(self, iql_model: ILQL, kind: str = "sample", **generation_kwargs):
        if kind not in ("beam", "sample", "greedy"):
            raise ValueError(f"unknown policy kind {kind!r}")
        self.iql_model = iql_model
        self.kind = kind
        self.generation_kwargs = dict(generation_kwargs)

    def act(self, prompt_tokens, prompt_mask):
        return self.iql_model.generate(prompt_tokens, prompt_mask, mode=self.kind,
                                       **self.generation_kwargs)


class ILQL_Evaluator:
    """Rollout evaluator over a prompt-in/reward-out interface: ``env`` has
    ``eval_prompts() -> (tokens, mask)`` batches and ``reward(tokens, mask) ->
    [B] array``."""

    def __init__(self, env, kind: str = "sample", verbose: bool = False, **generation_kwargs):
        self.env = env
        self.kind = kind
        self.verbose = verbose
        self.generation_kwargs = dict(generation_kwargs)
        self.all_results: list = []

    def evaluate(self, model: ILQL) -> Dict[str, float]:
        policy = ILQL_Policy(model, self.kind, **self.generation_kwargs)
        total, n = 0.0, 0
        for tokens, mask in self.env.eval_prompts():
            out_tokens, out_mask = policy.act(tokens, mask)
            rewards = np.asarray(self.env.reward(out_tokens, out_mask), np.float64)
            self.all_results.append((np.asarray(out_tokens), rewards))
            total += float(rewards.sum())
            n += int(rewards.size)
            if self.verbose:
                print(f"ILQL_Evaluator: batch reward {rewards.mean():.3f}")
        return {"env_reward": total / max(n, 1), "episodes": float(n)}

    def dump(self) -> Dict[str, Any]:
        return {"results": self.all_results}


class TopAdvantageNGrams:
    """Dataset introspection: the n-grams with the highest mean learned
    advantage (target Q - V, summed over the n-gram's actions)."""

    def __init__(self, tokenizer=None, n_gram: int = 3, print_k: int = 10):
        self.tokenizer = tokenizer
        self.n_gram = int(n_gram)
        self.print_k = int(print_k)
        self._adv: Dict[tuple, float] = {}
        self._count: Dict[tuple, int] = {}

    def evaluate(self, model: ILQL, batch: Dict[str, np.ndarray]) -> None:
        config = model.model_config

        @torch.no_grad()
        def adv_fn(params, tq_params, tokens, mask):
            hidden, _ = M.forward(config, params["gpt"], tokens, attention_mask=mask)
            a = tokens[:, 1:]
            tq_a = _gather(L.dense_apply(tq_params["q_head"], hidden)[:, :-1], a)
            if "q2_head" in tq_params:
                tq_a = torch.minimum(
                    tq_a, _gather(L.dense_apply(tq_params["q2_head"], hidden)[:, :-1], a))
            vs = L.dense_apply(params["v_head"], hidden)[..., 0]
            return tq_a - vs[:, :-1]

        fn = model.jit_fn("ngram_adv", lambda: adv_fn)
        tokens = np.asarray(batch["tokens"])
        mask = np.asarray(batch["attention_mask"])
        adv = fn(model.actor.params, model.target_q.params, model._as(tokens, torch.long),
                 model._as(mask, torch.int32)).cpu().numpy()
        valid = (mask[:, 1:] * mask[:, :-1]).astype(bool)
        n = self.n_gram
        for b in range(tokens.shape[0]):
            acts = tokens[b, 1:]
            for start in range(acts.shape[0] - n + 1):
                window = slice(start, start + n)
                if not valid[b, window].all():
                    continue
                gram = tuple(int(t) for t in acts[window])
                self._adv[gram] = self._adv.get(gram, 0.0) + float(adv[b, window].sum())
                self._count[gram] = self._count.get(gram, 0) + 1

    def top(self) -> list:
        items = sorted(((self._adv[g] / self._count[g], g) for g in self._adv), reverse=True)
        out = []
        for mean_adv, gram in items[:self.print_k]:
            text = self.tokenizer.decode(list(gram)) if self.tokenizer is not None else gram
            out.append((text, mean_adv))
        return out

    def dump(self) -> Dict[str, Any]:
        return {"top_advantage_ngrams": self.top()}


class BC_LM(EvolvableAlgorithm):
    """Behavioural-cloning language model: cross-entropy on offline text over
    the whole model, and a sampling policy."""

    supports_activation_mutation = False

    def __init__(self, config: M.GPTConfig, index: int = 0, batch_size: int = 16,
                 lr: float = 1e-4, seed: Optional[int] = None, device: DeviceLike = None,
                 **kwargs):
        super().__init__(index=index, hp_config=_offline_hp_config(), seed=seed, device=device,
                         **kwargs)
        self.dev = resolve_device(device)
        self.model_config = config
        self.batch_size = int(batch_size)
        self.lr = float(lr)
        self.learn_step = 1
        self.actor = _Net(config, {"gpt": _f32_params(self.next_key(self.dev), config,
                                                      self.dev)})
        self.optimizer = OptimizerWrapper(optimizer="adamw", lr=self.lr)
        self.register_network_group(NetworkGroup(eval="actor", policy=True))
        self.register_optimizer(OptimizerConfig(name="optimizer", networks=["actor"], lr="lr"))
        self.finalize_registry()

    @property
    def init_dict(self) -> Dict[str, Any]:
        return {"config": self.model_config, "index": self.index,
                "batch_size": self.batch_size, "lr": self.lr, "device": self.device}

    def _train_fn(self):
        """(params, opt_state, batch) -> (params, opt_state, loss): the
        mean next-token NLL over valid transitions, through the plain
        (materialised) lm head."""
        config = self.model_config
        tx = self.optimizer.tx

        def step(params, opt_state, batch):
            tokens = batch["tokens"]
            mask = batch["attention_mask"].float()
            valid = mask[:, 1:] * mask[:, :-1]

            def loss(p):
                lp = M.token_logprobs(config, p["gpt"], tokens,
                                      attention_mask=batch["attention_mask"])
                return -(lp * valid).sum() / valid.sum().clamp_min(1.0), None

            params, opt_state, l, _ = grad_step(loss, params, tx, opt_state)
            return params, opt_state, l

        return step

    def learn(self, batch: Dict[str, np.ndarray]) -> float:
        step = self.jit_fn("train", self._train_fn)
        params, opt_state, loss = step(self.actor.params, self.optimizer.opt_state,
                                       _offline_batch(batch, self.dev))
        self.actor.params = params
        self.optimizer.opt_state = opt_state
        return float(loss)

    @torch.no_grad()
    def generate(self, prompt_tokens, prompt_mask, max_new_tokens: int = 16,
                 temperature: float = 1.0):
        """Sample completions of left-padded prompts through the KV-cached
        generate loop. Returns (completions [B, N], mask) as tensors."""
        as_t = lambda x, dt: torch.as_tensor(np.asarray(x), device=self.dev, dtype=dt)  # noqa: E731
        return _generate(self.model_config, self.actor.params["gpt"],
                         as_t(prompt_tokens, torch.long), as_t(prompt_mask, torch.int32),
                         self.next_key(self.dev), max_new_tokens=max_new_tokens,
                         temperature=temperature)
