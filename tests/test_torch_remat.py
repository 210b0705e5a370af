"""Per-block rematerialisation (``GPTConfig.remat``) of the port against the
JAX package's ``jax.checkpoint`` blocks, on the CPU: the forward
(``tests/test_llm/test_llm_components.py:46``), the LoRA gradient through
``token_logprobs`` (``:111``, 3 layers), a GRPO learn at
``tests/test_torch_grpo.py``'s tolerances, a MoE model, the presets'
default, and the paths that never checkpoint. On the CPU the recompute runs
the same operations on the same inputs, so the port with remat is held bit
for bit to the port without it; against the JAX package the tolerances are
those of the tests named."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.algorithms import grpo as JG  # noqa: E402
from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.llm.presets import preset as j_preset  # noqa: E402
from agilerl_tpu_torch.algorithms import grpo as TG  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy  # noqa: E402
from agilerl_tpu_torch.llm.presets import preset, preset_names  # noqa: E402
from agilerl_tpu_torch.ops import flash_attention_vjp  # noqa: E402
from agilerl_tpu_torch.utils.tree import tree_to_numpy  # noqa: E402

torch.set_num_threads(1)

# tests/test_llm/test_llm_components.py's CFG
KW = dict(vocab_size=64, n_layer=2, n_head=4, d_model=64, max_seq_len=32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(remat, **kw):
    kw = dict(KW, **kw)
    return (JM.GPTConfig(dtype=jnp.float32, remat=remat, **kw),
            TM.GPTConfig(dtype=torch.float32, remat=remat, **kw))


def _params(tcfg, seed=0):
    """Numpy weights from the port's initialiser (the JAX functions take
    them as they are)."""
    return tree_to_numpy(TM.init_params(seed, tcfg, device="cpu"))


def _lora(tcfg, seed=1):
    """A numpy adapter with a non-zero B (every leaf then has a gradient)."""
    lora = tree_to_numpy(TM.init_lora(seed, tcfg, rank=4, device="cpu"))
    rng = np.random.default_rng(seed)
    for layer in lora["blocks"].values():
        for ab in layer.values():
            ab["B"] = rng.normal(0, 0.05, ab["B"].shape).astype(np.float32)
    return lora


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


class checkpoint_calls:
    """Counts the model's ``torch.utils.checkpoint`` calls."""

    def __enter__(self):
        self.n, self._real = 0, TM.checkpoint

        def counted(*a, **k):
            self.n += 1
            return self._real(*a, **k)

        TM.checkpoint = counted
        return self

    def __exit__(self, *exc):
        TM.checkpoint = self._real
        return False


def test_remat_forward_matches_jax():
    """``apply`` with remat against the JAX ``apply`` with remat at the JAX
    test's atol 1e-5, and bit for bit the port without remat; under grad
    each of the 2 blocks is checkpointed once."""
    jcfg, tcfg = _configs(True)
    params = _params(tcfg)
    toks = np.arange(1, 9)[None]
    want = jax.jit(lambda p: JM.apply(jcfg, p, jnp.asarray(toks))[0])(_jnp(params))
    tparams = params_from_numpy(params, tcfg, device="cpu")
    with checkpoint_calls() as calls, torch.enable_grad():
        got, _ = TM.apply(tcfg, tparams, torch.as_tensor(toks))
    plain, _ = TM.apply(dataclasses.replace(tcfg, remat=False), tparams, torch.as_tensor(toks))
    assert calls.n == tcfg.n_layer
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert torch.equal(got.detach(), plain)


@pytest.mark.parametrize("flash", [False, True])
def test_remat_lora_gradient_matches_jax_and_plain(flash):
    """The adapter gradient of sum(token_logprobs) through 3 remat blocks
    (dense attention, or the flash kernels' plain versions) against the JAX
    gradient with remat at rtol 1e-4 / atol 1e-6 (f32 summation order),
    and bit for bit the port's gradient without remat."""
    jcfg, tcfg = _configs(True, n_layer=3)
    params, lora = _params(tcfg), _lora(tcfg)
    toks = np.arange(1, 17)[None] % 64
    jgrad = _np_tree(jax.jit(jax.grad(lambda lo, p: JM.token_logprobs(
        jcfg, p, jnp.asarray(toks), lora=lo).sum()))(_jnp(lora), _jnp(params)))
    tparams = params_from_numpy(params, tcfg, device="cpu")

    def grads(cfg):
        lo = lora_from_numpy(lora, device="cpu")
        leaves = [ab[k].requires_grad_(True) for layer in lo["blocks"].values()
                  for ab in layer.values() for k in ("A", "B")]
        TM.token_logprobs(cfg, tparams, torch.as_tensor(toks), lora=lo, flash=flash).sum().backward()
        return [t.grad.numpy() for t in leaves]

    got = grads(tcfg)
    plain = grads(dataclasses.replace(tcfg, remat=False))
    want = [ab[k] for layer in jgrad["blocks"].values() for ab in layer.values()
            for k in ("A", "B")]
    for g, p, w in zip(got, plain, want):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_remat_moe_forward_and_gradient():
    """A MoE model (every layer routed, 4 experts): the hidden and the aux
    loss with remat against the JAX forward with remat at atol 1e-5; the
    gradient of sum(h ** 2) + aux into an expert weight bit for bit the
    port's without remat (the recompute routes the same tokens)."""
    jcfg, tcfg = _configs(True, n_experts=4)
    params = _params(tcfg)
    toks = np.arange(1, 17)[None] % 64
    jh, _, jaux = jax.jit(lambda p: JM.forward(jcfg, p, jnp.asarray(toks), return_aux=True))(
        _jnp(params))

    def run(cfg):
        p = params_from_numpy(params, cfg, device="cpu")
        w = p["blocks"]["1"]["w_up"].requires_grad_(True)
        h, _, aux = TM.forward(cfg, p, torch.as_tensor(toks), return_aux=True)
        ((h ** 2).sum() + aux).backward()
        return h.detach(), aux.detach(), w.grad

    h, aux, g = run(tcfg)
    h0, aux0, g0 = run(dataclasses.replace(tcfg, remat=False))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-5)
    assert torch.equal(h, h0) and torch.equal(aux, aux0) and torch.equal(g, g0)
    assert float(g.abs().sum()) > 0


def test_grpo_learn_with_remat_matches_jax():
    """One GRPO learn with remat on both sides (tests/test_torch_grpo.py's
    recipe and bounds: loss and KL at rtol 1e-5, the adapter at atol 5e-6),
    equal to the port's learn without remat; with the flash path the learn's
    forwards through the flash engine grow by one per block (the
    recompute), the backwards stay as they are."""
    kw = dict(vocab_size=41, n_layer=2, n_head=4, n_kv_head=2, d_model=64, max_seq_len=64,
              tie_embeddings=False)
    jcfg = JM.GPTConfig(dtype=jnp.float32, remat=True, **kw)
    tcfg = TM.GPTConfig(dtype=torch.float32, remat=True, **kw)
    akw = dict(pad_token_id=0, eos_token_id=1, batch_size=8, beta=0.05, lr=1e-3,
               group_size=3, max_output_tokens=5, lora_rank=4)
    jagent = JG.GRPO(config=jcfg, seed=0, bucketed_decode=False, **akw)
    rng = np.random.default_rng(1)
    actor, reference = _np_tree(jagent.actor.params), _np_tree(jagent.reference.params)
    for tree, sd in ((actor, 0.05), (reference, 0.03)):
        for layer in tree["blocks"].values():
            for ab in layer.values():
                ab["B"] = rng.normal(0, sd, ab["B"].shape).astype(np.float32)
    jagent.actor.params = jax.tree_util.tree_map(jnp.asarray, actor)
    jagent.reference.params = jax.tree_util.tree_map(jnp.asarray, reference)
    jagent.optimizer.init(jagent.actor.params)
    rows, P, N = 6, 6, 5
    ids = rng.integers(2, 41, (rows, P + N)).astype(np.int32)
    ids[0, :2] = 0
    ids[4, P + 3:] = 0
    action = np.zeros((rows, P + N - 1), np.float32)
    action[:, P - 1:] = (ids[:, P:] != 0)
    batch = (ids, action, rng.normal(size=(2, 3)).astype(np.float32))
    jloss, jkl = jagent.learn(batch)

    def port(cfg):
        agent = TG.GRPO(config=cfg, seed=0, device="cpu",
                        base_params=params_from_numpy(_np_tree(jagent.base_params), cfg,
                                                      device="cpu"), **akw)
        agent.actor.params = lora_from_numpy(actor, device="cpu")
        agent.reference.params = lora_from_numpy(reference, device="cpu")
        agent.optimizer.init(agent.actor.params)
        calls = {"fwd": 0, "bwd": 0}
        real_fwd, real_bwd = flash_attention_vjp._fwd, flash_attention_vjp._bwd

        def fwd(*a):
            calls["fwd"] += 1
            return real_fwd(*a)

        def bwd(*a):
            calls["bwd"] += 1
            return real_bwd(*a)

        flash_attention_vjp._fwd, flash_attention_vjp._bwd = fwd, bwd
        try:
            out = agent.learn(batch)
        finally:
            flash_attention_vjp._fwd, flash_attention_vjp._bwd = real_fwd, real_bwd
        return out, TG.tree_to_numpy(agent.actor.params), calls

    (tloss, tkl), tact, calls = port(tcfg)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(tkl, jkl, rtol=1e-5)
    assert jkl > 1e-4
    after = _np_tree(jagent.actor.params)
    for i, layer in after["blocks"].items():
        for t, ab in layer.items():
            for name in ("A", "B"):
                np.testing.assert_allclose(tact["blocks"][i][t][name], ab[name], rtol=0,
                                           atol=5e-6)
    (ploss, pkl), pact, _ = port(dataclasses.replace(tcfg, remat=False))
    assert (tloss, tkl) == (ploss, pkl)
    for a, b in zip(jax.tree_util.tree_leaves(tact), jax.tree_util.tree_leaves(pact)):
        np.testing.assert_array_equal(a, b)
    flash_cfg = dataclasses.replace(tcfg, use_flash_attention=True)
    _, _, with_remat = port(flash_cfg)
    _, _, without = port(dataclasses.replace(flash_cfg, remat=False))
    L = tcfg.n_layer
    assert without["bwd"] == with_remat["bwd"] == L  # one minibatch, one update
    assert with_remat["fwd"] == without["fwd"] + L


def test_presets_default_to_remat_as_jax():
    """Every preset turns remat on, as the JAX presets do; an override wins."""
    for name in preset_names():
        assert preset(name).remat is True and j_preset(name).remat is True
    assert preset("llama3-8b", max_seq_len=1024, remat=False).remat is False
    cfg = preset("llama3-8b", max_seq_len=1024, remat=True)
    assert cfg.remat and cfg.max_seq_len == 1024


def test_cached_and_no_grad_paths_never_checkpoint():
    """A remat config checkpoints nothing in a no-grad pass (the GRPO old
    and reference logprobs), the KV-cached prefill and decode (even with
    grad enabled), generation or the paged decode step; with grad, one
    checkpoint per block."""
    from agilerl_tpu_torch.llm.generate import generate
    from agilerl_tpu_torch.llm.serving import ContinuousGenerator

    _, tcfg = _configs(True)
    params = TM.init_params(0, tcfg, device="cpu")
    toks = torch.arange(1, 9)[None]
    with checkpoint_calls() as calls:
        with torch.no_grad():
            TM.token_logprobs(tcfg, params, toks)
        with torch.enable_grad():
            cache = TM.init_caches(tcfg, 1, 16, device="cpu")
            _, cache = TM.forward(tcfg, params, toks, cache=cache)
            TM.forward(tcfg, params, toks[:, :1], cache=cache)
        generate(tcfg, params, toks, torch.ones_like(toks), max_new_tokens=3, temperature=0.0)
        ContinuousGenerator(tcfg, max_new_tokens=3, prompt_buckets=(8,), block_size=4,
                            decode_chunk=2, device="cpu").generate([np.arange(1, 6)], 0, params,
                                                                   greedy=True)
        assert calls.n == 0
        with torch.enable_grad():
            TM.token_logprobs(tcfg, params, toks)
        assert calls.n == tcfg.n_layer
