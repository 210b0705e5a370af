"""Parity of the port's GRPO training path (agilerl_tpu_torch.algorithms) with
the JAX package's, on the CPU: the loss core, the optimizer against the optax
chain, and ``GRPO.learn`` on the same weights and batch. On CPU tensors the
port runs the plain versions of its flash and fused kernels (forward and
backward); the JAX package's CPU learn step takes its dense attention and
chunked log-softmax, so the two agree to f32 summation order."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.algorithms import grpo as JG  # noqa: E402
from agilerl_tpu.algorithms.core import optimizer as JO  # noqa: E402
from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu_torch.algorithms import grpo as TG  # noqa: E402
from agilerl_tpu_torch.algorithms.core import optimizer as TO  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy  # noqa: E402
from agilerl_tpu_torch.utils.tree import tree_copy  # noqa: E402

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _loss_batch(seed, rows=4, T=9, with_rho=False):
    rng = np.random.default_rng(seed)
    batch = {
        "loss_mask": (rng.random((rows, T)) > 0.3).astype(np.float32),
        "old_lp": rng.normal(-2.0, 0.5, (rows, T)).astype(np.float32),
        "ref_lp": rng.normal(-2.0, 0.5, (rows, T)).astype(np.float32),
        "advantage": rng.normal(size=rows).astype(np.float32),
    }
    if with_rho:
        batch["rho"] = rng.uniform(0.2, 2.0, (rows, T)).astype(np.float32)
    lp = rng.normal(-2.0, 0.5, (rows, T)).astype(np.float32)
    return lp, batch


@pytest.mark.parametrize("with_rho", [False, True])
def test_grpo_loss_core_matches_jax(with_rho):
    lp, batch = _loss_batch(0, with_rho=with_rho)
    jl, jk = JG._grpo_loss_core(jnp.asarray(lp), {k: jnp.asarray(v) for k, v in batch.items()},
                                jnp.float32(0.2), jnp.float32(0.04))
    tl, tk = TG._grpo_loss_core(torch.as_tensor(lp),
                                {k: torch.as_tensor(v) for k, v in batch.items()}, 0.2, 0.04)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(tk.item(), float(jk), rtol=1e-6)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"A": rng.normal(size=(5, 3)).astype(np.float32)},
            "b": rng.normal(size=(7,)).astype(np.float32)}


def _optax_set_lr(wrapper, lr):
    """set_lr as optax means it: the injected learning rate edited in the
    state. (The JAX wrapper's own set_lr misses the state type this optax
    builds, InjectStatefulHyperparamsState, and leaves the old rate in it.)"""
    clip_state, inner = wrapper.opt_state
    hp = dict(inner.hyperparams, learning_rate=jnp.asarray(lr, jnp.float32))
    wrapper.opt_state = (clip_state, inner._replace(hyperparams=hp))


@pytest.mark.parametrize("schedule", [False, True])
def test_optimizer_matches_optax_chain(schedule):
    """3 steps of clip-by-global-norm + AdamW on identical gradients (the
    first step clips, the others do not), with a warmup-cosine schedule
    (set_lr rebuilds it with the new peak) or an injected lr that set_lr
    edits in the state between steps; rtol 1e-6."""
    cfg = dict(num_epochs=2, warmup_proportion=0.3, min_lr_fraction=0.1, steps_per_epoch=3)
    sched = lambda mod: mod.CosineLRScheduleConfig(**cfg) if schedule else None  # noqa: E731
    jw = JO.OptimizerWrapper("adamw", lr=1e-2, max_grad_norm=1.0, lr_schedule=sched(JO))
    tw = TO.OptimizerWrapper("adamw", lr=1e-2, max_grad_norm=1.0, lr_schedule=sched(TO))
    params = _opt_tree(0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = _torch_tree(params)
    jw.init(jp)
    tw.init(tp)
    for step, scale in enumerate((3.0, 0.1, 0.2)):
        grads = jax.tree_util.tree_map(lambda x: x * scale, _opt_tree(10 + step))
        jp = jw.update(jax.tree_util.tree_map(jnp.asarray, grads), jp)
        tp = tw.update(_torch_tree(grads), tp)
        for jl, tl in zip(jax.tree_util.tree_leaves(jp), [tp["a"]["A"], tp["b"]]):
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6, atol=1e-7)
        if step == 0:
            jw.set_lr(3e-3)
            if not schedule:
                _optax_set_lr(jw, 3e-3)
            tw.set_lr(3e-3)
    if schedule:  # warmup from 0: the first step moved nothing but weight decay
        assert tw.opt_state[1][2].count == 3
    else:
        assert tw.opt_state[1].hyperparams["learning_rate"] == 3e-3


VOCAB = 41


def _configs():
    kw = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=64, max_seq_len=64,
              tie_embeddings=False)
    return JM.GPTConfig(dtype=jnp.float32, **kw), TM.GPTConfig(dtype=torch.float32, **kw)


def _learn_batch(seed, groups=2, G=3, P=6, N=5):
    rng = np.random.default_rng(seed)
    rows = groups * G
    ids = rng.integers(2, VOCAB, (rows, P + N)).astype(np.int32)
    ids[0, :2] = 0  # left padding in one prompt
    ids[4, P + 3:] = 0  # an early end in one completion
    action = np.zeros((rows, P + N - 1), np.float32)
    action[:, P - 1:] = (ids[:, P:] != 0)
    rewards = rng.normal(size=(groups, G)).astype(np.float32)
    return ids, action, rewards


def test_grpo_learn_matches_jax():
    """One learn step (batch_size >= rows: one minibatch, so the permutation
    draw does not matter) on the same base weights, adapters and batch: loss
    and KL at rtol 1e-5; the adapter after the update at atol 5e-6. AdamW's
    first step is lr * g / (|g| + 1e-8), about 1e-3 per entry, so this holds
    every entry's step to 0.5 %; an entry whose gradient is within a few
    orders of 1e-8 turns the gradients' f32 summation-order differences into
    step differences of that order."""
    jcfg, tcfg = _configs()
    kw = dict(pad_token_id=0, eos_token_id=1, batch_size=8, beta=0.05, lr=1e-3,
              group_size=3, max_output_tokens=5, lora_rank=4)
    jagent = JG.GRPO(config=jcfg, seed=0, bucketed_decode=False, **kw)
    rng = np.random.default_rng(1)
    actor = _np_tree(jagent.actor.params)
    reference = _np_tree(jagent.reference.params)
    for tree, sd in ((actor, 0.05), (reference, 0.03)):  # non-zero B: both adapters matter
        for layer in tree["blocks"].values():
            for ab in layer.values():
                ab["B"] = rng.normal(0, sd, ab["B"].shape).astype(np.float32)
    jagent.actor.params = jax.tree_util.tree_map(jnp.asarray, actor)
    jagent.reference.params = jax.tree_util.tree_map(jnp.asarray, reference)
    jagent.optimizer.init(jagent.actor.params)

    tagent = TG.GRPO(config=tcfg, seed=0, device="cpu",
                     base_params=params_from_numpy(_np_tree(jagent.base_params), tcfg,
                                                   device="cpu"), **kw)
    tagent.actor.params = lora_from_numpy(actor, device="cpu")
    tagent.reference.params = lora_from_numpy(reference, device="cpu")
    tagent.optimizer.init(tagent.actor.params)

    batch = _learn_batch(2)
    jloss, jkl = jagent.learn(batch)
    tloss, tkl = tagent.learn(batch)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(tkl, jkl, rtol=1e-5)
    assert jkl > 1e-4  # the two adapters differ: the KL term is live
    after = _np_tree(jagent.actor.params)
    moved = 0.0
    for i, layer in after["blocks"].items():
        for t, ab in layer.items():
            for name in ("A", "B"):
                got = tagent.actor.params["blocks"][i][t][name].numpy()
                np.testing.assert_allclose(got, ab[name], rtol=0, atol=5e-6)
                moved = max(moved, np.abs(ab[name] - actor["blocks"][i][t][name]).max())
    assert moved > 5e-4


def test_grpo_advantage_and_behavior_logprobs():
    """Group z-score as the JAX package's (population std), and
    learn_from_trajectory at staleness 0 (rho == 1) reproduces learn."""
    rewards = np.random.default_rng(3).normal(size=(3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        TG.GRPO._calculate_advantage(torch.as_tensor(rewards)).numpy(),
        np.asarray(JG.GRPO._calculate_advantage(jnp.asarray(rewards))), rtol=1e-6)

    _, tcfg = _configs()
    kw = dict(config=tcfg, seed=4, device="cpu", batch_size=8, group_size=3, lr=1e-3,
              lora_rank=4)
    a, b = TG.GRPO(**kw), TG.GRPO(**kw)
    b.base_params = a.base_params
    b.actor.params = tree_copy(a.actor.params)
    b.reference.params = tree_copy(a.reference.params)
    b.optimizer.init(b.actor.params)
    ids, action, rew = _learn_batch(5)
    behavior = a.behavior_logprobs(ids, action)
    assert behavior.shape == action.shape and np.all(behavior[action == 0] == 0)
    la = a.learn((ids, action, rew))
    lb = b.learn_from_trajectory(ids, action, rew, behavior)
    np.testing.assert_allclose(lb, la, rtol=1e-6)


def test_grpo_get_action_greedy_is_deterministic_and_grouped():
    _, tcfg = _configs()
    agent = TG.GRPO(config=tcfg, seed=6, device="cpu", group_size=3, max_output_tokens=4,
                    eos_token_id=1, lora_rank=4)
    prompts = {"input_ids": np.array([[0, 5, 6], [7, 8, 9]], np.int32),
               "attention_mask": np.array([[0, 1, 1], [1, 1, 1]], np.int32)}
    comp, mask = agent.get_action(prompts)
    assert comp.shape == (6, 4) and mask.shape == (6, 4) and comp.dtype == np.int32
    g1, _ = agent.get_action(prompts, training=False)
    g2, _ = agent.get_action(prompts, training=False)
    assert g1.shape == (2, 4) and np.array_equal(g1, g2)
