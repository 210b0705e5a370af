"""Ring attention and sequence-parallel GRPO of the port on gloo ranks on the
CPU (``tests/torch_dist_harness.py``; one pool of 4 ranks for the module, a
2-rank ring as the "sp" axis of a 2 x 2 mesh): the dense and flash engines,
with and without the key mask, against ``reference_attention`` and the JAX
ring at the JAX tests' tolerances (``tests/test_parallel/
test_ring_attention.py:22, 70, 77, 102``); ``make_sp_logprob_fn`` and its
gradient against the JAX function (``tests/test_llm/test_long_context.py:28,
70``); ``GRPO(sequence_parallel_axis="sp")`` against the JAX sp learn
(``tests/test_parallel/test_mesh.py:71-102``). On CPU tensors the flash
engine runs the flash kernels' plain versions."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from agilerl_tpu.algorithms import grpo as JG  # noqa: E402
from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.llm.long_context import make_sp_logprob_fn as j_sp_logprob_fn  # noqa: E402
from agilerl_tpu.ops.ring_attention import make_ring_attention as j_ring  # noqa: E402
from agilerl_tpu_torch.ops.ring_attention import reference_attention  # noqa: E402
from tests.torch_dist_harness import RankPool  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _j_mesh():
    return Mesh(np.asarray(jax.devices()), axis_names=("sp",))


def _qkv(seed, B=2, T=64, H=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, T, H, d)).astype(np.float32) for _ in range(3)]


def _ring_grads(res, sp):
    """Each rank's gradient is nonzero on its own block: the sum over one
    ring's ranks is the whole gradient."""
    return [sum(res[r]["grads"][i] for r in range(sp)) for i in range(3)]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_dense_and_jax_ring(pool, sp, use_flash, causal):
    """Forward at the JAX tolerances (dense engine atol 2e-5, flash engine
    rtol/atol 2e-4) against ``reference_attention`` and the JAX ring on its
    8-device mesh; gradients of sum(out ** 2) at the JAX flash test's rtol
    5e-3 / atol 5e-4 against the dense reference's."""
    q, k, v = _qkv(int(use_flash) + 2 * int(causal))
    res = pool.run("ring", q=q, k=k, v=v, sp=sp, causal=causal, use_flash=use_flash)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    ref = reference_attention(tq, tk, tv, causal)
    (ref ** 2).sum().backward()
    jout = np.asarray(j_ring(_j_mesh(), causal=causal, use_flash=use_flash)(
        *(jnp.asarray(x) for x in (q, k, v))))
    tol = dict(rtol=2e-4, atol=2e-4) if use_flash else dict(rtol=0, atol=2e-5)
    for r in res:
        np.testing.assert_allclose(r["out"], ref.detach().numpy(), **tol)
        np.testing.assert_allclose(r["out"], jout, **tol)
    for got, want in zip(_ring_grads(res, sp), (tq.grad, tk.grad, tv.grad)):
        np.testing.assert_allclose(got, want.numpy(), rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("use_flash", [False, True])
def test_ring_with_padding_mask_matches_dense_and_jax(pool, use_flash):
    """Right-padded keys (row 0 has 48 real tokens) travel with their block:
    real query rows against the masked dense softmax and the JAX ring."""
    q, k, v = _qkv(5)
    mask = np.ones((2, 64), np.int32)
    mask[0, 48:] = 0
    res = pool.run("ring", q=q, k=k, v=v, sp=4, causal=True, use_flash=use_flash, mask=mask)
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    t = np.arange(64)
    full = (t[:, None] >= t[None, :])[None, None] & mask[:, None, None, :].astype(bool)
    scores = np.where(full, scores, -1e30)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    jout = np.asarray(j_ring(_j_mesh(), causal=True, with_mask=True, use_flash=use_flash)(
        *(jnp.asarray(x) for x in (q, k, v, mask))))
    tol = dict(rtol=2e-4, atol=2e-4) if use_flash else dict(rtol=0, atol=2e-5)
    for r in res:
        for ref in (want, jout):
            np.testing.assert_allclose(r["out"][0, :48], ref[0, :48], **tol)
            np.testing.assert_allclose(r["out"][1], ref[1], **tol)


CFG_KW = dict(vocab_size=64, n_layer=2, n_head=4, n_kv_head=2, d_model=64, max_seq_len=128)


@pytest.mark.parametrize("sp", [2, 4])
def test_sp_logprobs_and_gradient_match_jax(pool, sp):
    """``make_sp_logprob_fn`` (dense and flash engines) against the JAX
    function at its test's atol 2e-4; the adapter gradient of -mean(lp),
    summed over the ring, against the JAX gradient at rtol 5e-3 / atol
    5e-5 (f32 attention in both)."""
    jcfg = JM.GPTConfig(dtype=jnp.float32, **CFG_KW)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    lora = JM.init_lora(jax.random.PRNGKey(1), jcfg, rank=4)
    rng = np.random.default_rng(3)
    lora = jax.tree_util.tree_map(  # non-zero B: every adapter leaf has a gradient
        lambda x: jnp.asarray(rng.normal(0, 0.05, x.shape).astype(np.float32))
        if x.shape[0] == 4 else x, lora)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 64), 2, 64))
    sp_fn = j_sp_logprob_fn(jcfg, _j_mesh())
    want = np.asarray(sp_fn(params, lora, jnp.asarray(tokens)))
    jgrad = _np_tree(jax.grad(lambda lo: -sp_fn(params, lo, jnp.asarray(tokens)).mean())(lora))
    for flash in (False, True):
        res = pool.run("sp_logprobs", cfg_kw=CFG_KW, params=_np_tree(params),
                       lora=_np_tree(lora), tokens=tokens.astype(np.int64), sp=sp, flash=flash)
        for r in res:
            np.testing.assert_allclose(r["lp"], want, rtol=0, atol=2e-4)
            for a, b in zip(jax.tree_util.tree_leaves(r["grads"]),
                            jax.tree_util.tree_leaves(jgrad)):
                np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-5)


@pytest.mark.parametrize("sp", [2, 4])
def test_grpo_sequence_parallel_learn_matches_jax_sp_learn(pool, sp):
    """One sp learn on right-padded rows against the JAX sp learn on the
    8-device sp mesh at the JAX test's rtol 2e-3 / atol 2e-4 on the loss
    and rtol 5e-3 / atol 5e-4 on the adapter; the gradient its optimizer
    step took (summed over the ring) within 1e-4 in relative L2 of the
    port's unplaced, unsplit learn's (one Adam step at lr 5e-6 is about lr
    * sign(gradient), so the adapters alone would not show a wrong
    gradient); adapters and Adam moments bit-identical across the ranks; a
    left-padded batch and a length that the axis does not divide are
    refused."""
    from tests.torch_dist_cases import _agent, capture_grads

    cfg_kw = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq_len=64)
    kw = dict(pad_token_id=0, eos_token_id=1, group_size=2, batch_size=4)
    jcfg = JM.GPTConfig(dtype=jnp.float32, **cfg_kw)
    rng = np.random.default_rng(0)
    B, T = 4, 32
    ids = rng.integers(2, 127, size=(B, T)).astype(np.int64)
    ids[1, T - 5:] = 0  # right padding
    loss_mask = np.zeros((B, T - 1), np.float32)
    loss_mask[:, T // 2:] = (ids[:, T // 2 + 1:] != 0)
    rewards = rng.normal(size=(B // 2, 2)).astype(np.float32)
    jagent = JG.GRPO(config=jcfg, seed=0, sequence_parallel_axis="sp", **kw)
    base, actor, ref = (_np_tree(t) for t in (jagent.base_params, jagent.actor.params,
                                              jagent.reference.params))
    jagent.to_mesh(_j_mesh())
    jloss, _ = jagent.learn((jnp.asarray(ids), jnp.asarray(loss_mask), jnp.asarray(rewards)))
    res = pool.run("grpo_sp_learn", cfg_kw=cfg_kw, base=base, actor=actor, reference=ref,
                   batch=(ids, loss_mask, rewards), kw=kw, sp=sp, flash=True)
    ja = _np_tree(jagent.actor.params)
    dense = _agent(dict(cfg_kw, use_flash_attention=True), base, actor, ref, kw)
    want = capture_grads(dense)
    dense.learn((ids, loss_mask, rewards))
    want = np.concatenate([x.ravel() for x in jax.tree_util.tree_leaves(want[0])])
    assert np.linalg.norm(want) > 0
    for r in res:
        assert np.isfinite(r["loss"])
        got = np.concatenate([x.ravel() for x in jax.tree_util.tree_leaves(r["grad"])])
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want)
        np.testing.assert_allclose(r["loss"], jloss, rtol=2e-3, atol=2e-4)
        np.testing.assert_allclose(r["actor"]["blocks"]["0"]["wq"]["A"],
                                   ja["blocks"]["0"]["wq"]["A"], rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(r["actor"]["blocks"]["1"]["wv"]["B"],
                                   ja["blocks"]["1"]["wv"]["B"], rtol=5e-3, atol=5e-4)
    for r in res[1:]:
        for key in ("actor", "adam"):
            for a, b in zip(jax.tree_util.tree_leaves(r[key]),
                            jax.tree_util.tree_leaves(res[0][key])):
                np.testing.assert_array_equal(a, b)
    left = ids.copy()
    left[2, :3] = 0
    for bad, why in ((left, "right-padded"), (ids[:, :30], "not divisible")):
        if why == "not divisible" and 30 % sp == 0:
            continue
        out = pool.run("grpo_sp_learn", cfg_kw=cfg_kw, base=base, actor=actor, reference=ref,
                       batch=(bad, loss_mask[:, :bad.shape[1] - 1], rewards), kw=kw, sp=sp,
                       flash=False)
        assert all(why in r["refused"] for r in out)


def test_grpo_sequence_parallel_learn_with_remat(pool):
    """The sp learn of the test above (2-rank ring, flash engine) with
    ``remat``: the loss and the gradient its optimizer step took bit for bit
    those without remat on every rank (the recompute sends the ring's
    shifts again, in the backward's order on every rank); each rank's
    flash forwards grow by its ring's forward calls of one learn (the
    recompute), its backwards stay as they are."""
    cfg_kw = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq_len=64)
    kw = dict(pad_token_id=0, eos_token_id=1, group_size=2, batch_size=4)
    jcfg = JM.GPTConfig(dtype=jnp.float32, **cfg_kw)
    jagent = JG.GRPO(config=jcfg, seed=0, **kw)
    base, actor, ref = (_np_tree(t) for t in (jagent.base_params, jagent.actor.params,
                                              jagent.reference.params))
    rng = np.random.default_rng(5)
    ids = rng.integers(2, 127, size=(4, 32)).astype(np.int64)
    loss_mask = np.zeros((4, 31), np.float32)
    loss_mask[:, 16:] = 1.0
    rewards = rng.normal(size=(2, 2)).astype(np.float32)
    res = pool.run("grpo_sp_remat", cfg_kw=cfg_kw, base=base, actor=actor, reference=ref,
                   batch=(ids, loss_mask, rewards), kw=kw, sp=2)
    for r in res:
        off, on = r[False], r[True]
        assert off["loss"] == on["loss"] and np.isfinite(on["loss"])
        for a, b in zip(jax.tree_util.tree_leaves(off["grad"]),
                        jax.tree_util.tree_leaves(on["grad"])):
            np.testing.assert_array_equal(a, b)
        assert on["calls"]["bwd"] == off["calls"]["bwd"] > 0
        # 3 forward passes of the model (old, reference, learn): the
        # recompute repeats the learn's
        assert on["calls"]["fwd"] == off["calls"]["fwd"] + off["calls"]["fwd"] // 3


def test_sp_refusals_single_process():
    """Without a mesh carrying the axis, the sp learn raises; the flash
    engine's dense reference is itself the JAX reference attention."""
    from agilerl_tpu_torch.algorithms.grpo import GRPO
    from agilerl_tpu_torch.llm import model as TM

    cfg = TM.GPTConfig(dtype=torch.float32, **dict(CFG_KW, vocab_size=128))
    agent = GRPO(config=cfg, seed=0, device="cpu", sequence_parallel_axis="sp",
                 pad_token_id=0, group_size=2, batch_size=4)
    ids = np.random.default_rng(0).integers(2, 127, size=(4, 16))
    with pytest.raises(RuntimeError, match="requires to_mesh"):
        agent.learn((ids, np.ones((4, 15), np.float32), np.zeros((2, 2), np.float32)))
    q, k, v = _qkv(9, T=16)
    from agilerl_tpu.ops.ring_attention import reference_attention as j_ref

    np.testing.assert_allclose(
        reference_attention(*(torch.as_tensor(x) for x in (q, k, v))).numpy(),
        np.asarray(j_ref(*(jnp.asarray(x) for x in (q, k, v)))), rtol=0, atol=2e-6)
