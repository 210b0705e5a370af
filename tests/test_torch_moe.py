"""Parity of the port's MoE layers (agilerl_tpu_torch.llm.moe and the MoE half
of llm/model.py) with the JAX package's, on the CPU in f32: the routed FFN
with its capacity buckets and load-balance loss, the parameter layout, the
forward with ``return_aux`` over an interleaved dense/MoE stack, and the
cached decode path."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.llm import moe as JMoE  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm import moe as TMoE  # noqa: E402
from agilerl_tpu_torch.llm.convert import params_from_numpy  # noqa: E402

torch.set_num_threads(1)


# jitted: one compile of the whole function costs less than eager JAX's
# compile of each op
_jax_moe_ffn = jax.jit(JMoE.moe_ffn, static_argnames=("top_k", "capacity_factor"))


def _moe_inputs(seed, N=24, d=16, f=32, E=4, router_scale=0.5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, d)).astype(np.float32)
    router = (router_scale * rng.normal(size=(d, E))).astype(np.float32)
    wg = (0.1 * rng.normal(size=(E, d, f))).astype(np.float32)
    wu = (0.1 * rng.normal(size=(E, d, f))).astype(np.float32)
    wd = (0.1 * rng.normal(size=(E, f, d))).astype(np.float32)
    return x, router, wg, wu, wd


@pytest.mark.parametrize("top_k,capacity_factor", [(2, 1.25), (1, 1.0), (2, 0.5), (2, 4.0)])
def test_moe_ffn_matches_jax(top_k, capacity_factor):
    """Out and aux at rtol 1e-5 (atol 1e-6 on out), with and without
    capacity overflow."""
    args = _moe_inputs(0)
    jout, jaux = _jax_moe_ffn(*(jnp.asarray(a) for a in args), top_k=top_k,
                              capacity_factor=capacity_factor)
    tout, taux = TMoE.moe_ffn(*(torch.as_tensor(a) for a in args), top_k=top_k,
                              capacity_factor=capacity_factor)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    assert TMoE.moe_capacity(24, 4, top_k, capacity_factor) == JMoE.moe_capacity(
        24, 4, top_k, capacity_factor)


def test_single_expert_matches_dense_swiglu():
    """E = 1, k = 1 and room for every token: exactly the dense SwiGLU, and
    aux = 1."""
    x, _, wg, wu, wd = (torch.as_tensor(a) for a in _moe_inputs(1, E=1))
    out, aux = TMoE.moe_ffn(x, torch.zeros(x.shape[1], 1), wg, wu, wd, top_k=1,
                            capacity_factor=2.0)
    dense = (torch.nn.functional.silu(x @ wg[0]) * (x @ wu[0])) @ wd[0]
    torch.testing.assert_close(out, dense, rtol=2e-4, atol=1e-5)
    assert aux.item() == pytest.approx(1.0, rel=1e-5)


def test_capacity_overflow_drops_the_same_tokens():
    """Capacity 1 and a router sending every token to expert 0: only the
    first token is computed, as in the JAX package."""
    N, d, f = 6, 4, 8
    x = np.ones((N, d), np.float32)
    router = np.concatenate([np.full((d, 1), 5.0), np.full((d, 1), -5.0)], 1).astype(np.float32)
    w = [np.full(s, 0.1, np.float32) for s in ((2, d, f), (2, d, f), (2, f, d))]
    jout, _ = _jax_moe_ffn(jnp.asarray(x), jnp.asarray(router), *map(jnp.asarray, w), top_k=1,
                           capacity_factor=1 / 6)
    tout, _ = TMoE.moe_ffn(torch.as_tensor(x), torch.as_tensor(router),
                           *map(torch.as_tensor, w), top_k=1, capacity_factor=1 / 6)
    assert tout[0].abs().sum() > 0
    assert not tout[1:].any()
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-6, atol=1e-7)


def _configs(**kw):
    base = dict(vocab_size=64, n_layer=4, n_head=2, d_model=16, max_seq_len=32,
                n_experts=2, moe_every=2)
    base.update(kw)
    return JM.GPTConfig(dtype=jnp.float32, **base), TM.GPTConfig(dtype=torch.float32, **base)


@pytest.mark.parametrize("moe_every,expert_top_k", [(2, 2), (1, 1)])
def test_forward_and_aux_match_jax(moe_every, expert_top_k):
    """The port's init has the JAX init's keys and shapes (router and
    stacked [E, ...] experts on the MoE layers only); then logits and the
    summed load-balance loss on carried weights (rtol 1e-5): an interleaved
    dense/MoE stack and an all-MoE stack with top-1 routing."""
    jcfg, tcfg = _configs(moe_every=moe_every, expert_top_k=expert_top_k, n_experts=4)
    jp = JM.init_params(jax.random.PRNGKey(3), jcfg)
    own = TM.init_params(0, tcfg, device="cpu")  # the port's init: the same layout
    for i in map(str, range(4)):
        assert list(own["blocks"][i]) == list(jp["blocks"][i])
        for k, w in jp["blocks"][i].items():
            assert tuple(own["blocks"][i][k].shape) == w.shape, (i, k)
    assert [tcfg.is_moe_layer(i) for i in range(4)] == [(i + 1) % moe_every == 0
                                                        for i in range(4)]
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tcfg, device="cpu")
    tokens = (np.arange(24).reshape(2, 12) * 5) % 64
    mask = np.ones_like(tokens)
    mask[0, :3] = 0
    forward = jax.jit(lambda p, t, m: JM.apply(jcfg, p, t, attention_mask=m, return_aux=True))
    jl, _, jaux = forward(jp, jnp.asarray(tokens), jnp.asarray(mask))  # jitted: see _jax_moe_ffn
    tl, cache, taux = TM.apply(tcfg, tp, torch.as_tensor(tokens),
                               attention_mask=torch.as_tensor(mask), return_aux=True)
    assert cache is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)
    assert taux.item() > 0
    dense_cfg = dataclasses.replace(tcfg, n_experts=0)
    dense = TM.init_params(0, dense_cfg, device="cpu")
    _, _, zero = TM.apply(dense_cfg, dense, torch.as_tensor(tokens), return_aux=True)
    assert zero.item() == 0.0 and zero.dtype == torch.float32


def test_cached_decode_matches_full_forward():
    """Prefill 5 tokens, then 3 more through the KV cache: the logits of the
    last 3 equal the uncached forward's (capacity for every token in both)."""
    _, tcfg = _configs(capacity_factor=4.0, moe_every=1, n_experts=4)
    params = TM.init_params(0, tcfg, device="cpu")
    B, T = 2, 8
    tokens = (torch.arange(B * T).reshape(B, T) * 7) % 64
    full, _ = TM.apply(tcfg, params, tokens)
    cache = TM.init_caches(tcfg, B, max_len=16, device="cpu")
    _, cache = TM.apply(tcfg, params, tokens[:, :5], cache=cache)
    got, _ = TM.apply(tcfg, params, tokens[:, 5:], cache=cache,
                      positions=torch.arange(5, T).expand(B, T - 5))
    torch.testing.assert_close(got, full[:, 5:], rtol=2e-5, atol=2e-5)


def test_init_lora_refuses_ffn_targets_on_moe():
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="MoE"):
        TM.init_lora(0, tcfg, rank=4, targets=("wq", "w_gate"), device="cpu")
    lora = TM.init_lora(0, tcfg, rank=4, targets=("wq", "wv"), device="cpu")
    assert set(lora["blocks"]["1"]) == {"wq", "wv"}
