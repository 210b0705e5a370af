"""Parity of the port's paged KV cache and paged decode/verify steps
(agilerl_tpu_torch.llm.model / generate / speculate) and of the serving
tier's host bookkeeping (chain_hashes, BlockAllocator, AdmissionPolicy) with
the JAX package's, on the CPU and on the same numpy inputs."""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.llm import serving as JS  # noqa: E402
from agilerl_tpu.llm import speculate as JSP  # noqa: E402
from agilerl_tpu.observability import MetricsRegistry as JRegistry  # noqa: E402
from agilerl_tpu_torch.llm import generate as TG, model as TM  # noqa: E402
from agilerl_tpu_torch.llm import serving as TS, speculate as TSP  # noqa: E402
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy  # noqa: E402
from agilerl_tpu_torch.observability import MetricsRegistry as TRegistry  # noqa: E402

# the JAX package's llm/__init__ re-exports a `generate` function under the
# submodule's name
JG = importlib.import_module("agilerl_tpu.llm.generate")
torch.set_num_threads(1)

VOCAB, BS, MB, NB, SLOTS = 61, 4, 4, 12, 4
S = MB * BS
KW = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=32,
          max_seq_len=64, tie_embeddings=False)


@pytest.fixture(scope="module")
def model():
    jcfg = JM.GPTConfig(dtype=jnp.float32, **KW)
    tcfg = TM.GPTConfig(dtype=torch.float32, **KW)
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    # wider weights give decisive, varied argmaxes
    params = jax.tree_util.tree_map(lambda x: x * 12.0 if x.ndim == 2 else x, params)
    ad = jax.tree_util.tree_map(np.asarray, JM.init_lora(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(1)
    for layer in ad["blocks"].values():
        for ab in layer.values():
            ab["B"] = rng.normal(0, 0.1, ab["B"].shape).astype(np.float32)
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, lora=ad,
                tparams=params_from_numpy(params, tcfg, device="cpu"),
                tlora=lora_from_numpy(ad, device="cpu"))


def _pool(rng, L=2, KV=2, hd=8):
    k = rng.normal(size=(L, NB, BS, KV, hd)).astype(np.float32)
    v = rng.normal(size=(L, NB, BS, KV, hd)).astype(np.float32)
    return k, v


def _tables():
    # slot 3 is released: an all-zero table
    t = np.zeros((SLOTS, MB), np.int32)
    t[0] = [1, 2, 3, 4]
    t[1] = [5, 6, 0, 0]
    t[2] = [7, 8, 9, 10]
    return t


def _jcache(k, v):
    return JM.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v))


def _tcache(k, v):
    return TM.PagedKVCache(k=torch.as_tensor(k.copy()), v=torch.as_tensor(v.copy()))


def _same_pool(tc, jc, atol=0.0):
    """Pools equal outside the garbage block 0 (duplicate garbage writes
    may land in any order): exactly for scatters of the same values, within
    ``atol`` where the written K/V were computed by each package."""
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        np.testing.assert_allclose(t.numpy()[:, 1:], np.asarray(j)[:, 1:], atol=atol, rtol=0)


def test_paged_gather_and_write_index_match_jax():
    rng = np.random.default_rng(0)
    k, v = _pool(rng)
    tables = _tables()
    jk, jv = JM.paged_gather(jnp.asarray(k[0]), jnp.asarray(v[0]), jnp.asarray(tables))
    tk, tv = TM.paged_gather(torch.as_tensor(k[0]), torch.as_tensor(v[0]),
                             torch.as_tensor(tables))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the released slot's position ran past the table
    wp = np.asarray([5, 7, 15, S + 9], np.int32)
    want = JM.paged_write_index(jnp.asarray(tables), jnp.asarray(wp), BS)
    got = TM.paged_write_index(torch.as_tensor(tables), torch.as_tensor(wp), BS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_scatters_and_copy_match_jax():
    rng = np.random.default_rng(1)
    k, v = _pool(rng)
    tables = _tables()
    L, KV, hd = k.shape[0], k.shape[3], k.shape[4]
    jc, tc = _jcache(k, v), _tcache(k, v)
    # one token per slot; slot 3 (released) ran past S
    wp = np.asarray([5, 7, 15, S + 3], np.int32)
    nk = rng.normal(size=(L, SLOTS, KV, hd)).astype(np.float32)
    nv = rng.normal(size=(L, SLOTS, KV, hd)).astype(np.float32)
    jc = JM.paged_scatter_tokens(jc, jnp.asarray(tables), jnp.asarray(wp),
                                 jnp.asarray(nk), jnp.asarray(nv))
    out = TM.paged_scatter_tokens(tc, torch.as_tensor(tables), torch.as_tensor(wp),
                                  torch.as_tensor(nk), torch.as_tensor(nv))
    assert out.k is tc.k  # in place
    _same_pool(tc, jc)
    # a 3-token window per slot: slot 2 crosses the extent, slot 3 is past it
    wp2 = np.asarray([[4, 5, 6], [2, 3, 4], [14, 15, 16], [S + 3, S + 4, S + 5]], np.int32)
    nk2 = rng.normal(size=(L, SLOTS, 3, KV, hd)).astype(np.float32)
    nv2 = rng.normal(size=(L, SLOTS, 3, KV, hd)).astype(np.float32)
    jc = JM.paged_scatter_multi(jc, jnp.asarray(tables), jnp.asarray(wp2),
                                jnp.asarray(nk2), jnp.asarray(nv2))
    TM.paged_scatter_multi(tc, torch.as_tensor(tables), torch.as_tensor(wp2),
                           torch.as_tensor(nk2), torch.as_tensor(nv2))
    _same_pool(tc, jc)
    # one request's prompt KV into two blocks, then a block copy
    ids = np.asarray([11, 3], np.int32)
    kp = rng.normal(size=(L, 2 * BS, KV, hd)).astype(np.float32)
    vp = rng.normal(size=(L, 2 * BS, KV, hd)).astype(np.float32)
    jc = JM.paged_scatter_prompt(jc, jnp.asarray(ids), jnp.asarray(kp), jnp.asarray(vp))
    TM.paged_scatter_prompt(tc, torch.as_tensor(ids), torch.as_tensor(kp), torch.as_tensor(vp))
    _same_pool(tc, jc)
    jc = JM.paged_copy_block(jc, jnp.int32(11), jnp.int32(2))
    TM.paged_copy_block(tc, 11, 2)
    _same_pool(tc, jc)


def _slot_state(rng, T):
    """Per-slot decode state over _tables(): slots 0-2 live at different
    depths, slot 3 released with lengths past the extent."""
    lengths = np.asarray([9, 5, 13, S + 2], np.int32)
    mask = np.zeros((SLOTS, S), np.int32)
    for b, n in enumerate(lengths[:3]):
        mask[b, :n] = 1
        mask[b, :2] = 0  # left pad
    mask[:, :] = np.where(np.arange(S)[None] < np.minimum(lengths, S)[:, None], mask, 0)
    pos = np.maximum(mask.sum(1), 1).astype(np.int32)
    tok = rng.integers(1, VOCAB, size=(SLOTS, T)).astype(np.int32)
    return lengths, mask, pos, tok


@pytest.mark.parametrize("T", [1, 3])
def test_forward_paged_matches_jax(model, T):
    rng = np.random.default_rng(2 + T)
    k, v = _pool(rng)
    k *= 0.3
    v *= 0.3
    tables = _tables()
    lengths, mask, pos, tok = _slot_state(rng, T)
    if T == 1:
        positions, write_pos = pos, lengths
        mask[np.arange(3), lengths[:3]] = 1  # the current token's slot
    else:
        positions = pos[:, None] + np.arange(T)[None]
        write_pos = lengths[:, None] + np.arange(T)[None]
        for b in range(3):
            mask[b, lengths[b]:min(lengths[b] + T, S)] = 1
    jh, (jk, jv) = JM.forward_paged(
        model["jcfg"], model["params"], jnp.asarray(tok), jnp.asarray(positions),
        jnp.asarray(write_pos), _jcache(k, v), jnp.asarray(tables), jnp.asarray(mask),
        lora=model["lora"])
    th, (tk, tv) = TM.forward_paged(
        model["tcfg"], model["tparams"], torch.as_tensor(tok), torch.as_tensor(positions),
        torch.as_tensor(write_pos), _tcache(k, v), torch.as_tensor(tables),
        torch.as_tensor(mask), lora=model["tlora"])
    assert th.shape == (SLOTS, T, KW["d_model"]) and th.dtype == torch.float32
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5, rtol=0)


def _carry(k, v):
    """(JAX carry, port carry) of the same decode state over fresh copies
    of the pool (k, v)."""
    tables = _tables()
    lengths, mask, pos, tok = _slot_state(np.random.default_rng(99), 1)
    prev_ok = np.asarray([True, True, True, False])
    step_idx = np.asarray([3, 1, 7, 0], np.int32)
    done = np.asarray([False, False, False, True])
    state = dict(tables=tables, mask=mask, lengths=lengths, prev_tok=tok[:, 0],
                 prev_ok=prev_ok, pos=pos, step_idx=step_idx, done=done)
    jkeys = jnp.asarray(np.stack([np.asarray(jax.random.PRNGKey(i)) for i in range(SLOTS)]))
    jcarry = (_jcache(k, v), *(jnp.asarray(state[n]) for n in (
        "tables", "mask", "lengths", "prev_tok", "prev_ok", "pos", "step_idx", "done")), jkeys)
    tkeys = torch.as_tensor(np.stack([TG.request_key(i) for i in range(SLOTS)]))
    tcarry = (_tcache(k, v), *(torch.as_tensor(state[n]) for n in (
        "tables", "mask", "lengths", "prev_tok", "prev_ok", "pos", "step_idx", "done")), tkeys)
    return jcarry, tcarry


CARRY_FIELDS = ("mask", "lengths", "prev_tok", "prev_ok", "pos", "step_idx", "done")


def _same_carry(tcarry, jcarry):
    _same_pool(tcarry[0], jcarry[0], atol=1e-5)
    for name, t, j in zip(CARRY_FIELDS, tcarry[2:9], jcarry[2:9]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    # the port's keys advance their counter by one per step
    np.testing.assert_array_equal(tcarry[9][:, 1].numpy(), 1)


@pytest.mark.parametrize("eos_id", [None, "emitted"])
def test_paged_decode_step_greedy_matches_jax(model, eos_id):
    k, v = (0.3 * x for x in _pool(np.random.default_rng(5)))
    knobs = dict(lora_scale=2.0, temperature=0.0, top_k=None, top_p=None, pad_id=0,
                 min_new_tokens=None)
    if eos_id == "emitted":  # an EOS the step really emits: slot 0 finishes
        _, (tok, _, _) = JG.paged_decode_step(model["jcfg"], model["params"], _carry(k, v)[0],
                                              lora=model["lora"], eos_id=None,
                                              capture_lp=True, **knobs)
        eos_id = int(tok[0])
    jcarry, tcarry = _carry(k, v)
    jc, (jt, je, jl) = JG.paged_decode_step(model["jcfg"], model["params"], jcarry,
                                            lora=model["lora"], eos_id=eos_id,
                                            capture_lp=True, **knobs)
    tc, (tt, te, tl) = TG.paged_decode_step(model["tcfg"], model["tparams"], tcarry,
                                            lora=model["tlora"], eos_id=eos_id,
                                            capture_lp=True, **knobs)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    _same_carry(tc, jc)
    if eos_id is not None:
        assert bool(tc[8][0])  # the slot that emitted EOS is done


def _verify(pkg, model, carry, drafts, dlen, eos_id, capture=True):
    step = JSP.paged_verify_step if pkg == "jax" else TSP.paged_verify_step
    cfg, params, lora = ((model["jcfg"], model["params"], model["lora"]) if pkg == "jax"
                         else (model["tcfg"], model["tparams"], model["tlora"]))
    cast = jnp.asarray if pkg == "jax" else torch.as_tensor
    return step(cfg, params, carry, cast(drafts), cast(dlen), lora=lora, lora_scale=2.0,
                temperature=0.0, top_k=None, top_p=None, eos_id=eos_id, pad_id=0,
                min_new_tokens=None, capture_lp=capture)


@pytest.mark.parametrize("eos", [False, True])
def test_paged_verify_step_greedy_matches_jax(model, eos):
    """K = 3 drafts: slot 0 drafts the greedy chain itself (full accept and
    a bonus token), slot 1 one right draft then a wrong one, slot 2 none,
    slot 3 is parked. With ``eos`` the token slot 0 emits at window
    position 1 is the EOS, cutting its window."""
    K = 3
    k, v = (0.3 * x for x in _pool(np.random.default_rng(6)))
    drafts = np.zeros((SLOTS, K), np.int32)
    dlen = np.asarray([K, 2, 0, 0], np.int32)
    # build the greedy chain from the JAX step's own argmaxes
    for j in range(K):
        _, (tok, _, _, _, _) = _verify("jax", model, _carry(k, v)[0], drafts, dlen, None)
        tok = np.asarray(tok)
        drafts[0, j] = tok[0, j]
        if j == 0:
            drafts[1, 0] = tok[1, 0]
            drafts[1, 1] = (tok[1, 0] + 1) % VOCAB  # not the argmax after it
    eos_id = int(drafts[0, 1]) if eos else None
    jcarry, tcarry = _carry(k, v)
    jc, (jt, je, jn, ja, jl) = _verify("jax", model, jcarry, drafts, dlen, eos_id)
    tc, (tt, te, tn, ta, tl) = _verify("torch", model, tcarry, drafts, dlen, eos_id)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(np.where(te.numpy(), tl.numpy(), 0),
                               np.where(np.asarray(je), np.asarray(jl), 0), atol=1e-5, rtol=0)
    _same_carry(tc, jc)
    assert list(ta.numpy()[:3]) == [K, 1, 0]
    assert list(tn.numpy()) == ([2, 2, 1, 0] if eos else [K + 1, 2, 1, 0])


def test_chain_hashes_match_jax():
    rng = np.random.default_rng(7)
    for n in (4, 32, 48):
        toks = rng.integers(0, 1000, size=n).astype(np.int32)
        mask = (np.arange(n) >= rng.integers(0, n)).astype(np.int32)
        for bs in (4, 16):
            assert TS.chain_hashes(toks, mask, bs) == JS.chain_hashes(toks, mask, bs)


def test_block_allocator_matches_jax():
    """The same call sequence (alloc, register with a duplicate, lookup,
    release into the LRU, eviction by alloc, invalidate with a referenced
    block) gives the same answers and the same free/evictable counts."""
    h = [bytes([i]) * 20 for i in range(6)]

    def run(cls):
        a = cls(10)
        out = [a.alloc(3), a.alloc(2)]
        out += [a.register(h[0], 1), a.register(h[1], 2), a.register(h[0], 3),
                a.register(h[2], 4)]
        out += [a.lookup_chain([h[0], h[1]]), a.lookup_chain([h[0], h[5]])]
        a.release_shared([1, 2])
        a.release_shared([1, 2, 4])
        out.append((a.free_blocks, a.evictable_blocks, a.available()))
        out += [a.alloc(6), a.alloc(1), a.alloc(1)]
        out.append((a.free_blocks, a.evictable_blocks, a.available()))
        a.free([3, 5])
        out += [a.register(h[3], 6), a.lookup_chain([h[3]])]
        a.invalidate_cache()
        out.append(a.lookup_chain([h[3]]))
        a.release_shared([6])
        a.release_shared([6])
        out.append((a.free_blocks, a.evictable_blocks, a.available(), a.alloc(20)))
        return out

    assert run(TS.BlockAllocator) == run(JS.BlockAllocator)


def test_admission_policy_matches_jax():
    cases = [dict(queue_len=5), dict(queue_len=1, available_blocks=2, n_blocks=40),
             dict(queue_len=1, recent_ttft=[0.5] * 25),
             dict(queue_len=1, recent_ttft=[0.5] * 3),
             dict(queue_len=1, recent_ttft=[0.01] * 25, available_blocks=30, n_blocks=40)]
    kw = dict(max_queue=4, ttft_slo_s=0.1, min_slo_samples=20, free_block_watermark=0.25)
    tpol = TS.AdmissionPolicy(metrics=TRegistry(), **kw)
    jpol = JS.AdmissionPolicy(metrics=JRegistry(), **kw)
    reasons = [tpol.reason(**c) for c in cases]
    assert reasons == [jpol.reason(**c) for c in cases]
    assert reasons == ["queue_full", "free_block_watermark", "ttft_slo", None, None]
    for pol in (tpol, jpol):
        pol.shed("queue_full", queue_len=5)
    assert (tpol.metrics.counter("serving/shed_requests_total").value
            == jpol.metrics.counter("serving/shed_requests_total").value == 1)
    # a policy without a registry adopts its owner's
    reg = TRegistry()
    assert TS.AdmissionPolicy().bind_metrics(reg).metrics is reg
