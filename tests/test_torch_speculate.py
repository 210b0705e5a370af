"""Parity of the port's speculative decoding (agilerl_tpu_torch.llm.speculate)
with the JAX package's on the CPU: the host proposers exactly, speculative
greedy decoding token for token (and against plain decoding), and, in the
port's own counter streams, the sampled contracts: a slot with no draft
takes exactly the plain step's draw, rejection sampling keeps every
position's distribution (chi-square), an opted-out slot keeps its plain
stream in a mixed pool, and decode-captured logprobs equal
``token_logprobs``."""

import numpy as np
import pytest
import torch
from scipy import stats

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.llm import serving as JS  # noqa: E402
from agilerl_tpu.llm import speculate as JSP  # noqa: E402
from agilerl_tpu.observability import MetricsRegistry as JRegistry  # noqa: E402
from agilerl_tpu_torch.llm import generate as TG, model as TM  # noqa: E402
from agilerl_tpu_torch.llm import serving as TS, speculate as TSP  # noqa: E402
from agilerl_tpu_torch.llm.convert import params_from_numpy  # noqa: E402
from agilerl_tpu_torch.observability import MetricsRegistry as TRegistry  # noqa: E402

torch.set_num_threads(1)

VOCAB = 96
KW = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq_len=256)
JCFG = JM.GPTConfig(dtype=jnp.float32, **KW)
TCFG = TM.GPTConfig(dtype=torch.float32, **KW)
GEN = dict(max_new_tokens=10, pad_id=0, prompt_buckets=(32,), slots=3, block_size=8,
           decode_chunk=4, n_blocks=40)


@pytest.fixture(scope="module")
def weights():
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(0), JCFG))
    params = jax.tree_util.tree_map(lambda x: x * 12.0 if x.ndim == 2 else x, params)
    return params, params_from_numpy(params, TCFG, device="cpu")


def _ragged(rng, n, lo=4, hi=28):
    return [rng.integers(3, 95, size=rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]


# --------------------------------------------------------------------------- #
# host half
# --------------------------------------------------------------------------- #


def test_spec_config_matches_jax():
    for spec in (None, False, True, {"k": 3, "ngram_min": 1}, {"completion_cache": False}):
        t, j = TSP.as_spec_config(spec), JSP.as_spec_config(spec)
        assert (t is None) == (j is None)
        if t is not None:
            assert TSP.dataclasses.asdict(t) == JSP.dataclasses.asdict(j)
    for bad in ({"k": 0}, {"ngram_min": 3, "ngram_max": 2}):
        with pytest.raises(ValueError):
            TSP.as_spec_config(bad)
        with pytest.raises(ValueError):
            JSP.as_spec_config(bad)
    with pytest.raises(TypeError):
        TSP.as_spec_config(3)


def test_ngram_proposer_matches_jax():
    rng = np.random.default_rng(0)
    for cfg in (TSP.SpecConfig(), TSP.SpecConfig(k=2, ngram_max=2, ngram_min=1)):
        tp = TSP.NgramProposer(cfg)
        jp = JSP.NgramProposer(JSP.SpecConfig(**TSP.dataclasses.asdict(cfg)))
        for _ in range(40):
            hist = rng.integers(0, 5, size=rng.integers(1, 30))  # small alphabet: repeats
            for k in (1, 3, 6):
                np.testing.assert_array_equal(tp.propose(hist, k), jp.propose(hist, k))


def test_completion_cache_matches_jax():
    t, j = TSP.CompletionCache(3), JSP.CompletionCache(3)
    ops = [("put", b"a", [1, 2]), ("put", b"b", [3]), ("get", b"a"), ("put", b"c", [4]),
           ("put", b"d", [5, 6]), ("get", b"b"), ("get", b"a"), ("put", None, [7]),
           ("put", b"e", []), ("get", None), ("get", b"d")]
    for op in ops:
        if op[0] == "put":
            t.put(op[1], np.asarray(op[2]))
            j.put(op[1], np.asarray(op[2]))
        else:
            tg, jg = t.get(op[1]), j.get(op[1])
            assert (tg is None) == (jg is None)
            if tg is not None:
                np.testing.assert_array_equal(tg, jg)
        assert len(t) == len(j)
    t.clear()
    assert len(t) == 0


# --------------------------------------------------------------------------- #
# greedy: speculation changes nothing
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("eos", [False, True])
def test_speculative_greedy_matches_plain_and_jax(weights, eos):
    """More requests than slots with prompt repeats (the completion cache
    drafts them) and n-gram drafts: speculative greedy equals plain greedy,
    and equals the JAX package's speculative run, accept counts included."""
    params, tparams = weights
    rng = np.random.default_rng(1)
    base = _ragged(rng, 4)
    waves = [base + base[:2], [base[2], base[0]] + _ragged(rng, 2)]
    plain = TS.ContinuousGenerator(TCFG, metrics=TRegistry(), device="cpu", **GEN)
    eos_id = None
    if eos:
        free = plain.generate(waves[0], 0, tparams, greedy=True)[0]
        eos_id = int(free[1, 4])
        plain = TS.ContinuousGenerator(TCFG, eos_id=eos_id, metrics=TRegistry(), device="cpu",
                                       **GEN)
    spec = {"k": 3}
    t = TS.ContinuousGenerator(TCFG, eos_id=eos_id, speculate=spec, metrics=TRegistry(),
                               device="cpu", **GEN)
    j = JS.ContinuousGenerator(JCFG, eos_id=eos_id, speculate=spec, metrics=JRegistry(), **GEN)
    for i, seqs in enumerate(waves):
        pc, pm, _ = plain.generate(seqs, i, tparams, greedy=True)
        tc, tm, tinfo = t.generate(seqs, i, tparams, greedy=True)
        jc, jm, jinfo = j.generate(seqs, jax.random.PRNGKey(i), params, greedy=True)
        np.testing.assert_array_equal(tc, pc)
        np.testing.assert_array_equal(tm, pm)
        np.testing.assert_array_equal(tc, np.asarray(jc))
        np.testing.assert_array_equal(tm, np.asarray(jm))
        assert tinfo["compiled_programs"] == jinfo["compiled_programs"]
    ts, js = t.latency_summary(), j.latency_summary()
    for k in ("spec_proposed_tokens_total", "spec_accepted_tokens_total",
              "tokens_decoded_total", "prefix_cache_hits_total"):
        assert ts[k] == js[k], k
    assert ts["spec_accepted_tokens_total"] > 0


# --------------------------------------------------------------------------- #
# sampled: the port's own counter streams
# --------------------------------------------------------------------------- #

SMALL = dict(vocab_size=12, n_layer=1, n_head=2, n_kv_head=2, d_model=16, max_seq_len=64,
             dtype=torch.float32)


def _replicated_slot(cfg, params, prompt, rows, **kw):
    """A decode carry of ``rows`` slots that all hold ``prompt`` after its
    prefill (one admission, its block table shared read-only), each slot
    with its own key (seed i)."""
    gen = TS.ContinuousGenerator(cfg, device="cpu", slots=1, metrics=TRegistry(),
                                 pad_id=0, **kw)
    gen.submit(prompt, key=0)
    gen._check_weight_epoch(params, None)
    gen._admit(params, None, greedy=False)
    rep = lambda a: torch.as_tensor(np.repeat(a[:1], rows, axis=0))  # noqa: E731
    keys = torch.as_tensor(np.stack([TG.request_key(i) for i in range(rows)]))
    return (gen._pool, rep(gen._tables), rep(gen._mask), rep(gen._lengths),
            rep(gen._prev_tok), rep(gen._prev_ok), rep(gen._pos), rep(gen._step_idx),
            rep(gen._done), keys)


def _window_logits(cfg, params, carry, drafts):
    """Raw logits [T, V] of slot 0's verify window (the forward
    paged_verify_step runs, on its own)."""
    pool, tables, mask, lengths, prev_tok, prev_ok, pos = (x[:1] if i else x
                                                           for i, x in enumerate(carry[:7]))
    T = drafts.shape[1] + 1
    j = torch.arange(T)
    cand = torch.cat([prev_tok[:, None], drafts[:1]], dim=1)
    positions = pos[:, None] + torch.where(j[None] == 0, 0, prev_ok.int()[:, None] + j[None] - 1)
    write_pos = lengths[:, None] + j[None]
    rel = torch.arange(mask.shape[1])[None] - lengths[:, None]
    vm = torch.where(rel == 0, prev_ok.int()[:, None], mask)
    vm = torch.where((rel >= 1) & (rel < T), 1, vm).to(mask.dtype)
    hidden, _ = TM.forward_paged(cfg, params, cand, positions, write_pos, pool, tables, vm)
    return TM.logits_fn(cfg, params, hidden)[0]


KNOBS = dict(lora=None, lora_scale=2.0, top_p=None, eos_id=None, pad_id=0, min_new_tokens=None)


def test_draft_len_zero_takes_the_plain_steps_draw():
    """Every slot at draft_len 0 (mixed with parked slots): the verify step
    emits exactly the plain decode step's token from the same draw, and
    leaves the same carry."""
    cfg = TM.GPTConfig(**dict(SMALL, vocab_size=61, d_model=32))
    params = TM.init_params(3, cfg, device="cpu")
    carry = _replicated_slot(cfg, params, np.asarray([3, 5, 7, 4, 9], np.int32), 64,
                             max_new_tokens=6, prompt_buckets=(8,), block_size=4)
    done = torch.zeros(64, dtype=torch.bool)
    done[::7] = True  # parked slots ride along
    carry = (*carry[:8], done, carry[9])
    knobs = dict(KNOBS, temperature=0.8, top_k=20)
    dc, (dt, de) = TG.paged_decode_step(cfg, params, carry, **knobs)
    drafts = torch.full((64, 2), 7, dtype=torch.int32)
    vc, (vt, ve, vn, va) = TSP.paged_verify_step(cfg, params, carry, drafts,
                                                 torch.zeros(64, dtype=torch.int32), **knobs)
    assert len(set(dt[~done].tolist())) > 3  # the draws really vary across slots
    torch.testing.assert_close(vt[:, 0], dt, rtol=0, atol=0)
    torch.testing.assert_close(ve[:, 0], de, rtol=0, atol=0)
    assert not ve[:, 1:].any() and (va == 0).all()
    torch.testing.assert_close(vn, de.to(vn.dtype), rtol=0, atol=0)
    for a, b in zip(vc[2:], dc[2:]):  # mask, lengths, tokens, ..., keys
        torch.testing.assert_close(a[~done], b[~done].to(a.dtype), rtol=0, atol=0)


def _chi2_p(counts, probs):
    """Chi-square p-value of counts against probs, categories with an
    expected count below 5 merged into one."""
    n = counts.sum()
    expected = probs * n
    small = expected < 5
    obs = np.append(counts[~small], counts[small].sum())
    exp = np.append(expected[~small], expected[small].sum())
    if exp[-1] == 0:
        assert obs[-1] == 0
        obs, exp = obs[:-1], exp[:-1]
    return stats.chisquare(obs, exp * obs.sum() / exp.sum()).pvalue


def test_rejection_sampling_preserves_each_positions_distribution():
    """4000 slots verify the same drafts, each in its own stream: the first
    emitted token follows p_0; given the first draft accepted, the second
    follows p_1, whether the second draft is inside the window (its
    rejection masks it out of the residual) or past it (the full p_1); the
    accept rate of the first draft is p_0(d_0)."""
    cfg = TM.GPTConfig(**SMALL)
    params = TM.init_params(0, cfg, device="cpu")
    params = {k: ({i: {n: w * 4 for n, w in b.items()} for i, b in v.items()}
                  if k == "blocks" else v * 4) for k, v in params.items()}
    rows = 4000
    carry = _replicated_slot(cfg, params, np.asarray([3, 5, 7, 4], np.int32), rows,
                             max_new_tokens=6, prompt_buckets=(8,), block_size=4)
    plain = torch.softmax(_window_logits(cfg, params, carry, torch.zeros((1, 2), dtype=torch.int32)), -1)
    d0 = int(plain[0].argmax())
    drafts = torch.full((1, 2), d0, dtype=torch.int32)
    p = torch.softmax(_window_logits(cfg, params, carry, drafts), -1).double().numpy()
    d1 = int(p[1].argmax())  # the likeliest second token: masking it would show
    drafts = torch.tensor([[d0, d1]], dtype=torch.int32).repeat(rows, 1)
    dlen = torch.tensor([2, 1], dtype=torch.int32).repeat(rows // 2)
    _, (tok, emit, n_emit, n_acc) = TSP.paged_verify_step(
        cfg, params, carry, drafts, dlen, **dict(KNOBS, temperature=1.0, top_k=None))
    tok, n_acc = tok.numpy(), n_acc.numpy()
    assert emit[:, 0].all()
    counts0 = np.bincount(tok[:, 0], minlength=12)
    assert _chi2_p(counts0, p[0]) > 1e-3
    accepted = n_acc >= 1
    rate = accepted.mean()
    assert abs(rate - p[0, d0]) < 4 * np.sqrt(p[0, d0] * (1 - p[0, d0]) / rows)
    for half in (0, 1):  # dlen 2 (d1 inside the window), dlen 1 (past it)
        sel = accepted & (np.arange(rows) % 2 == half)
        counts1 = np.bincount(tok[sel, 1], minlength=12)
        assert counts1[d1] > 0
        assert _chi2_p(counts1, p[1]) > 1e-3, (half, counts1, p[1])


def test_sampled_decode_follows_the_filtered_distribution():
    """The per-row Gumbel-max draw of paged_decode_step samples the
    temperature + top-k filtered distribution."""
    cfg = TM.GPTConfig(**SMALL)
    params = TM.init_params(1, cfg, device="cpu")
    params = {k: ({i: {n: w * 4 for n, w in b.items()} for i, b in v.items()}
                  if k == "blocks" else v * 4) for k, v in params.items()}
    rows = 4000
    carry = _replicated_slot(cfg, params, np.asarray([2, 9, 4], np.int32), rows,
                             max_new_tokens=6, prompt_buckets=(8,), block_size=4)
    logits = _window_logits(cfg, params, carry, torch.zeros((1, 0), dtype=torch.int32))[:1]
    want = torch.softmax(TG._filter_logits(logits, 0.7, 6, None), -1)[0].double().numpy()
    _, (tok, _) = TG.paged_decode_step(cfg, params, carry, **dict(KNOBS, temperature=0.7,
                                                                   top_k=6))
    counts = np.bincount(tok.numpy(), minlength=12)
    assert (counts[want == 0] == 0).all()
    assert _chi2_p(counts, want) > 1e-3


def test_opted_out_request_keeps_its_plain_stream_in_a_mixed_pool(weights):
    """A request that opts out rides verify steps at draft_len 0 while its
    neighbours always draft: its sampled stream is the plain run's."""
    tparams = weights[1]
    rng = np.random.default_rng(6)
    spec_prompt = rng.integers(3, 95, size=12).astype(np.int32)
    plain_prompt = rng.integers(3, 95, size=9).astype(np.int32)
    keys = [TG.fold_in(TG.request_key(8), i) for i in range(3)]
    kw = dict(GEN, temperature=0.9)
    ref = TS.ContinuousGenerator(TCFG, metrics=TRegistry(), device="cpu", **kw)
    rt = [ref.submit(p, key=k, no_shed=True)
          for p, k in zip([spec_prompt, spec_prompt, plain_prompt], keys)]
    ref.run_until_drained(tparams)
    want = ref.result(rt[2])[0]

    class ConstDraft:
        def propose(self, history, k):
            return np.asarray([5, 9], np.int32)[:k]

    gen = TS.ContinuousGenerator(TCFG, metrics=TRegistry(), device="cpu",
                                 speculate={"k": 2, "completion_cache": False}, **kw)
    gen._proposer = ConstDraft()
    t1 = gen.submit(spec_prompt, key=keys[0], no_shed=True)
    t2 = gen.submit(spec_prompt, key=keys[1], no_shed=True)
    t3 = gen.submit(plain_prompt, key=keys[2], no_shed=True, speculate=False)
    gen.run_until_drained(tparams)
    gen.result(t1), gen.result(t2)
    assert gen.latency_summary()["spec_proposed_tokens_total"] > 0
    np.testing.assert_array_equal(gen.result(t3)[0], want)


@pytest.mark.parametrize("speculate", [None, {"k": 3}])
def test_captured_logprobs_match_token_logprobs(weights, speculate):
    """Sampled serving with capture_logprobs: every emitted token's captured
    logprob equals ``token_logprobs`` over prompt + completion (f32)."""
    tparams = weights[1]
    rng = np.random.default_rng(7)
    base = _ragged(rng, 3)
    seqs = base + base[:2]
    gen = TS.ContinuousGenerator(TCFG, metrics=TRegistry(), device="cpu", temperature=0.9,
                                 top_k=30, capture_logprobs=True, speculate=speculate, **GEN)
    comp, cmask, info = gen.generate(seqs, 5, tparams)
    lps = info["logprobs"]
    assert lps.shape == comp.shape and (lps[cmask == 0] == 0).all()
    ptoks, pmask = TG.left_pad(seqs, 0, 32)
    full = torch.as_tensor(np.concatenate([ptoks, comp], 1))
    fmask = torch.as_tensor(np.concatenate([pmask, cmask], 1))
    want = TM.token_logprobs(TCFG, tparams, full, fmask)[:, 31:].numpy()
    np.testing.assert_allclose(lps[cmask == 1], want[cmask == 1], atol=1e-4, rtol=0)
    assert (lps[cmask == 1] < 0).all()
