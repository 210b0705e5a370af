"""Parity of the port's serving tier (agilerl_tpu_torch.llm.serving) and of
GRPO's rollout routing with the JAX package's, on the CPU: BucketedGenerator
and ContinuousGenerator greedy token for token against the JAX generators
and against dense ``generate`` (more requests than slots, EOS inside a
chunk, prefix hits, blocks freed and reused), the same program counts on the
same ragged sweep, the same shed reasons, the same telemetry keys, and the
prefix cache invalidated by a ``learn``."""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.algorithms import grpo as JGRPO  # noqa: E402
from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.llm import serving as JS  # noqa: E402
from agilerl_tpu.observability import MetricsRegistry as JRegistry  # noqa: E402
from agilerl_tpu_torch.algorithms import grpo as TGRPO  # noqa: E402
from agilerl_tpu_torch.llm import generate as TG, model as TM, serving as TS  # noqa: E402
from agilerl_tpu_torch.llm.convert import params_from_numpy  # noqa: E402
from agilerl_tpu_torch.observability import MetricsRegistry as TRegistry  # noqa: E402

JG = importlib.import_module("agilerl_tpu.llm.generate")
torch.set_num_threads(1)

VOCAB = 96
KW = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq_len=256)
JCFG = JM.GPTConfig(dtype=jnp.float32, **KW)
TCFG = TM.GPTConfig(dtype=torch.float32, **KW)


@pytest.fixture(scope="module")
def weights():
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(0), JCFG))
    # wider weights give decisive, varied argmaxes
    params = jax.tree_util.tree_map(lambda x: x * 12.0 if x.ndim == 2 else x, params)
    return params, params_from_numpy(params, TCFG, device="cpu")


def _ragged(rng, n, lo, hi):
    return [rng.integers(3, 95, size=rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]


def _dense(tparams, seqs, Pb, max_new, eos_id):
    toks, mask = TG.left_pad(seqs, 0, Pb)
    comp, cmask = TG.generate(TCFG, tparams, torch.as_tensor(toks), torch.as_tensor(mask), None,
                              max_new_tokens=max_new, temperature=0.0, eos_id=eos_id)
    return comp.numpy(), cmask.numpy()


def _eos(weights, seqs, max_new):
    """An EOS the model really emits early on, so rows stop inside a chunk."""
    comp, _ = _dense(weights[1], seqs, 32, max_new, None)
    return int(comp[0, 2])


# --------------------------------------------------------------------------- #
# BucketedGenerator
# --------------------------------------------------------------------------- #

BUCKETED = dict(max_new_tokens=12, pad_id=0, prompt_buckets=(16, 32, 48),
                row_buckets=(4, 8, 16), decode_chunk=4, temperature=0.7, top_k=20)


def _bucketed_sweep(rng):
    first = _ragged(rng, 7, 4, 28)
    # the last batch repeats the row whose third token is the EOS: every
    # row stops in the first chunk
    return [first, _ragged(rng, 3, 4, 12), _ragged(rng, 10, 20, 40),
            _ragged(rng, 7, 4, 28), [first[0]] * 3]


@pytest.fixture(scope="module")
def bucketed_runs(weights):
    params, tparams = weights
    batches = _bucketed_sweep(np.random.default_rng(0))
    eos = _eos(weights, batches[0], 12)
    jgen = JS.BucketedGenerator(JCFG, eos_id=eos, metrics=JRegistry(), **BUCKETED)
    tgen = TS.BucketedGenerator(TCFG, eos_id=eos, metrics=TRegistry(), device="cpu", **BUCKETED)
    runs = []
    for i, seqs in enumerate(batches):
        j = jgen.generate(seqs, jax.random.PRNGKey(i), params, greedy=True)
        t = tgen.generate(seqs, None, tparams, greedy=True)
        runs.append((seqs, j, t))
    return dict(eos=eos, runs=runs, jgen=jgen, tgen=tgen)


def test_bucketed_greedy_matches_jax_and_dense(weights, bucketed_runs):
    eos = bucketed_runs["eos"]
    stopped_early = False
    for seqs, (jc, jm, jinfo), (tc, tm, tinfo) in bucketed_runs["runs"]:
        np.testing.assert_array_equal(tc, np.asarray(jc))
        np.testing.assert_array_equal(tm, np.asarray(jm))
        for k in ("prompt_bucket", "row_bucket", "decode_steps", "max_new_tokens"):
            assert tinfo[k] == jinfo[k], k
        dc, dm = _dense(weights[1], seqs, tinfo["prompt_bucket"], 12, eos)
        np.testing.assert_array_equal(tc, dc)
        np.testing.assert_array_equal(tm, dm)
        stopped_early |= tinfo["decode_steps"] < 12
    assert stopped_early  # some batch exited inside its chunk budget


def test_bucketed_compiled_programs_match_jax(bucketed_runs):
    t, j = bucketed_runs["tgen"], bucketed_runs["jgen"]
    assert t.compiled_programs == j.compiled_programs > 0
    assert t.compiled_programs <= 2 * 3 * 3  # (prefill + decode) x the grid used


def test_bucketed_sampled_shapes_and_fits():
    tgen = TS.BucketedGenerator(TCFG, eos_id=5, metrics=TRegistry(), device="cpu", **BUCKETED)
    params = TM.init_params(0, TCFG, device="cpu")
    seqs = _ragged(np.random.default_rng(1), 5, 4, 20)
    comp, mask, info = tgen.generate(seqs, 3, params)
    again, _, _ = tgen.generate(seqs, torch.Generator().manual_seed(3), params)
    assert comp.shape == mask.shape == (5, 12) and comp.dtype == np.int32
    np.testing.assert_array_equal(comp, again)  # one seed, one stream
    assert ((comp >= 0) & (comp < VOCAB)).all()
    assert not tgen.fits(17, 10) and not tgen.fits(3, 49) and tgen.fits(16, 48)
    with pytest.raises(ValueError, match="bucket grid"):
        tgen.generate([np.arange(1, 50)], 0, params)
    with pytest.raises(ValueError, match="needs a key"):
        tgen.generate(seqs, None, params)


# --------------------------------------------------------------------------- #
# ContinuousGenerator
# --------------------------------------------------------------------------- #

CONT = dict(max_new_tokens=8, pad_id=0, prompt_buckets=(16, 32), slots=3, block_size=8,
            decode_chunk=4, n_blocks=40)


def _continuous_sweep(rng):
    """More requests than slots, two buckets, repeated prompts (prefix hits)
    and a shuffled repeat wave."""
    base = _ragged(rng, 5, 4, 30)
    waves = [base + base[:3], _ragged(rng, 4, 4, 30)]
    order = rng.permutation(len(base))
    waves.append([base[i] for i in order] + [base[1]])
    return waves


@pytest.fixture(scope="module")
def continuous_runs(weights):
    params, tparams = weights
    waves = _continuous_sweep(np.random.default_rng(2))
    eos = _eos(weights, waves[0], 8)
    jgen = JS.ContinuousGenerator(JCFG, eos_id=eos, metrics=JRegistry(), **CONT)
    tgen = TS.ContinuousGenerator(TCFG, eos_id=eos, metrics=TRegistry(), device="cpu", **CONT)
    runs = []
    for i, seqs in enumerate(waves):
        j = jgen.generate(seqs, jax.random.PRNGKey(i), params, greedy=True)
        t = tgen.generate(seqs, i, tparams, greedy=True)
        runs.append((seqs, j, t))
    return dict(eos=eos, runs=runs, jgen=jgen, tgen=tgen)


def test_continuous_greedy_matches_jax_and_dense(weights, continuous_runs):
    eos = continuous_runs["eos"]
    hits = 0
    for seqs, (jc, jm, jinfo), (tc, tm, tinfo) in continuous_runs["runs"]:
        np.testing.assert_array_equal(tc, np.asarray(jc))
        np.testing.assert_array_equal(tm, np.asarray(jm))
        for k in ("prefix_cache_hits", "free_blocks", "compiled_programs", "slots"):
            assert tinfo[k] == jinfo[k], k
        hits += tinfo["prefix_cache_hits"]
        # dense generate at each row's own bucket
        for Pb in (16, 32):
            rows = [i for i, s in enumerate(seqs) if TS._round_up(len(s), (16, 32)) == Pb]
            if rows:
                dc, dm = _dense(weights[1], [seqs[i] for i in rows], Pb, 8, eos)
                np.testing.assert_array_equal(tc[rows], dc)
                np.testing.assert_array_equal(tm[rows], dm)
    assert hits >= 3
    assert (continuous_runs["runs"][0][2][1].sum(1) < 8).any()  # EOS inside a chunk


def test_continuous_blocks_freed_and_programs_bounded(continuous_runs):
    t, j = continuous_runs["tgen"], continuous_runs["jgen"]
    # every slot drained: the cached prompt blocks are evictable, nothing
    # is held
    assert t.allocator.available() == j.allocator.available() == CONT["n_blocks"] - 1
    assert t.allocator.free_blocks == j.allocator.free_blocks
    assert t.compiled_programs == j.compiled_programs
    # prefill per bucket + decode + block copy
    assert t.compiled_programs <= 2 + 1 + 1


def test_continuous_exactly_sized_pool_matches_jax(weights):
    """The default, exactly provisioned pool: repeats evict cached blocks
    (served as misses), in both packages alike."""
    params, tparams = weights
    seqs = _ragged(np.random.default_rng(3), 4, 4, 30)
    seqs = seqs + seqs[:2]
    kw = dict(CONT, n_blocks=None)
    j = JS.ContinuousGenerator(JCFG, metrics=JRegistry(), **kw).generate(
        seqs, jax.random.PRNGKey(0), params, greedy=True)
    t = TS.ContinuousGenerator(TCFG, metrics=TRegistry(), device="cpu", **kw).generate(
        seqs, 0, tparams, greedy=True)
    np.testing.assert_array_equal(t[0], np.asarray(j[0]))
    assert t[2]["prefix_cache_hits"] == j[2]["prefix_cache_hits"]
    assert t[2]["free_blocks"] == j[2]["free_blocks"]


def test_admission_sheds_with_the_same_reasons():
    rng = np.random.default_rng(4)
    seqs = _ragged(rng, 6, 4, 30)

    def run(mod, cfg, **extra):
        reg = (JRegistry if mod is JS else TRegistry)()
        gen = mod.ContinuousGenerator(cfg, metrics=reg, max_queue=3, **dict(CONT, **extra))
        tickets = [gen.submit(s) for s in seqs]
        tickets.append(gen.submit(seqs[0], no_shed=True))
        return (tickets, gen.admission_reason(),
                reg.counter("serving/shed_requests_total").value)

    assert run(TS, TCFG, device="cpu") == run(JS, JCFG)
    # the free-block watermark: a pool that can never meet it sheds at once
    assert (run(TS, TCFG, device="cpu", free_block_watermark=1.0)
            == run(JS, JCFG, free_block_watermark=1.0))
    with pytest.raises(ValueError, match="outside the bucket grid"):
        TS.ContinuousGenerator(TCFG, device="cpu", **CONT).submit(np.arange(1, 40))


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + "/")
    return out


def test_latency_summary_has_the_same_keys(bucketed_runs, continuous_runs):
    for name in ("bucketed_runs", "continuous_runs"):
        runs = bucketed_runs if name == "bucketed_runs" else continuous_runs
        t, j = runs["tgen"].latency_summary(), runs["jgen"].latency_summary()
        assert _keys(t) == _keys(j), name
        assert t["rows_total"] == j["rows_total"]
        assert t["ttft_s"]["count"] == j["ttft_s"]["count"] > 0
    t = continuous_runs["tgen"].latency_summary()
    j = continuous_runs["jgen"].latency_summary()
    for k in ("tokens_decoded_total", "prefix_cache_hits_total", "requests_total"):
        assert t[k] == j[k], k


def test_serving_raises_on_unported_options(weights):
    """``compile_cache=`` still raises (the port runs eagerly); a sharding
    plan or a mesh (they raised before the sharding plans were ported) now
    serve: weights placed by the plan give the unplaced greedy tokens."""
    from agilerl_tpu_torch.parallel.plan import make_grpo_plan
    from tests.torch_dist_harness import single_rank

    with pytest.raises(NotImplementedError):
        TS.ContinuousGenerator(TCFG, device="cpu", **CONT, compile_cache=object())
    _, tparams = weights
    seqs = _ragged(np.random.default_rng(4), 4, 4, 14)
    want = TS.ContinuousGenerator(TCFG, device="cpu", **CONT).generate(seqs, 0, tparams,
                                                                       greedy=True)[0]
    with single_rank():
        mesh = make_grpo_plan().build_mesh("cpu")
        for kw in (dict(sharding_plan=make_grpo_plan()), dict(mesh=mesh)):
            gen = TS.ContinuousGenerator(TCFG, device="cpu", **CONT, **kw)
            placed = gen.place_params(tparams)
            assert (gen.sharding_plan is None) == ("mesh" in kw)
            np.testing.assert_array_equal(gen.generate(seqs, 0, placed, greedy=True)[0], want)
        gen = TS.BucketedGenerator(TCFG, device="cpu", mesh=mesh)
        assert gen.mesh is mesh and gen.place_params(tparams) is tparams


# --------------------------------------------------------------------------- #
# GRPO routing
# --------------------------------------------------------------------------- #

GRPO_KW = dict(pad_token_id=0, eos_token_id=None, group_size=2, max_output_tokens=6,
               batch_size=4, seed=0, lora_rank=2)


def _prompts(rng, lens=(5, 11), P=12):
    ids = np.zeros((len(lens), P), np.int32)
    mask = np.zeros((len(lens), P), np.int32)
    for i, n in enumerate(lens):
        ids[i, P - n:] = rng.integers(3, 95, size=n)
        mask[i, P - n:] = 1
    return {"input_ids": ids, "attention_mask": mask}


@pytest.fixture(scope="module")
def jax_generation_info(weights):
    """The reference's last_generation_info keys on its serving routes."""
    prompts = _prompts(np.random.default_rng(5))
    out = {}
    for route, kw in (("bucketed", {}), ("continuous", dict(continuous_decode=True)),
                      ("capture", dict(continuous_decode=True, speculative_decode=True,
                                       capture_logprobs=True))):
        agent = JGRPO.GRPO(config=JCFG, base_params=jax.tree_util.tree_map(
            jnp.asarray, weights[0]), **GRPO_KW, **kw)
        agent.get_action(prompts)
        out[route] = set(agent.last_generation_info)
    return out


def _agent(weights, **kw):
    return TGRPO.GRPO(config=TCFG, base_params=weights[1], device="cpu", **GRPO_KW, **kw)


@pytest.mark.parametrize("route,kw,env", [
    ("bucketed", {}, {}),
    ("capture", dict(continuous_decode=True, speculative_decode=True,
                     capture_logprobs=True), {}),
    ("continuous", {}, {"AGILERL_TPU_CONTINUOUS_DECODE": "1"}),
    ("dense", {}, {"AGILERL_TPU_DISABLE_BUCKETED_DECODE": "1"}),
    ("dense", dict(continuous_decode=True), {"AGILERL_TPU_DISABLE_BUCKETED_DECODE": "yes"}),
])
def test_grpo_routes_like_the_reference(weights, jax_generation_info, monkeypatch,
                                        route, kw, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    agent = _agent(weights, **kw)
    prompts = _prompts(np.random.default_rng(5))
    comp, cmask = agent.get_action(prompts)
    assert comp.shape == cmask.shape == (4, 6) and comp.dtype == np.int32
    info = agent.last_generation_info
    if route == "dense":
        assert info is None
        assert not agent.bucketed_decode and not agent.continuous_decode
    else:
        assert set(info) == jax_generation_info[route]
        gen = agent._bucketed_gen if route == "bucketed" else agent._continuous_gen
        assert gen is not None and gen.dev == torch.device("cpu")
    # greedy evaluation routes the same way and matches dense greedy
    greedy, _ = agent.get_action(prompts, training=False)
    seqs = [r[m.astype(bool)] for r, m in zip(prompts["input_ids"], prompts["attention_mask"])]
    np.testing.assert_array_equal(greedy, _dense(weights[1], seqs, 12, 6, None)[0])


def test_grpo_falls_back_to_dense_on_overflow_and_all_pad_rows(weights):
    """A prompt longer than the largest bucket takes the dense path on both
    serving routes (and clears the telemetry), as does an all-pad row on
    the continuous one."""
    rng = np.random.default_rng(6)
    for continuous in (False, True):
        agent = _agent(weights, continuous_decode=continuous)
        agent.get_action(_prompts(rng))
        assert agent.last_generation_info is not None
        gen = agent._continuous_gen if continuous else agent._bucketed_gen
        too_long = gen.prompt_buckets[-1] + 5
        assert not gen.fits(2, too_long)
        ids = rng.integers(3, 95, size=(1, too_long)).astype(np.int32)
        comp, cmask = agent.get_action({"input_ids": ids, "attention_mask": np.ones_like(ids)})
        assert comp.shape == cmask.shape == (2, 6)
        assert agent.last_generation_info is None
    agent.get_action(_prompts(rng, lens=(5, 0)))
    assert agent.last_generation_info is None


def test_learn_between_rollouts_invalidates_the_prefix_cache(weights):
    """GRPO's optimizer returns a new adapter tree per learn: the continuous
    generator sees a new weight epoch and flushes its cached prompt blocks."""
    agent = _agent(weights, continuous_decode=True)
    prompts = _prompts(np.random.default_rng(7))
    comp, cmask = agent.get_action(prompts)
    gen = agent._continuous_gen
    assert agent.last_generation_info["prefix_cache_hits"] == 2  # group repeats
    lora_before = agent.actor.params
    ids = np.concatenate([np.repeat(prompts["input_ids"], 2, 0), comp], 1)
    attn = np.concatenate([np.repeat(prompts["attention_mask"], 2, 0), cmask], 1)
    action = np.zeros((4, ids.shape[1] - 1), np.float32)
    action[:, 11:] = cmask
    agent.learn((ids, action, np.asarray([[1.0, 0.0], [0.0, 1.0]], np.float32), attn))
    assert agent.actor.params is not lora_before
    flushes = gen.metrics.counter("serving/prefix_cache_invalidations_total")
    before = flushes.value
    agent.get_action(prompts)
    assert flushes.value == before + 1
    assert agent.last_generation_info["prefix_cache_hits"] == 2  # re-prefilled, then hit
    agent.get_action(prompts)  # same weights: no flush
    assert flushes.value == before + 1


# --------------------------------------------------------------------------- #
# disaggregated import, telemetry
# --------------------------------------------------------------------------- #


def test_submit_prefilled_import_matches_local_prefill(weights):
    """A prompt prefilled elsewhere (a dense prefill at the generator's
    bucket and decode extent) and imported through submit_prefilled decodes
    the local prefill's tokens, and its blocks enter the prefix cache."""
    tparams = weights[1]
    seqs = _ragged(np.random.default_rng(8), 2, 4, 30)
    kw = dict(CONT, eos_id=None)
    local = TS.ContinuousGenerator(TCFG, metrics=TRegistry(), device="cpu", **kw)
    want, _, _ = local.generate(seqs, 3, tparams, greedy=True)
    gen = TS.ContinuousGenerator(TCFG, metrics=TRegistry(), device="cpu", **kw)
    tickets = []
    for i, s in enumerate(seqs):
        key = TG.fold_in(TG.request_key(3), i)
        Pb = TS._round_up(len(s), CONT["prompt_buckets"])
        toks, mask = TG.left_pad([s], 0, Pb)
        cache = TM.init_caches(TCFG, 1, Pb + gen._decode_extent, device="cpu")
        (filled, tok0, _, _, done0, key_next), _ = TG.prefill_head(
            TCFG, tparams, torch.as_tensor(toks), torch.as_tensor(mask), cache,
            torch.as_tensor(key)[None], **TS._sampling_knobs(gen, True, None))
        tickets.append(gen.submit_prefilled(
            s, k_prompt=filled.k[:, 0, :Pb].numpy(), v_prompt=filled.v[:, 0, :Pb].numpy(),
            tok0=int(tok0[0]), done0=bool(done0[0]), key_next=key_next[0].numpy(), key=key,
            no_shed=True))
    gen.run_until_drained(tparams, greedy=True)
    for i, t in enumerate(tickets):
        np.testing.assert_array_equal(gen.result(t)[0], want[i])
    assert gen.metrics.counter("serving/prefilled_imports_total").value == 2
    comp, _, info = gen.generate(seqs[:1], 3, tparams, greedy=True)
    assert info["prefix_cache_hits"] == 1
    np.testing.assert_array_equal(comp[0], want[0])
    with pytest.raises(ValueError, match="ORIGINAL request key"):
        gen.submit_prefilled(seqs[0], k_prompt=np.zeros((2, 16, 2, 8)),
                             v_prompt=np.zeros((2, 16, 2, 8)), tok0=1, done0=False,
                             key_next=[0, 1])


def test_registry_and_tracer_match_jax():
    """The observability port: the same observations give the same
    summaries, dumps and Prometheus text; the same spans give records with
    the same fields; a traced generator emits its request and admit spans."""
    from agilerl_tpu.observability import MemorySink, Tracer as JTracer
    from agilerl_tpu_torch.observability import Tracer as TTracer

    regs = (TRegistry(), JRegistry())
    for reg in regs:
        h = reg.histogram("serving/ttft_s", buckets=TS.TTFT_BUCKETS)
        for v in (0.003, 0.02, 0.2, 0.7, 3.0, 200.0):
            h.observe(v)
        reg.counter("serving/rows_total").inc(3)
        reg.gauge("serving/free_blocks").set(7)
    t, j = regs
    assert t.snapshot() == j.snapshot()
    assert t.dump() == j.dump()
    assert t.prometheus_text() == j.prometheus_text()
    records = []
    for cls in (TTracer, JTracer):
        sink = MemorySink()
        tr = cls(sink=sink, pod="p", clock=iter(range(100)).__next__)
        with tr.span("outer", a=1):
            tr.start_span("inner", attributes={"b": 2}).set_error("x").end()
        records.append([{k: v for k, v in e.items() if k not in ("seq", "ts", "trace_id",
                                                                  "span_id", "parent_id")}
                        for e in sink.events])
    assert records[0] == records[1]
    sink = MemorySink()
    gen = TS.ContinuousGenerator(TCFG, metrics=TRegistry(), device="cpu",
                                 tracer=TTracer(sink=sink), **CONT)
    gen.generate(_ragged(np.random.default_rng(9), 2, 4, 30), 0,
                 TM.init_params(0, TCFG, device="cpu"), greedy=True)
    spans = {e["name"]: [] for e in sink.events}
    for e in sink.events:
        spans[e["name"]].append(e)
    assert sorted((k, len(v)) for k, v in spans.items()) == [("serving.admit", 2),
                                                             ("serving.request", 2)]
    # each admission hop parents onto its request's root span
    assert ({e["parent_id"] for e in spans["serving.admit"]}
            == {e["span_id"] for e in spans["serving.request"]})
    assert all(e["attributes"]["tokens_emitted"] == CONT["max_new_tokens"]
               for e in spans["serving.request"])
