"""Parity of the port's serving fleet (agilerl_tpu_torch.llm.router, .fleet,
.autoscale and GRPO.attach_rollout_fleet) with the JAX package's, on the
CPU. Greedy tokens are compared exactly (f32): the unified and the
disaggregated fleet, a fleet after kill_replica and after a lease expiry,
each against the JAX ServingFleet's rows and against one port
ContinuousGenerator. Router and autoscaler decisions are compared on the
same inputs; the failover, shed and transfer counters on the same traffic.
Each test imports the JAX modules it compares with inside the test."""

import pickle

import numpy as np
import pytest
import torch

from agilerl_tpu_torch.llm import fleet as TF, generate as TG, model as TM, serving as TS
from agilerl_tpu_torch.llm.autoscale import AutoscalePolicy as TPolicy
from agilerl_tpu_torch.llm.convert import params_from_numpy, tensor_from_host, tensor_to_host
from agilerl_tpu_torch.llm.router import FleetRouter as TRouter
from agilerl_tpu_torch.observability import MemorySink as TSink, MetricsRegistry as TRegistry

torch.set_num_threads(1)

VOCAB = 96
MODEL = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq_len=128)
TCFG = TM.GPTConfig(dtype=torch.float32, **MODEL)
KW = dict(max_new_tokens=8, pad_id=0, eos_id=None, prompt_buckets=(32,), slots=3,
          block_size=8, decode_chunk=4)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from agilerl_tpu.llm import model as JM

    return jax, jnp, JM


@pytest.fixture(scope="module")
def weights():
    jax, jnp, JM = _jax()
    jcfg = JM.GPTConfig(dtype=jnp.float32, **MODEL)
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    # wider weights give decisive, varied argmaxes
    params = jax.tree_util.tree_map(lambda x: x * 12.0 if x.ndim == 2 else x, params)
    return jcfg, params, params_from_numpy(params, TCFG, device="cpu")


def _trace(seed, n=8, repeat_every=3):
    """Ragged prompts with periodic repeats (the prefix-affinity case)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(3, 95, size=12).astype(np.int32)
    return [base if i % repeat_every == repeat_every - 1
            else rng.integers(3, 95, size=int(rng.integers(4, 28))).astype(np.int32)
            for i in range(n)]


class _Pkg:
    """One package's fleet pieces behind a common surface, so every scenario
    runs the same code on the JAX package and on the port."""

    def __init__(self, name, weights):
        self.name = name
        if name == "jax":
            jax, jnp, _ = _jax()
            from agilerl_tpu.llm import fleet, serving
            from agilerl_tpu.observability import MetricsRegistry

            self.cfg, self.params = weights[0], jax.tree_util.tree_map(jnp.asarray, weights[1])
            self.fleet_mod, self.serving, self.Registry = fleet, serving, MetricsRegistry
            self.key = lambda i: jax.random.fold_in(jax.random.PRNGKey(1), i)
            self.base_key = jax.random.PRNGKey(1)
            self.dev = {}
        else:
            self.cfg, self.params = TCFG, weights[2]
            self.fleet_mod, self.serving, self.Registry = TF, TS, TRegistry
            self.key = lambda i: TG.fold_in(TG.request_key(1), i)
            self.base_key = 1
            self.dev = {"device": "cpu"}

    def fleet(self, n=2, **over):
        return self.fleet_mod.ServingFleet(self.cfg, n, metrics=self.Registry(),
                                           **self.dev, **dict(KW, **over))

    def single(self, seqs):
        gen = self.serving.ContinuousGenerator(self.cfg, metrics=self.Registry(), **self.dev,
                                               **KW)
        return gen.generate(seqs, self.base_key, self.params, greedy=True)

    def submit_all(self, fleet, seqs):
        return [fleet.submit(s, key=self.key(i), no_shed=True) for i, s in enumerate(seqs)]

    def results(self, fleet, tickets):
        out = [fleet.result(t) for t in tickets]
        return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def _scenarios(pkg, tmp):
    """Every fleet scenario the two packages are held to, on one package."""
    out = {}
    seqs = _trace(3, n=10)
    out["single"] = pkg.single(seqs)[:2]
    fl = pkg.fleet()
    comp, cmask, info = fl.generate(seqs, pkg.base_key, pkg.params, greedy=True)
    out["unified"] = (comp, cmask)
    out["unified_info"] = {k: info[k] for k in ("replicas", "affinity_hits", "max_new_tokens")}
    out["unified_programs"] = fl.compiled_programs
    out["unified_free"] = [m.gen.allocator.available() for m in fl._serving_members().values()]

    fl = pkg.fleet()
    tickets = pkg.submit_all(fl, seqs)
    fl.step(pkg.params, greedy=True)
    fl.kill_replica(fl.replica_ids[0])
    fl.run_until_drained(pkg.params, greedy=True)
    out["kill"] = pkg.results(fl, tickets)
    out["kill_counters"] = {k: fl.latency_summary()["fleet"][k] for k in (
        "rebalanced_requests_total", "replicas_lost_total", "replica_count")}

    clock = FakeClock()
    fl = pkg.fleet(membership_dir=tmp / f"hb_{pkg.name}", lease_timeout=5.0, clock=clock)
    out["roles"] = fl.heartbeats.roles()
    tickets = pkg.submit_all(fl, seqs)
    fl.step(pkg.params, greedy=True)
    victim = fl.replica_ids[0]
    fl.kill_replica(victim)
    fl.step(pkg.params, greedy=True)
    out["lease_undetected"] = victim in fl.replica_ids
    clock.advance(6.0)
    fl.step(pkg.params, greedy=True)
    out["lease_detected"] = victim not in fl.replica_ids
    fl.run_until_drained(pkg.params, greedy=True)
    out["lease"] = pkg.results(fl, tickets)
    out["lease_counters"] = {k: fl.metrics.counter(k).value for k in (
        "fleet/rebalanced_requests_total", "fleet/replicas_lost_total")}

    fl = pkg.fleet(topology="disaggregated", n_prefill=1, transfer_dir=tmp / f"x_{pkg.name}")
    comp, cmask, _ = fl.generate(seqs, pkg.base_key, pkg.params, greedy=True)
    out["disagg"] = (comp, cmask)
    reg = fl.metrics
    out["disagg_counters"] = {k: reg.counter(k).value for k in (
        "fleet/kv_transfers_total", "fleet/kv_imports_total", "fleet/torn_kv_transfers_total")}
    # a warm repeat of a transferred chain skips the worker
    before = reg.counter("fleet/kv_transfers_total").value
    t = fl.submit(seqs[2], key=pkg.key(2), no_shed=True)
    fl.run_until_drained(pkg.params, greedy=True)
    out["warm_transfers"] = reg.counter("fleet/kv_transfers_total").value - before
    out["warm_row"] = fl.result(t)

    fl = pkg.fleet(n=1)
    park_seqs = seqs[:4]
    tickets = pkg.submit_all(fl, park_seqs)
    fl.kill_replica(fl.replica_ids[0])
    out["parked_ids"] = list(fl.replica_ids)
    fl.scale_up()
    fl.run_until_drained(pkg.params, greedy=True)
    out["park"] = pkg.results(fl, tickets)
    return out


@pytest.fixture(scope="module")
def scenarios(weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fleet")
    return {name: _scenarios(_Pkg(name, weights), tmp) for name in ("jax", "torch")}


@pytest.mark.parametrize("scenario", ["unified", "kill", "lease", "disagg", "park"])
def test_fleet_greedy_tokens_match_jax_and_one_generator(scenarios, scenario):
    """Every fleet topology and failure gives the JAX fleet's greedy rows and
    one port ContinuousGenerator's, token for token (f32, exact)."""
    t, j = scenarios["torch"], scenarios["jax"]
    n = len(t[scenario][0])
    for got, ref in ((t[scenario], j[scenario]), (t[scenario], t["single"])):
        np.testing.assert_array_equal(got[0], np.asarray(ref[0])[:n])
        np.testing.assert_array_equal(got[1], np.asarray(ref[1])[:n])


def test_fleet_counters_match_jax(scenarios):
    """Affinity hits, failover, lease detection, transfers and the warm
    repeat count the same on both packages."""
    t, j = scenarios["torch"], scenarios["jax"]
    for key in ("unified_info", "kill_counters", "lease_counters", "disagg_counters",
                "warm_transfers", "roles", "lease_undetected", "lease_detected",
                "parked_ids"):
        assert t[key] == j[key], key
    assert t["lease_undetected"] and t["lease_detected"] and t["parked_ids"] == []
    assert t["kill_counters"]["rebalanced_requests_total"] > 0
    assert t["disagg_counters"]["fleet/kv_transfers_total"] > 0
    assert t["warm_transfers"] == 0
    np.testing.assert_array_equal(t["warm_row"][0], t["single"][0][2])


def test_fleet_programs_bounded_and_blocks_freed(scenarios, weights):
    """The fleet's program set is bounded by replicas x the bucket grid; every
    block is free after draining. The JAX count reads jit caches, and its
    block-copy program's cache is shared by every generator, so a replica
    that never copied a block counts it there: the port counts what each
    replica ran, one fewer here."""
    t, j = scenarios["torch"], scenarios["jax"]
    assert 0 < t["unified_programs"] == j["unified_programs"] - 1 <= 2 * 4
    fl = _Pkg("torch", weights).fleet()
    cache_free = fl._grid_ref().allocator.available()
    assert t["unified_free"] == [cache_free, cache_free]
    rng = np.random.default_rng(11)
    warm = _trace(12, n=8)
    fl.generate(warm, 0, weights[2], greedy=True)
    first = fl.compiled_programs
    for wave in range(2):
        seqs = [warm[i] for i in rng.permutation(len(warm))] + _trace(13 + wave, n=4)
        fl.generate(seqs, wave + 1, weights[2], greedy=True)
    assert fl.compiled_programs <= first + 2 <= 2 * 4


def test_router_decisions_match_jax():
    """The same route / record / forget sequence over the same hash chains
    and loads gives the JAX FleetRouter's decisions, LRU bound included."""
    from agilerl_tpu.llm.router import FleetRouter as JRouter
    from agilerl_tpu.observability import MetricsRegistry as JRegistry

    rng = np.random.default_rng(0)
    chains = [[bytes(rng.integers(0, 256, 8, dtype=np.uint8)) for _ in range(int(n))]
              for n in rng.integers(1, 4, 12)]
    chains[5] = chains[2][:-1] + [chains[7][-1]]  # same tail, different prefix
    routers = (TRouter(metrics=TRegistry(), max_entries=6),
               JRouter(metrics=JRegistry(), max_entries=6))
    logs = ([], [])
    for step in range(80):
        chain = chains[int(rng.integers(len(chains)))]
        loads = {r: float(rng.integers(0, 4)) for r in range(3) if rng.random() < 0.8} or {0: 0.0}
        forget = int(rng.integers(3)) if step % 17 == 16 else None
        for router, log in zip(routers, logs):
            rid, hit = router.route(chain, loads)
            router.record(chain, rid)
            log.append((rid, hit, router.owner_of(chain), router.entries,
                        router.forget_replica(forget) if forget is not None else None))
    assert logs[0] == logs[1]
    assert any(entry[1] for entry in logs[0]) and any(not entry[1] for entry in logs[0])
    assert max(entry[3] for entry in logs[0]) == 6
    with pytest.raises(ValueError, match="at least one candidate"):
        routers[0].route(chains[0], {})


def test_router_shed_counted_once_and_survivorless_park(weights):
    """Flooding a fleet sheds at the router, once per dropped request, and
    the JAX fleet drops the same requests; replicas count no sheds."""
    outcomes = {}
    for name in ("jax", "torch"):
        pkg = _Pkg(name, weights)
        fl = pkg.fleet(slots=1, max_queue=1)
        tickets = [fl.submit(s, key=pkg.key(i)) for i, s in enumerate(_trace(10, n=10, repeat_every=99))]
        summary = fl.latency_summary()["fleet"]
        outcomes[name] = [t is None for t in tickets]
        assert summary["shed_requests_total"] == sum(outcomes[name]) > 0
        for m in fl._serving_members().values():
            assert m.gen.metrics.counter("serving/shed_requests_total").value == 0
        fl.run_until_drained(pkg.params, greedy=True)
    assert outcomes["torch"] == outcomes["jax"]


def test_torn_kv_transfer_skipped_and_recomputed(weights, tmp_path):
    """A corrupted transfer is skipped (counted), never loaded, and the
    request recomputes from its tokens: the single generator's rows."""
    pkg = _Pkg("torch", weights)
    seqs = _trace(8, n=3, repeat_every=99)
    want = pkg.single(seqs)
    fl = pkg.fleet(topology="disaggregated", n_prefill=1, transfer_dir=tmp_path / "x")
    tickets = pkg.submit_all(fl, seqs)
    fl._step_prefill(pkg.params, None, True)
    payload = fl._transfers[0].transfer / "payload.pkl"
    payload.write_bytes(payload.read_bytes()[:-7] + b"garbage")
    fl.run_until_drained(pkg.params, greedy=True)
    assert fl.metrics.counter("fleet/torn_kv_transfers_total").value == 1
    comp, cmask = pkg.results(fl, tickets)
    np.testing.assert_array_equal(comp, want[0])
    np.testing.assert_array_equal(cmask, want[1])


def test_bf16_kv_transfer_round_trip_bit_for_bit(tmp_path):
    """A bf16 prompt KV crosses the transfer store as host numpy (its uint16
    bit pattern) and comes back bit for bit, special values included; a
    bf16 disaggregated fleet decodes the unified fleet's tokens."""
    g = torch.Generator().manual_seed(0)
    k = (torch.randn(2, 32, 2, 8, generator=g) * 100).to(torch.bfloat16)
    k.view(-1)[:4] = torch.tensor([float("inf"), float("-inf"), 1e-40, -0.0]).to(torch.bfloat16)
    host, dtype = tensor_to_host(k)
    assert host.dtype == np.uint16 and dtype == "bfloat16"
    store = TF.KVTransferStore(tmp_path / "x", metrics=TRegistry())
    path = store.export("transfer_000001", {"k": host, "hashes": [b"\x01"]})
    back = tensor_from_host(store.load(path)["k"], dtype, "cpu")
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), k.view(torch.int16))
    # the payload unpickles with numpy alone (no tensor inside)
    raw = pickle.loads((path / "payload.pkl").read_bytes())
    assert type(raw["k"]) is np.ndarray

    cfg = TM.GPTConfig(dtype=torch.bfloat16, **MODEL)
    params = TM.init_params(0, cfg, device="cpu")
    seqs = _trace(9, n=5)
    rows = []
    for over in ({}, dict(topology="disaggregated", transfer_dir=tmp_path / "bf")):
        fl = TF.ServingFleet(cfg, 2, metrics=TRegistry(), device="cpu", **dict(KW, **over))
        rows.append(fl.generate(seqs, 4, params, greedy=True)[0])
    assert fl.metrics.counter("fleet/kv_imports_total").value > 0
    np.testing.assert_array_equal(rows[0], rows[1])


def test_fleet_sampled_stream_equals_one_generator(weights):
    """Sampled decoding through the fleet draws what one generator draws for
    the same key (the per-row fold and counter keys carry over), and the
    telemetry keys match the JAX fleet's."""
    pkg = _Pkg("torch", weights)
    seqs = _trace(15, n=7)
    gen = TS.ContinuousGenerator(TCFG, metrics=TRegistry(), device="cpu",
                                 **dict(KW, temperature=0.9, top_k=20))
    want = gen.generate(seqs, 7, pkg.params)[0]
    fl = pkg.fleet(temperature=0.9, top_k=20)
    np.testing.assert_array_equal(fl.generate(seqs, 7, pkg.params)[0], want)
    jfl = _Pkg("jax", weights).fleet()
    assert set(fl.slo_signals()) == set(jfl.slo_signals())
    assert set(fl.latency_summary()["fleet"]) == set(jfl.latency_summary()["fleet"])
    assert set(fl.merged_dump()) == set(jfl.merged_dump())


def test_fleet_raises_on_unported_options(weights):
    pkg = _Pkg("torch", weights)
    with pytest.raises(NotImplementedError, match="sharding_plan"):
        TF.ServingFleet(TCFG, 1, sharding_plan=object(), device="cpu", **KW)
    fl = pkg.fleet(n=1)
    for plan in ("auto", object()):
        with pytest.raises(NotImplementedError, match="plan"):
            fl.scale_up(plan=plan)
    with pytest.raises(ValueError, match="transfer_dir"):
        pkg.fleet(topology="disaggregated")
    with pytest.raises(ValueError, match="last serving replica"):
        fl.scale_down(fl.replica_ids[0])


# --------------------------------------------------------------------------- #
# autoscaler
# --------------------------------------------------------------------------- #


class FakeFleet:
    def __init__(self):
        self.signals = {"replicas": 1, "mean_backlog": 0.0, "max_backlog": 0.0,
                        "fleet_backlog": 0.0, "p95_ttft_s": None, "shed_total": 0.0}
        self.actions = []

    def slo_signals(self):
        return dict(self.signals)

    def scale_up(self):
        self.signals["replicas"] += 1
        self.actions.append("up")
        return self.signals["replicas"] - 1

    def least_loaded_replica(self):
        return self.signals["replicas"] - 1 if self.signals["replicas"] > 1 else None

    def scale_down(self, rid):
        self.signals["replicas"] -= 1
        self.actions.append(("down", rid))


def test_autoscale_decide_and_apply_match_jax():
    """decide() on the same signals, and apply() on the same fake fleet and
    fake clock, give the JAX policy's verdicts, actions and emitted
    decision records."""
    from agilerl_tpu.llm.autoscale import AutoscalePolicy as JPolicy
    from agilerl_tpu.observability import MemorySink as JSink, MetricsRegistry as JRegistry

    rng = np.random.default_rng(1)
    trace = [dict(mean_backlog=float(rng.choice([0.0, 0.5, 3.0, 9.0, 20.0])),
                  p95_ttft_s=float(rng.choice([0.1, 0.9, 3.0])) if rng.random() < 0.7 else None,
                  fleet_backlog=float(rng.integers(0, 2)),
                  shed_total=float(rng.integers(0, 3)), dt=float(rng.choice([1.0, 5.0, 30.0])))
             for _ in range(60)]
    runs = []
    for Policy, Sink, Registry in ((TPolicy, TSink, TRegistry), (JPolicy, JSink, JRegistry)):
        clock, fleet, sink = FakeClock(), FakeFleet(), Sink()
        pol = Policy(min_replicas=1, max_replicas=3, backlog_high=8.0, backlog_low=1.0,
                     ttft_p95_high_s=2.0, shed_rate_high=2.0, up_cooldown_s=10.0,
                     down_cooldown_s=60.0, clock=clock, metrics=Registry(sink=sink))
        verdicts, shed = [], 0.0
        for s in trace:
            shed += s["shed_total"]
            fleet.signals.update({k: v for k, v in s.items() if k not in ("dt", "shed_total")},
                                 shed_total=shed)
            verdicts.append((pol.decide(fleet.slo_signals(), s["shed_total"]), pol.apply(fleet)))
            clock.advance(s["dt"])
        events = [{k: v for k, v in e.items() if k not in ("seq", "ts")} for e in sink.events]
        runs.append((verdicts, fleet.actions, events))
    assert runs[0] == runs[1]
    assert "up" in runs[0][1] and any(a != "up" for a in runs[0][1])
    with pytest.raises(ValueError):
        TPolicy(min_replicas=0)


def test_autoscaler_grows_and_shrinks_a_real_fleet(weights):
    pkg = _Pkg("torch", weights)
    clock = FakeClock()
    fl = pkg.fleet(n=1)
    pol = TPolicy(min_replicas=1, max_replicas=2, backlog_high=2.0, backlog_low=0.5,
                  up_cooldown_s=1.0, down_cooldown_s=1.0, clock=clock, metrics=fl.metrics)
    tickets = pkg.submit_all(fl, _trace(16, n=9))
    assert pol.apply(fl) == ("up", 1) and fl.replica_ids == [0, 1]
    fl.run_until_drained(pkg.params, greedy=True)
    for t in tickets:
        fl.result(t)
    clock.advance(5.0)
    assert pol.apply(fl) == ("down", 1) and fl.replica_ids == [0]
    assert fl.latency_summary()["fleet"]["requests_total"] == 9


# --------------------------------------------------------------------------- #
# GRPO routing through a fleet
# --------------------------------------------------------------------------- #

GRPO_KW = dict(pad_token_id=0, eos_token_id=None, group_size=2, max_output_tokens=6,
               batch_size=4, seed=0, lora_rank=2, device="cpu")
SERVE_KW = dict(prompt_buckets=(32,), slots=3, block_size=8, decode_chunk=4)


def _prompts(rng, lens=(5, 11), P=12):
    ids = np.zeros((len(lens), P), np.int32)
    mask = np.zeros((len(lens), P), np.int32)
    for i, n in enumerate(lens):
        ids[i, P - n:] = rng.integers(3, 95, size=n)
        mask[i, P - n:] = 1
    return {"input_ids": ids, "attention_mask": mask}


def test_grpo_rollouts_route_through_the_fleet(weights):
    """An attached fleet serves GRPO's sampled rollouts token for token as
    the bare continuous generator does (same agent seed, same key stream),
    through the router, with the group repeats hitting the prefix cache;
    last_generation_info carries the fleet's captured logprobs."""
    from agilerl_tpu_torch.algorithms.grpo import GRPO

    tparams = weights[2]
    bare = GRPO(config=TCFG, base_params=tparams, continuous_decode=True,
                capture_logprobs=True, **GRPO_KW)
    agent = GRPO(config=TCFG, base_params=tparams, **GRPO_KW)
    reg = TRegistry()
    fleet = TF.ServingFleet(TCFG, 2, metrics=reg, device="cpu", capture_logprobs=True,
                            **SERVE_KW, **agent._serving_knobs())
    agent.attach_rollout_fleet(fleet)
    prompts = _prompts(np.random.default_rng(5))
    comp1, mask1 = bare.get_action(prompts)
    comp2, mask2 = agent.get_action(prompts)
    np.testing.assert_array_equal(comp1, comp2)
    np.testing.assert_array_equal(mask1, mask2)
    assert reg.counter("fleet/routed_requests_total").value == comp1.shape[0]
    hits = sum(m.gen.metrics.counter("serving/prefix_cache_hits_total").value
               for m in fleet._serving_members().values())
    assert hits > 0
    lps = agent.last_generation_info["logprobs"]
    np.testing.assert_allclose(lps, bare.last_generation_info["logprobs"], rtol=1e-6, atol=1e-6)
    assert lps.shape == comp1.shape and (lps[mask1.astype(bool)] < 0).all()


def test_attach_rollout_fleet_recipe_check_and_detach(weights):
    """A recipe mismatch is rejected with the JAX package's error; detaching
    restores the pre-attach continuous_decode."""
    from agilerl_tpu_torch.algorithms.grpo import GRPO

    tparams = weights[2]
    agent = GRPO(config=TCFG, base_params=tparams, **GRPO_KW)
    bad = TF.ServingFleet(TCFG, 1, metrics=TRegistry(), device="cpu",
                          **SERVE_KW, **dict(agent._serving_knobs(), temperature=0.123))
    with pytest.raises(ValueError, match="sampling recipe"):
        agent.attach_rollout_fleet(bad)
    assert agent.rollout_fleet is None and agent.continuous_decode is False
    fleet = TF.ServingFleet(TCFG, 1, metrics=TRegistry(), device="cpu",
                            **SERVE_KW, **agent._serving_knobs())
    agent.attach_rollout_fleet(fleet)
    assert agent.continuous_decode is True and agent.rollout_fleet is fleet
    agent.attach_rollout_fleet(None)
    assert agent.rollout_fleet is None and agent.continuous_decode is False
    cont = GRPO(config=TCFG, base_params=tparams, continuous_decode=True, **GRPO_KW)
    cont.attach_rollout_fleet(fleet)
    cont.attach_rollout_fleet(None)
    assert cont.continuous_decode is True
