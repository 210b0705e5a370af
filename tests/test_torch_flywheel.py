"""Parity of the port's online GRPO flywheel (agilerl_tpu_torch.llm.flywheel
and training.train_llm_online) with the JAX package's, on the CPU: the
weight and trajectory stores (GC, torn entries skipped, negative lag
dropped) against the JAX stores on the same operations; the
importance-corrected learn step against the JAX step on the same weights and
batch; a weight epoch the JAX learner published, adopted by a port rollout
pod, decoding the JAX rollout's greedy tokens; and the port's own contracts
(the synchronous flywheel equals the interleaved loop, staleness 2 never
stalls, carried learner state restores the exact stream). Each test imports
the JAX modules it compares with inside the test."""

import pickle

import numpy as np
import pytest
import torch

from agilerl_tpu_torch.algorithms.grpo import GRPO
from agilerl_tpu_torch.llm import model as TM
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy
from agilerl_tpu_torch.llm.fleet import PrefillWorker, ServingFleet
from agilerl_tpu_torch.llm.flywheel import (
    LearnerPod,
    OnlineGRPOFlywheel,
    RolloutPod,
    TrajectoryBatch,
    TrajectoryStore,
    WeightStore,
)
from agilerl_tpu_torch.llm.serving import ContinuousGenerator
from agilerl_tpu_torch.observability import MemorySink, MetricsRegistry, RunTelemetry
from agilerl_tpu_torch.resilience import set_fault_hook
from agilerl_tpu_torch.training.train_llm_online import finetune_llm_reasoning_online
from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, ReasoningGym
from agilerl_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

TOK = CharTokenizer()
MODEL = dict(vocab_size=TOK.vocab_size, n_layer=2, n_head=4, d_model=32, max_seq_len=64)
CFG = TM.GPTConfig(dtype=torch.float32, **MODEL)
AGENT = dict(pad_token_id=TOK.pad_token_id, eos_token_id=TOK.eos_token_id, group_size=2,
             batch_size=8, max_output_tokens=4)


def reasoning_rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"question": f"{a}+{b}=", "answer": str(a + b)}
            for a, b in rng.integers(0, 5, (n, 2))]


def spread_reward(completion, answer, prompt):
    """Reward with within-group variance (an all-equal group zeroes the
    advantage and the loss)."""
    return 0.1 * len(completion) + float(completion.startswith(str(answer)))


def make_env(Gym=ReasoningGym, tok=TOK):
    return Gym(reasoning_rows(16, 0), reasoning_rows(4, 1), tok, reward_fn=spread_reward,
               data_batch_size=4)


def make_agent(seed=0, **over):
    return GRPO(config=CFG, seed=seed, device="cpu", **dict(AGENT, **over))


def make_flywheel(tmp_path, max_staleness=0, seed=0, **agent_over):
    env, agent, reg = make_env(), make_agent(seed, **agent_over), MetricsRegistry()
    ws = WeightStore(tmp_path / "w", metrics=reg)
    ts = TrajectoryStore(tmp_path / "t", metrics=reg)
    learner = LearnerPod(agent, ws, ts, max_staleness_epochs=max_staleness, metrics=reg)
    rollout = RolloutPod(agent, env, ws, ts, metrics=reg)
    return OnlineGRPOFlywheel(rollout, learner, metrics=reg), reg


def _batch(seq, weight_epoch=0, actor=0):
    return dict(seq=seq, actor_id=actor, weight_epoch=weight_epoch, data_epoch=0,
                ids=np.zeros((2, 4), np.int32), action_masks=np.ones((2, 3)),
                rewards=np.zeros((1, 2)), behavior_lp=np.zeros((2, 3)))


def _truncating_hook(set_hook, name):
    """A fault hook that truncates the first ``name`` file written."""
    state = {"armed": True}

    def hook(op, path):
        if op == "wrote" and state["armed"] and path.name == name:
            state["armed"] = False
            path.write_bytes(path.read_bytes()[: path.stat().st_size // 2])

    return set_hook(hook)


def _assert_numpy_only(obj):
    """A payload that unpickles without a card: no tensor anywhere."""
    if isinstance(obj, dict):
        for v in obj.values():
            _assert_numpy_only(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _assert_numpy_only(v)
    else:
        assert not isinstance(obj, torch.Tensor), type(obj)


# --------------------------------------------------------------------------- #
# stores
# --------------------------------------------------------------------------- #


def _store_ops(mod, set_hook, Registry, root, lora_of):
    """The same store operations on one package: publish / GC / torn epoch /
    stray dir / seq order / torn batch / negative lag."""
    reg = Registry()
    ws = mod.WeightStore(root / "w", keep_last=2, metrics=reg)
    (root / "w" / "epoch_junk").mkdir()
    for e in range(4):
        ws.publish(e, lora_of(e))
    prev = _truncating_hook(set_hook, "weights.pkl")
    try:
        ws.publish(4, lora_of(4))
    finally:
        set_hook(prev)
    with pytest.warns(RuntimeWarning, match="torn"):
        epoch, loaded = ws.load_latest()
    out = {"epochs": ws.epochs(), "latest": ws.latest_epoch(), "loaded_epoch": epoch,
           "loaded": np.asarray(loaded["blocks"][0]["wq"]["B"]),
           "junk": (root / "w" / "epoch_junk").is_dir()}
    ts = mod.TrajectoryStore(root / "t", metrics=reg)
    for seq, actor in ((1, 1), (0, 0), (2, 0)):
        ts.publish(mod.TrajectoryBatch(**_batch(seq, actor=actor)))
    prev = _truncating_hook(set_hook, "trajectory.pkl")
    try:
        ts.publish(mod.TrajectoryBatch(**_batch(3)))
    finally:
        set_hook(prev)
    with pytest.warns(RuntimeWarning, match="torn"):
        out["polled"] = [b.seq for b in ts.poll()]
    out["pending"] = ts.pending()
    out["counters"] = {k: reg.counter(k).value for k in (
        "flywheel/weight_epochs_published_total", "flywheel/torn_weight_publishes_total",
        "flywheel/trajectories_published_total", "flywheel/trajectories_consumed_total",
        "flywheel/torn_trajectories_total")}
    return out


def test_stores_match_jax(tmp_path):
    """Weight-store GC around a stray dir, a torn epoch walked past, seq
    order across actors, a torn batch consumed and never returned: the
    JAX stores' results on the same operations. The port's payloads are
    numpy only."""
    from agilerl_tpu.llm import flywheel as JF
    from agilerl_tpu.observability import MetricsRegistry as JRegistry
    from agilerl_tpu.resilience.atomic import set_fault_hook as j_set_hook
    import agilerl_tpu_torch.llm.flywheel as TF

    def np_lora(e):
        return {"blocks": {0: {"wq": {"A": np.full((4, 2), e, np.float32),
                                      "B": np.arange(8, dtype=np.float32).reshape(2, 4) + e}}}}

    def torch_lora(e):
        return lora_from_numpy(np_lora(e), device="cpu")

    t = _store_ops(TF, set_fault_hook, MetricsRegistry, tmp_path / "t", torch_lora)
    j = _store_ops(JF, j_set_hook, JRegistry, tmp_path / "j", np_lora)
    for key in ("epochs", "latest", "loaded_epoch", "junk", "polled", "pending", "counters"):
        assert t[key] == j[key], key
    np.testing.assert_array_equal(t["loaded"], j["loaded"])
    assert t["epochs"] == [3, 4] and t["loaded_epoch"] == 3 and t["polled"] == [0, 1, 2]
    payload = pickle.loads((tmp_path / "t" / "w" / "epoch_00000003" / "weights.pkl").read_bytes())
    _assert_numpy_only(payload)


def test_negative_and_over_budget_lag_dropped_never_trained(tmp_path):
    reg = MetricsRegistry()
    ws, ts = WeightStore(tmp_path / "w", metrics=reg), TrajectoryStore(tmp_path / "t", metrics=reg)
    learner = LearnerPod(make_agent(0), ws, ts, max_staleness_epochs=2, metrics=reg)
    ts.publish(TrajectoryBatch(**_batch(0, weight_epoch=5)))  # lag 0 - 5 = -5
    assert learner.step() == 1 and learner.learn_calls == 0
    assert reg.counter("flywheel/trajectories_dropped_stale_total").value == 1
    fly, reg = make_flywheel(tmp_path / "slow", max_staleness=2)
    fly.rollout.poll_weights()
    for _ in range(4):  # a slow learner: four rollouts pile up
        fly.rollout.rollout_once()
    assert fly.learner.step() == 4
    assert fly.learner.trained_seqs == [0, 1, 2] and fly.learner.dropped_seqs == [3]
    assert reg.gauge("flywheel/weight_epoch_lag").value == 3
    assert reg.counter("flywheel/decode_stalls_total").value == 0


# --------------------------------------------------------------------------- #
# the importance-corrected learn step
# --------------------------------------------------------------------------- #


def _agent_pair(beta, **over):
    """A JAX agent and a port agent on the same base weights and adapters
    (non-zero B, so the adapter matters)."""
    import jax
    import jax.numpy as jnp

    from agilerl_tpu.algorithms.grpo import GRPO as JGRPO
    from agilerl_tpu.llm import model as JM

    kw = dict(AGENT, beta=beta, lr=1e-3, lora_rank=4, **over)
    jagent = JGRPO(config=JM.GPTConfig(dtype=jnp.float32, **MODEL), seed=0, **kw)
    rng = np.random.default_rng(1)
    actor = jax.tree_util.tree_map(np.asarray, jagent.actor.params)
    for layer in actor["blocks"].values():
        for ab in layer.values():
            ab["B"] = rng.normal(0, 0.05, ab["B"].shape).astype(np.float32)
    jagent.actor.params = jax.tree_util.tree_map(jnp.asarray, actor)
    jagent.reference.params = jax.tree_util.tree_map(jnp.asarray, actor)
    jagent.optimizer.init(jagent.actor.params)
    base = params_from_numpy(jax.tree_util.tree_map(np.asarray, jagent.base_params), CFG,
                             device="cpu")
    tagent = GRPO(config=CFG, seed=0, device="cpu", base_params=base, **kw)
    tagent.actor.params = lora_from_numpy(actor, device="cpu")
    tagent.reference.params = lora_from_numpy(actor, device="cpu")
    tagent.optimizer.init(tagent.actor.params)
    return jagent, tagent, actor


def _ragged_batch(seed=3, groups=2, G=4, P=6, N=6):
    """Completions of unequal length in every group: the group-z-scored
    advantages then do not cancel over the tokens, so the beta = 0 loss is
    well above f32 rounding."""
    rng = np.random.default_rng(seed)
    rows = groups * G
    ids = rng.integers(2, TOK.vocab_size, (rows, P + N)).astype(np.int32)
    lengths = np.tile(np.arange(1, G + 1) + 1, groups)
    for r, n in enumerate(lengths):
        ids[r, P + n:] = 0
    action = np.zeros((rows, P + N - 1), np.float32)
    action[:, P - 1:] = ids[:, P:] != 0
    rewards = rng.normal(size=(groups, G)).astype(np.float32)
    return ids, action, rewards


def test_single_correction_anchor_on_a_nonzero_loss():
    """A uniformly 0.5-nat-stale behavior record scales the beta = 0 loss by
    exactly e^0.5 (the ratio stays anchored at the learn-start policy; rho
    corrects once), on a batch whose loss is about 1e-2 (each package's
    behavior record is its own scoring pass). The JAX package holds the same
    anchor on this batch (rtol 1e-5) and gives the same losses (rtol 1e-5,
    f32 summation order)."""
    jref, tref, _ = _agent_pair(0.0)
    jfly, tfly, _ = _agent_pair(0.0)
    ids, action, rewards = _ragged_batch()
    behavior = tfly.behavior_logprobs(ids, action) - 0.5 * action
    loss_ref, _ = tref.learn((ids, action, rewards))
    loss_fly, _ = tfly.learn_from_trajectory(ids, action, rewards, behavior, rho_clip=2.0)
    assert abs(loss_ref) >= 1e-3
    np.testing.assert_allclose(loss_fly, np.exp(0.5) * loss_ref, rtol=1e-5)
    jbehavior = np.asarray(jfly.behavior_logprobs(ids, action)) - 0.5 * action
    jloss_ref, _ = jref.learn((ids, action, rewards))
    jloss_fly, _ = jfly.learn_from_trajectory(ids, action, rewards, jbehavior, rho_clip=2.0)
    np.testing.assert_allclose(jloss_fly, np.exp(0.5) * jloss_ref, rtol=1e-5)
    np.testing.assert_allclose(loss_ref, jloss_ref, rtol=1e-5)
    np.testing.assert_allclose(loss_fly, jloss_fly, rtol=1e-5)


def test_learn_from_trajectory_matches_jax_and_learn_at_staleness_zero():
    """Behavior logprobs of the current adapter fed back through
    learn_from_trajectory give learn's update, and the JAX package's
    learn_from_trajectory on the same weights and batch: loss and KL at
    rtol 1e-5, the adapter after the step at atol 5e-6 (as
    test_torch_grpo's learn parity)."""
    import jax

    jagent, tagent, actor = _agent_pair(0.05)
    _, plain, _ = _agent_pair(0.05)
    ids, action, rewards = _ragged_batch(4)
    behavior = tagent.behavior_logprobs(ids, action)
    np.testing.assert_allclose(behavior, np.asarray(jagent.behavior_logprobs(ids, action)),
                               rtol=1e-5, atol=1e-6)
    tl, tk = tagent.learn_from_trajectory(ids, action, rewards, behavior)
    jl, jk = jagent.learn_from_trajectory(ids, action, rewards, behavior)
    pl, pk = plain.learn((ids, action, rewards))
    np.testing.assert_allclose((tl, tk), (jl, jk), rtol=1e-5)
    np.testing.assert_allclose((tl, tk), (pl, pk), rtol=1e-6)
    after = jax.tree_util.tree_map(np.asarray, jagent.actor.params)
    for i, layer in after["blocks"].items():
        for t, ab in layer.items():
            for name in ("A", "B"):
                np.testing.assert_allclose(tagent.actor.params["blocks"][i][t][name].numpy(),
                                           ab[name], rtol=0, atol=5e-6)
    for a, b in zip(tree_leaves(tagent.actor.params), tree_leaves(plain.actor.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-8)


# --------------------------------------------------------------------------- #
# the flywheel's contracts
# --------------------------------------------------------------------------- #


def test_sync_flywheel_matches_interleaved_loop(tmp_path):
    """max_staleness_epochs=0 reproduces the interleaved
    finetune_llm_reasoning loss and adapter stream on the same prompts
    (rtol 1e-5): same seeds, same key order, rho == 1."""
    from agilerl_tpu_torch.training.train_llm import finetune_llm_reasoning

    env, agent = make_env(), make_agent(0)
    losses = []
    orig = agent.learn
    agent.learn = lambda batch: losses.append(orig(batch)[0]) or (losses[-1], 0.0)
    finetune_llm_reasoning([agent], env, max_steps=3, evaluation_interval=10, verbose=False)
    fly, _ = make_flywheel(tmp_path, max_staleness=0, seed=0)
    fly.run(3)
    assert len(losses) == 3 and any(abs(x) > 1e-6 for x in losses)
    np.testing.assert_allclose(fly.learner.losses, losses, rtol=1e-5, atol=1e-7)
    for a, b in zip(tree_leaves(agent.actor.params),
                    tree_leaves(fly.learner.agent.actor.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)
    assert fly.learner.dropped_seqs == []


def test_staleness_two_runs_with_zero_stalls(tmp_path):
    fly, reg = make_flywheel(tmp_path, max_staleness=2, seed=0)
    fly.run(3)
    assert fly.learner.epoch == 3 and fly.learner.dropped_seqs == []
    assert reg.counter("flywheel/decode_stalls_total").value == 0
    assert all(np.isfinite(x) for x in fly.learner.losses)


def test_captured_logprobs_replace_the_dense_forward_and_cursor_resumes(tmp_path):
    """A capture_logprobs rollout ships the decode-time logprobs as the
    behavior record (no dense forward; within 1e-4 of it in f32), and the
    durable seq cursor carries a respawned pod past the published seqs."""
    fly, reg = make_flywheel(tmp_path, max_staleness=2, continuous_decode=True,
                             capture_logprobs=True)
    pod = fly.rollout
    pod.cursor_path = tmp_path / "cursor.json"
    pod.poll_weights()
    batch = pod.rollout_once()
    assert reg.counter("flywheel/logprob_forwards_saved_total").value == 1
    dense = pod.agent.behavior_logprobs(batch.ids, batch.action_masks)
    np.testing.assert_allclose(batch.behavior_lp, dense, atol=1e-4)
    assert np.abs(batch.behavior_lp).sum() > 0
    respawn = RolloutPod(pod.agent, make_env(), pod.weight_store, pod.traj_store,
                         metrics=MetricsRegistry(), cursor_path=tmp_path / "cursor.json")
    assert respawn.seq == 1


def test_carried_learner_state_restores_the_exact_stream(tmp_path):
    """A learner publishing with carry_state ships optimizer, reference,
    random streams and history as host numpy; a fresh learner restored from
    the store continues the exact loss stream."""
    fly, _ = make_flywheel(tmp_path, max_staleness=0, seed=0)
    fly.learner.carry_state = True
    fly.run(2)
    payload = fly.learner.weight_store.load_latest_payload()
    _assert_numpy_only(payload)
    assert payload["learner_state"]["rng"]["torch_key"].dtype == np.uint8
    agent = make_agent(5)
    agent.base_params = fly.learner.agent.base_params
    fresh = LearnerPod(agent, fly.learner.weight_store, fly.learner.traj_store,
                       max_staleness_epochs=0, metrics=MetricsRegistry(), publish_initial=False)
    assert fresh.restore_from_store() and fresh.epoch == 2
    assert fresh.losses == fly.learner.losses
    assert torch.equal(agent._key.get_state(), fly.learner.agent._key.get_state())
    batch = fly.rollout.rollout_once()
    fly.rollout.traj_store.clear()
    la = fly.learner.agent.learn_from_trajectory(batch.ids, batch.action_masks, batch.rewards,
                                                 batch.behavior_lp)
    lb = agent.learn_from_trajectory(batch.ids, batch.action_masks, batch.rewards,
                                     batch.behavior_lp)
    np.testing.assert_allclose(lb, la, rtol=1e-6)


def test_weight_bump_invalidates_every_replica_and_drops_stale_imports():
    """A new adapter tree flushes the prefix cache on every replica; a
    prefilled import computed under the old adapter and still queued is
    dropped and recomputed under the new one."""
    params = TM.init_params(0, CFG, device="cpu")
    lora_a = TM.init_lora(1, CFG, 4, ("wq", "wv"), device="cpu")
    lora_b = {"blocks": {i: {t: {k: v + 0.01 for k, v in ab.items()} for t, ab in blk.items()}
                         for i, blk in lora_a["blocks"].items()}}
    serve = dict(pad_id=0, prompt_buckets=(32,), block_size=8, decode_chunk=4, device="cpu")
    fleet = ServingFleet(CFG, 2, metrics=MetricsRegistry(), max_new_tokens=4, slots=3, **serve)
    rng = np.random.default_rng(0)
    seqs = [rng.integers(3, 40, size=12).astype(np.int32) for _ in range(4)]
    fleet.generate(seqs, 2, params, lora=lora_a, greedy=True)
    fleet.generate(seqs, 3, params, lora=lora_b, greedy=True)
    for m in fleet._serving_members().values():
        assert m.gen.metrics.counter("serving/prefix_cache_invalidations_total").value >= 1

    gen = ContinuousGenerator(CFG, max_new_tokens=8, slots=1, metrics=MetricsRegistry(), **serve)
    tok_a, tok_b = (rng.integers(3, 40, size=n).astype(np.int32) for n in (10, 12))
    ta = gen.submit(tok_a, key=5)
    gen.step(params, lora=lora_a, greedy=True)
    worker = PrefillWorker.matching(gen, metrics=MetricsRegistry())
    payload = worker.prefill(tok_b, np.asarray([7, 0]), params, lora=lora_a, greedy=True)
    tb = gen.submit_prefilled(tok_b, k_prompt=payload["k"], v_prompt=payload["v"],
                              tok0=payload["tok0"],
                              done0=payload["done0"], key_next=payload["key_next"], key=[7, 0],
                              no_shed=True)
    assert set(gen.run_until_drained(params, lora=lora_b, greedy=True)) == {ta, tb}
    assert gen.metrics.counter("serving/stale_imports_dropped_total").value == 1
    fresh = ContinuousGenerator(CFG, max_new_tokens=8, slots=1, metrics=MetricsRegistry(), **serve)
    want = fresh.generate([tok_b], 0, params, lora=lora_b, greedy=True)[0][0]
    np.testing.assert_array_equal(gen.result(tb)[0], want)


def test_jax_published_epoch_adopted_by_a_port_pod(tmp_path):
    """A weight epoch that the JAX learner published (host numpy) loads into
    a port rollout pod through lora_from_numpy, and the port pod then decodes
    the JAX rollout's greedy tokens, rewards and (1e-5) behavior record."""
    import jax

    from agilerl_tpu.llm import flywheel as JF
    from agilerl_tpu.observability import MetricsRegistry as JRegistry
    from agilerl_tpu.utils.llm_utils import CharTokenizer as JTok, ReasoningGym as JGym

    jagent, tagent, actor = _agent_pair(0.05)
    jreg = JRegistry()
    jws = JF.WeightStore(tmp_path / "w", metrics=jreg)
    jts = JF.TrajectoryStore(tmp_path / "jt", metrics=jreg)
    JF.LearnerPod(jagent, jws, jts, metrics=jreg)  # publishes epoch 0
    jpod = JF.RolloutPod(jagent, make_env(JGym, JTok()), jws, jts, metrics=jreg)
    assert jpod.poll_weights()
    jbatch = jpod.rollout_once(greedy=True)

    tagent.actor.params = lora_from_numpy(
        jax.tree_util.tree_map(lambda x: np.zeros_like(x), actor), device="cpu")
    reg = MetricsRegistry()
    pod = RolloutPod(tagent, make_env(), WeightStore(tmp_path / "w", metrics=reg),
                     TrajectoryStore(tmp_path / "tt", metrics=reg), metrics=reg)
    assert pod.poll_weights() and pod.weight_epoch == 0
    for i, layer in actor["blocks"].items():
        for t, ab in layer.items():
            for name in ("A", "B"):
                np.testing.assert_array_equal(tagent.actor.params["blocks"][i][t][name].numpy(),
                                              ab[name])
    batch = pod.rollout_once(greedy=True)
    np.testing.assert_array_equal(batch.ids, jbatch.ids)
    np.testing.assert_array_equal(batch.action_masks, jbatch.action_masks)
    np.testing.assert_allclose(batch.rewards, jbatch.rewards, rtol=1e-6)
    np.testing.assert_allclose(batch.behavior_lp, jbatch.behavior_lp, rtol=1e-5, atol=1e-5)
    assert batch.prompt_hashes == jbatch.prompt_hashes


# --------------------------------------------------------------------------- #
# the entry point
# --------------------------------------------------------------------------- #


def test_online_entry_point_runs_logs_and_starts_clean(tmp_path):
    """finetune_llm_reasoning_online trains, evaluates once per learner
    epoch, logs through the facade, exports per-pod telemetry, and purges a
    reused workdir's previous-run epochs."""
    WeightStore(tmp_path / "weights").publish(37, {"w": np.zeros(2, np.float32)})
    sink = MemorySink()
    telem = RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False)
    agent = make_agent(0)
    out, fitnesses = finetune_llm_reasoning_online(
        agent, make_env(), tmp_path, max_epochs=2, evaluation_interval=1,
        max_staleness_epochs=0, verbose=False, telemetry=telem,
        telemetry_export_dir=tmp_path / "telemetry")
    assert out is agent and len(fitnesses) == 2
    losses = [e["train/loss"] for e in sink.events if e["kind"] == "metrics" and "train/loss" in e]
    assert len(losses) == 2 and all(np.isfinite(x) for x in losses)
    reg = telem.registry
    for name in ("flywheel/learn_steps_total", "flywheel/trajectories_published_total",
                 "flywheel/trajectories_consumed_total"):
        assert reg.counter(name).value == 2
    assert max(WeightStore(tmp_path / "weights").epochs()) == 2
    assert (tmp_path / "telemetry" / "pod_rollout_0").is_dir()


def test_online_entry_point_raises_like_the_reference_and_on_unported_hooks(tmp_path):
    from agilerl_tpu_torch.hpo import Mutations

    agent = make_agent(0)
    with pytest.raises(ValueError, match="resume=True requires"):
        finetune_llm_reasoning_online(agent, make_env(), tmp_path, max_epochs=1, resume=True,
                                      mutation=Mutations(architecture=0.5), verbose=False)
    with pytest.raises(AssertionError):
        finetune_llm_reasoning_online(agent, make_env(), tmp_path, max_epochs=1,
                                      mutation=Mutations(architecture=0.5), verbose=False)
    from agilerl_tpu_torch.resilience import Resilience

    from agilerl_tpu_torch.parallel.plan import make_grpo_plan
    from tests.torch_dist_harness import single_rank

    for hook in (dict(resilience=Resilience(tmp_path / "snap", save_every=1,
                                            handle_signals=False)),
                 dict(plan=make_grpo_plan()), dict(mesh=None), dict(wb=True)):
        if "wb" in hook:
            # wb=True runs: wandb does not import here, so the loop logs to
            # its sink only, as the JAX loop does
            _, fit = finetune_llm_reasoning_online(make_agent(0), make_env(), tmp_path / "wb",
                                                   max_epochs=1, evaluation_interval=1,
                                                   verbose=False, **hook)
            assert len(fit) == 1
            continue
        if "resilience" in hook:
            # resilience= runs: a snapshot at the epoch-1 boundary, and a
            # resume continues the epoch line from it
            _, fit = finetune_llm_reasoning_online(agent, make_env(), tmp_path / "fly",
                                                   max_epochs=1, evaluation_interval=1,
                                                   verbose=False, **hook)
            assert [s.step for s in hook["resilience"].manager.snapshots()] == [1]
            _, fit2 = finetune_llm_reasoning_online(
                make_agent(0), make_env(), tmp_path / "fly", max_epochs=2,
                evaluation_interval=1, verbose=False, resume=True,
                resilience=Resilience(tmp_path / "snap", handle_signals=False))
            assert len(fit) == 1 and len(fit2) == 2 and fit2[0] == fit[0]
            continue
        # plan= / mesh= (they raised before the sharding plans were ported)
        # place the learner on a one-rank mesh and run
        with single_rank():
            if "mesh" in hook:
                hook = dict(mesh=make_grpo_plan().build_mesh("cpu"))
            placed = make_agent(0)
            _, fit = finetune_llm_reasoning_online(placed, make_env(), tmp_path / "plan",
                                                   max_epochs=1, evaluation_interval=1,
                                                   verbose=False, **hook)
            assert len(fit) == 1 and np.isfinite(fit).all() and placed.mesh is not None
    reg = MetricsRegistry()
    with single_rank():
        learner = make_agent(0)
        LearnerPod(learner, WeightStore(tmp_path / "w", metrics=reg),
                   TrajectoryStore(tmp_path / "t", metrics=reg), plan=make_grpo_plan())
        assert learner.sharding_plan.name == "grpo-dp1"
