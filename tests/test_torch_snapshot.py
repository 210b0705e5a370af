"""Parity of the port's whole-run snapshots, retry and preemption
(agilerl_tpu_torch.resilience: ``CheckpointManager``, ``RetryPolicy``,
``PreemptionGuard``) with the JAX package's on the CPU, and the LLM loops'
resume: a GRPO run preempted mid-epoch resumes as the uninterrupted run
ends, bit for bit, where the JAX package's resumed run diverges (its
snapshot leaves the reference adapter out); DPO likewise. A GRPO snapshot
holds no base weights, and a base that does not match its fingerprint
raises; a generator's state restores only on its own device type; the LLM
loops run ``telemetry=``, the population checkpoints and ``save_elite``."""

import json
import os
import pickle
import random
import signal

import numpy as np
import pytest
import torch

from agilerl_tpu_torch import resilience as TR
from agilerl_tpu_torch.algorithms.dpo import DPO
from agilerl_tpu_torch.algorithms.grpo import GRPO
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
from agilerl_tpu_torch.llm import model as TM
from agilerl_tpu_torch.training.train_llm import finetune_llm_preference, finetune_llm_reasoning
from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, PreferenceGym, ReasoningGym
from agilerl_tpu_torch.utils.rng import generator_from_host, generator_to_host
from agilerl_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

TOK = CharTokenizer()
ROWS = [{"question": f"{a}+1=", "answer": str(a + 1)} for a in range(14)]


def _jax():
    pytest.importorskip("jax")
    from agilerl_tpu import resilience as JR

    return JR


# --------------------------------------------------------------------------- #
# CheckpointManager, RetryPolicy, PreemptionGuard against the JAX package
# --------------------------------------------------------------------------- #


def _manager_run(R, directory):
    """Saves at steps 3, 3 (a same-step resave), 5 and 9 with keep_last=2 and
    keep_best, one with a NaN member fitness; the step-9 save torn by the
    FaultInjector (its first file truncated after it landed). Returns what
    the two packages must agree on."""
    mgr = R.CheckpointManager(directory, keep_last=2, keep_best=True)
    plan = [(3, dict(fitness=4.0)), (3, dict(member_fitness=[float("nan"), 1.0])),
            (5, dict(fitness=2.0)), (9, dict(member_fitness=[3.0, None]))]
    names, manifests = [], []
    for i, (step, kw) in enumerate(plan):
        entries = {"population": [{"index": i, "steps": [step]}],
                   "counters": {"total_steps": step, "eps": 0.5 ** i}}
        if step == 9:
            with R.FaultInjector(truncate_at_ops=[0], match=("wrote",)):
                path = mgr.save(entries, step, **kw)
        else:
            path = mgr.save(entries, step, **kw)
        names.append(sorted(d.name for d in directory.iterdir()))
        manifest = json.loads((path / "manifest.json").read_text())
        manifests.append((sorted(manifest), {k: v["sha256"] for k, v in
                                             manifest["entries"].items()},
                          manifest["fitness"], manifest.get("member_fitness")))
    loaded = mgr.load()
    return dict(names=names, manifests=manifests,
                retained=[(s.path.name, s.step, s.kind) for s in mgr.snapshots()],
                newest=mgr.latest(validate=False).path.name, latest=mgr.latest().path.name,
                best=mgr.best().path.name,
                loaded=(loaded[0].path.name, loaded[1]),
                valid=[mgr.validate(s) for s in mgr.snapshots()])


def test_checkpoint_manager_matches_jax(tmp_path):
    JR = _jax()
    got = _manager_run(TR, tmp_path / "torch")
    want = _manager_run(JR, tmp_path / "jax")
    assert got == want
    # the same-step resave carries the _0001 suffix; the torn step-9
    # snapshot is skipped by load()
    assert "step_000000000003_0001" in got["names"][1]
    assert got["valid"][-1] is False and got["newest"] == "step_000000000009"
    assert got["loaded"][0] == got["latest"] == "step_000000000005"


def test_retry_policy_and_env_match_jax():
    JR = _jax()
    from agilerl_tpu.observability import MetricsRegistry as JReg
    from agilerl_tpu_torch.observability import MetricsRegistry as TReg

    for kw in ({}, dict(max_attempts=5, backoff_s=0.1, backoff_mult=3.0, max_backoff_s=0.5)):
        tp, jp = TR.RetryPolicy(**kw), JR.RetryPolicy(**kw)
        assert [tp.delay(a) for a in range(1, 8)] == [jp.delay(a) for a in range(1, 8)]
    out = {}
    for name, R, Reg in (("torch", TR, TReg), ("jax", JR, JReg)):
        reg, sleeps, calls = Reg(), [], []

        def flaky(n_fail):
            calls.append(1)
            if len(calls) <= n_fail:
                raise ConnectionError("flake")
            return len(calls)

        policy = R.RetryPolicy(max_attempts=4)
        res = [R.call_with_retries(flaky, 2, policy=policy, registry=reg, sleep=sleeps.append)]
        calls.clear()
        with pytest.raises(ConnectionError):
            R.call_with_retries(flaky, 9, policy=policy, registry=reg, sleep=sleeps.append)
        with pytest.raises(ValueError):
            R.call_with_retries(lambda: (_ for _ in ()).throw(ValueError("no")),
                                policy=policy, registry=reg, sleep=sleeps.append)

        class Env:
            def reset(self):
                return "obs"

            def step(self, a):
                return a + 1

        env = R.RetryingEnv(R.ScheduledFailureEnv(Env(), fail_resets=[0], fail_steps=[1, 2]),
                            policy=policy, registry=reg, sleep=sleeps.append)
        res += [env.reset(), env.step(1), env.step(2), env.reset_calls, env.step_calls]
        out[name] = (res, sleeps, reg.counter("resilience/retries_total").value)
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == [3, "obs", 2, 3, 2, 4]


def test_preemption_guard_matches_jax_on_a_real_sigterm():
    """request, reset, install and uninstall, and a real SIGTERM sent to
    this process: the port's guard installed over the JAX one chains to it,
    so both latch, and both record one preemption."""
    JR = _jax()
    from agilerl_tpu.observability import MetricsRegistry as JReg
    from agilerl_tpu_torch.observability import MetricsRegistry as TReg

    before = signal.getsignal(signal.SIGTERM)
    trace = {}
    for name, R, Reg in (("torch", TR, TReg), ("jax", JR, JReg)):
        reg = Reg()
        g = R.PreemptionGuard(registry=reg)
        steps = [g.requested]
        g.request()
        steps += [g.requested, reg.counter("resilience/preemptions_total").value]
        g.reset()
        steps += [g.requested]
        trace[name] = steps
    assert trace["torch"] == trace["jax"] == [False, True, 1.0, False]

    jreg, treg = JReg(), TReg()
    jguard = JR.PreemptionGuard(registry=jreg).install()
    tguard = TR.PreemptionGuard(registry=treg).install()
    try:
        assert signal.getsignal(signal.SIGTERM) == tguard._handler
        os.kill(os.getpid(), signal.SIGTERM)
        assert tguard.requested and jguard.requested
        assert (treg.counter("resilience/preemptions_total").value
                == jreg.counter("resilience/preemptions_total").value == 1)
    finally:
        tguard.uninstall()
        assert signal.getsignal(signal.SIGTERM) == jguard._handler
        jguard.uninstall()
    assert signal.getsignal(signal.SIGTERM) == before


# --------------------------------------------------------------------------- #
# the torch rules
# --------------------------------------------------------------------------- #


def test_generator_state_restores_only_on_its_device_type(tmp_path):
    from agilerl_tpu_torch.envs.classic import CartPole
    from agilerl_tpu_torch.envs.core import TorchVecEnv

    gen = torch.Generator().manual_seed(3)
    blob = generator_to_host(gen)
    assert blob["device"] == "cpu" and blob["state"].dtype == np.uint8
    want = torch.rand(4, generator=gen)
    generator_from_host(gen, blob)
    assert torch.equal(torch.rand(4, generator=gen), want)
    with pytest.raises(ValueError, match="cuda generator's state cannot restore into a cpu"):
        generator_from_host(gen, dict(blob, device="cuda"))
    # the device env's stream rides the snapshot; a card capture raises here
    env = TorchVecEnv(CartPole(), num_envs=2, seed=0, device="cpu")
    cap = TR.capture_env_rng(env)
    assert cap["kind"] == "torch_generator"
    first = env.reset()[0]
    TR.restore_env_rng(env, cap)
    assert torch.equal(env.reset()[0], first)
    with pytest.raises(ValueError):
        TR.restore_env_rng(env, {"kind": "torch_generator", "gen": dict(cap["gen"],
                                                                         device="cuda")})
    # payloads are host numpy: a tensor anywhere in an entry is refused
    mgr = TR.CheckpointManager(tmp_path)
    with pytest.raises(TypeError, match="host numpy"):
        mgr.save({"counters": {"x": [1, {"t": torch.zeros(2)}]}}, step=1)
    assert mgr.snapshots() == []
    # AsyncPytree entries ride torch.save inside the same atomic commit
    path = mgr.save({"tree": TR.AsyncPytree({"w": torch.arange(3.0)}), "n": 1}, step=2)
    info, entries = mgr.load()
    assert info.path == path and entries["n"] == 1
    assert torch.equal(entries["tree"]["w"], torch.arange(3.0))


# --------------------------------------------------------------------------- #
# the LLM loops
# --------------------------------------------------------------------------- #


def _reward(completion, answer, prompt):
    # varies within a group, so every advantage is not 0
    return float(sum(map(ord, completion)) % 2)


def _grpo_run(pkg):
    """The recipe that shows the JAX fault: 12 training rows (all 4 steps in
    epoch 0), beta 0.1, lr 1e-2, a reward that varies within a group."""
    np.random.seed(7)
    random.seed(7)
    if pkg == "jax":
        import jax.numpy as jnp

        from agilerl_tpu.algorithms.grpo import GRPO as G
        from agilerl_tpu.llm import model as M
        from agilerl_tpu.utils.llm_utils import CharTokenizer as Tok
        from agilerl_tpu.utils.llm_utils import ReasoningGym as Gym
        dtype, kw = jnp.float32, {}
    else:
        G, M, Tok, Gym, dtype, kw = GRPO, TM, CharTokenizer, ReasoningGym, torch.float32, {
            "device": "cpu"}
    tok = Tok()
    cfg = M.GPTConfig(vocab_size=tok.vocab_size, n_layer=1, n_head=2, d_model=32,
                      max_seq_len=48, dtype=dtype)
    env = Gym(ROWS[:12], ROWS[12:], tok, reward_fn=_reward, data_batch_size=2, seed=11)
    pop = [G(config=cfg, pad_token_id=tok.pad_token_id, eos_token_id=tok.eos_token_id,
             group_size=2, batch_size=4, max_output_tokens=2, index=0, seed=0, beta=0.1, lr=1e-2,
             **kw)]
    return env, pop


def _dpo_run(pkg):
    np.random.seed(7)
    random.seed(7)
    rng = np.random.default_rng(0)
    rows = [{"prompt": f"{a}+{b}=", "chosen": str(a + b), "rejected": str(a * b % 97)}
            for a, b in rng.integers(0, 30, (12, 2))]
    cfg = TM.GPTConfig(vocab_size=TOK.vocab_size, n_layer=1, n_head=2, d_model=32,
                       max_seq_len=64, dtype=torch.float32)
    env = PreferenceGym(rows[:10], rows[10:], TOK, data_batch_size=3, seed=4)
    pop = [DPO(config=cfg, pad_token_id=TOK.pad_token_id, eos_token_id=TOK.eos_token_id,
               index=i, seed=i, beta=0.1, lr=1e-2, device="cpu") for i in range(2)]
    pop[1].base_params = pop[0].base_params
    return env, pop


class _PreemptAfter:
    """Env proxy that requests a preemption at its N-th training ``step``
    (the reasoning gym's, once per agent and loop step) or ``reset`` (the
    preference gym's, once per loop step)."""

    def __init__(self, env, guard, after, method):
        self.env, self._guard, self._after, self._method, self._n = (
            env, guard, after, method, 0)

    def _tick(self):
        self._n += 1
        if self._n == self._after:
            self._guard.request()

    def step(self, *a, **kw):
        if self._method == "step":
            self._tick()
        return self.env.step(*a, **kw)

    def reset(self, *a, **kw):
        if self._method == "reset" and not kw.get("eval_mode"):
            self._tick()
        return self.env.reset(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.env, name)


def _telemetry(pkg):
    """A run telemetry on an in-memory sink: the loops log every learn's
    loss to it (``train/loss``)."""
    if pkg == "jax":
        from agilerl_tpu.observability import MetricsRegistry, RunTelemetry
        from agilerl_tpu.observability.events import MemorySink
    else:
        from agilerl_tpu_torch.observability import MetricsRegistry, RunTelemetry
        from agilerl_tpu_torch.observability.events import MemorySink
    sink = MemorySink()
    return RunTelemetry(registry=MetricsRegistry(sink=sink)), sink


def _losses(sink):
    return [e["train/loss"] for e in sink.events if "train/loss" in e]


def _llm_go(loop, env, pop, res, resume=False, pkg="torch", **kw):
    """Four steps of ``loop``, with a tournament and RL-HP mutations when the
    population has two agents. Returns (population, fitnesses, losses)."""
    telem, sink = _telemetry(pkg)
    if pkg == "jax":
        from agilerl_tpu.hpo import Mutations as Mut
        from agilerl_tpu.hpo import TournamentSelection as Tourn
    else:
        Mut, Tourn = Mutations, TournamentSelection
    evo = {}
    if len(pop) > 1:
        evo = dict(tournament=Tourn(2, True, len(pop), 1, rng=np.random.default_rng(0)),
                   mutation=Mut(no_mutation=0.5, architecture=0.0, parameters=0.0,
                                activation=0.0, rl_hp=0.5, rand_seed=0))
    try:
        pop, fit = loop(pop, env, max_steps=4, verbose=False, resilience=res, resume=resume,
                        telemetry=telem, **evo, **kw)
    finally:
        telem.close()
    return pop, fit, _losses(sink)


def _llm_state(pop):
    out = []
    for a in pop:
        out += tree_leaves(a.actor.params) + tree_leaves(a.reference.params)
        out += [x for x in tree_leaves(a.optimizer.opt_state) if isinstance(x, torch.Tensor)]
    return out


@pytest.mark.parametrize("loop", ["finetune_llm_reasoning[GRPO]", "finetune_llm_preference[DPO]"])
def test_llm_preempted_mid_epoch_resumes_bit_for_bit(tmp_path, loop):
    """Preempted after step 2 of 4 (all in one dataset epoch for GRPO; DPO
    crosses an epoch at step 4), resumed by a fresh population: losses,
    fitnesses, actor and reference adapters and Adam moments equal the
    uninterrupted run's bit for bit."""
    make, run, method = ((_grpo_run, finetune_llm_reasoning, "step") if "GRPO" in loop
                         else (_dpo_run, finetune_llm_preference, "reset"))
    env, pop = make("torch")
    ref_pop, ref_fit, ref_losses = _llm_go(
        run, env, pop, TR.Resilience(tmp_path / "ref", handle_signals=False),
        evaluation_interval=2)
    env, pop = make("torch")
    res = TR.Resilience(tmp_path / "v", handle_signals=False)
    # the request comes during step 2: its boundary takes the snapshot
    _, _, losses = _llm_go(run, _PreemptAfter(env, res.guard, 2, method), pop, res,
                           evaluation_interval=2)
    snaps = res.manager.snapshots()
    assert [(s.kind, s.step) for s in snaps] == [("preempt", 2)]
    env, pop = make("torch")
    new_pop, fit, more = _llm_go(run, env, pop, TR.Resilience(tmp_path / "v",
                                                                handle_signals=False),
                                 resume=True, evaluation_interval=2)
    assert losses + more == ref_losses and fit == ref_fit
    assert len(ref_losses) == 4 * len(pop) and any(x != 0.0 for x in ref_losses)
    got, want = _llm_state(new_pop), _llm_state(ref_pop)
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_jax_grpo_resume_diverges_where_the_port_does_not(tmp_path):
    """The same mid-epoch recipe in the JAX package: a snapshot after step 2
    (the cadence one; the step-4 snapshot removed so that resume lands on
    it) resumes with the reference re-copied from the restored actor, so
    steps 3-4 and the final adapters leave the uninterrupted run. The port's
    test above holds its own resume bit-equal."""
    import shutil

    JR = _jax()
    from agilerl_tpu.training.train_llm import finetune_llm_reasoning as j_loop

    env, pop = _grpo_run("jax")
    res = JR.Resilience(tmp_path / "j", save_every=2, keep_last=5, handle_signals=False)
    ref_pop, _, ref_losses = _llm_go(j_loop, env, pop, res, pkg="jax", evaluation_interval=4)
    snaps = res.manager.snapshots()
    assert [s.step for s in snaps] == [2, 4]
    shutil.rmtree(snaps[-1].path)
    env, pop = _grpo_run("jax")
    new_pop, _, losses = _llm_go(j_loop, env, pop, JR.Resilience(tmp_path / "j",
                                                                 handle_signals=False),
                                 pkg="jax", resume=True, evaluation_interval=4)
    assert len(losses) == 2 and losses != ref_losses[2:]

    def gap(name):
        a = [np.asarray(x) for x in tree_leaves_jax(getattr(ref_pop[0], name).params)]
        b = [np.asarray(x) for x in tree_leaves_jax(getattr(new_pop[0], name).params)]
        return max(float(np.max(np.abs(x - y))) for x, y in zip(a, b))

    assert gap("reference") > 1e-3 and gap("actor") > 0.0


def tree_leaves_jax(tree):
    import jax

    return jax.tree_util.tree_leaves(tree)


def test_grpo_snapshot_holds_no_base_and_refuses_another_base(tmp_path):
    env, pop = _grpo_run("torch")
    res = TR.Resilience(tmp_path, handle_signals=False)
    res.attach(pop=pop, env=env)
    path = res.snapshot(step=1)
    with open(path / "population.pkl", "rb") as f:
        blob = pickle.load(f)[0]
    assert blob["ckpt"]["init_dict"]["base_params"] is None
    assert blob["ckpt"]["reference"]["epoch"] == -1
    base_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(pop[0].base_params))
    adapter_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(pop[0].actor.params))
    assert (path / "population.pkl").stat().st_size < base_bytes
    assert (path / "population.pkl").stat().st_size > 4 * adapter_bytes  # actor, ref, m, v
    assert [e[0] for e in blob["base_fingerprint"]] == [
        e[0] for e in TR.base_fingerprint(pop[0].base_params)]
    res.close()
    # the same agent restores; another base (vocab 40, or bf16) raises
    res2 = TR.Resilience(tmp_path, handle_signals=False)
    res2.attach(pop=pop, env=env)
    res2.resume()
    for change in (dict(vocab_size=40), dict(dtype=torch.bfloat16)):
        cfg = TM.GPTConfig(**dict(dict(vocab_size=TOK.vocab_size, n_layer=1, n_head=2,
                                       d_model=32, max_seq_len=48, dtype=torch.float32),
                                  **change))
        other = [GRPO(config=cfg, pad_token_id=TOK.pad_token_id,
                      eos_token_id=TOK.eos_token_id, group_size=2, batch_size=4,
                      max_output_tokens=2, seed=0, device="cpu")]
        res3 = TR.Resilience(tmp_path, handle_signals=False)
        res3.attach(pop=other, env=env)
        with pytest.raises(ValueError, match="fingerprint"):
            res3.resume()


def test_llm_loops_run_every_hook(tmp_path):
    """telemetry= (step events carry MFU), checkpoint_interval /
    checkpoint_path (self-contained files that load rebuilds the agent
    from, the frozen base included), save_elite and resume from the
    population checkpoints; wb=True runs (wandb does not import here: the
    loop logs to its sink only, as the JAX loop does)."""
    from agilerl_tpu_torch.observability import MetricsRegistry, RunTelemetry
    from agilerl_tpu_torch.observability.events import MemorySink

    env, pop = _grpo_run("torch")
    pop.append(pop[0].clone(index=1))
    sink = MemorySink()
    telem = RunTelemetry(registry=MetricsRegistry(sink=sink))
    ckpt = str(tmp_path / "ckpt" / "grpo")
    tournament = TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0))
    mutation = Mutations(no_mutation=0.5, architecture=0.0, parameters=0.0, activation=0.0,
                         rl_hp=0.5, rand_seed=0)
    new_pop, fit = finetune_llm_reasoning(
        pop, env, max_steps=2, evaluation_interval=2, verbose=False, telemetry=telem,
        checkpoint_interval=1, checkpoint_path=ckpt, overwrite_checkpoints=True,
        tournament=tournament, mutation=mutation, save_elite=True, elite_path=str(tmp_path))
    steps = [e for e in sink.events if e["kind"] == "step"]
    # the timeline holds the model's config, so a card run emits MFU (the
    # CPU has no peak rate, so no MFU here)
    assert telem.timeline.model_config is pop[0].model_config
    assert steps and all(e["tokens_per_sec"] > 0 for e in steps)
    assert (tmp_path / "GRPO_elite.ckpt").exists()
    for agent in new_pop:
        loaded = GRPO.load(tmp_path / "ckpt" / f"grpo_{agent.index}.ckpt", device="cpu")
        for a, b in zip(tree_leaves(loaded.base_params) + tree_leaves(loaded.actor.params)
                        + tree_leaves(loaded.reference.params),
                        tree_leaves(agent.base_params) + tree_leaves(agent.actor.params)
                        + tree_leaves(agent.reference.params)):
            assert torch.equal(a, b)
        assert loaded._reference_epoch == agent._reference_epoch
    env, fresh = _grpo_run("torch")
    fresh.append(fresh[0].clone(index=1))
    fresh, _ = finetune_llm_reasoning(fresh, env, max_steps=0, verbose=False, resume=True,
                                      checkpoint_path=ckpt)
    # each member resumes from the file of its index (the tournament's clone
    # took a new one)
    saved = {a.index: a for a in new_pop}
    pairs = [(a, saved[a.index]) for a in fresh if a.index in saved]
    assert pairs
    for a, b in pairs:
        for x, y in zip(tree_leaves(a.actor.params) + tree_leaves(a.reference.params),
                        tree_leaves(b.actor.params) + tree_leaves(b.reference.params)):
            assert torch.equal(x, y)
    _, fit = finetune_llm_reasoning(pop, env, max_steps=1, verbose=False, wb=True)
    assert fit == [[], []]
