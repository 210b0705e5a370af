"""The port's elastic PBT (``parallel/elastic.py``, ``training/train_elastic.py``)
on the port's EvoDQN and EvoPPO at the widths of the JAX package's
``tests/test_parallel/test_elastic.py`` and ``test_elastic_trace.py``: a
scripted host kill recovers a bit-identical stream, best restore, leader
failover, a corrupt best snapshot, all hosts lost, an undersized
``generation_timeout``, shrink then grow, capacity beyond target, the
islands, resume, the entry point, the layout guards and the span trees,
in the one-process emulation (one slot per emulated device).

The streams cannot replay the JAX package's (another RNG), so they are
held against themselves: killed against unkilled, resumed against
uninterrupted, an unkilled controller against ``ScanRun`` and the pod mode
on 2 gloo ranks against the emulation. The decisions are held against the
JAX controller: for the same fitness and seed, the layout, the evicted
members, the clones' parents and every member id are the JAX package's."""

import json
import pickle

import numpy as np
import pytest
import torch

from agilerl_tpu_torch.algorithms.core.optimizer import adam
from agilerl_tpu_torch.envs.classic import CartPole
from agilerl_tpu_torch.modules.mlp import MLPConfig
from agilerl_tpu_torch.networks import distributions as D
from agilerl_tpu_torch.networks.base import NetworkConfig, default_encoder_config
from agilerl_tpu_torch.observability import MemorySink, MetricsRegistry, Tracer
from agilerl_tpu_torch.parallel import (
    ElasticPBTController,
    EvoDQN,
    EvoPPO,
    IslandConfig,
    ScanRun,
    device_slots,
    make_emulated_hosts,
)
from agilerl_tpu_torch.parallel.generation import population_state_dict
from agilerl_tpu_torch.resilience import FaultInjector, MembershipChange
from agilerl_tpu_torch.training import train_elastic_pbt

torch.set_num_threads(1)

HEARTBEAT = 0.15  # tiny lease so loss detection stays fast in tests
SLOTS = device_slots(8, "cpu")


class ListSink:
    def __init__(self):
        self.events = []

    def emit(self, kind, fields):
        self.events.append((kind, dict(fields)))

    def flush(self):
        pass


def _registry():
    return MetricsRegistry(sink=ListSink())


@pytest.fixture(autouse=True)
def _isolated_plan_registries():
    """The controllers register population plans in the process-wide plan
    registries (the port's, and the JAX package's in the decision test):
    each test leaves both as it found them."""
    from agilerl_tpu_torch.parallel import plan as TPL

    saved = dict(TPL._REGISTRY)
    try:
        from agilerl_tpu.parallel import plan as JPL

        jsaved = dict(JPL._REGISTRY)
    except ImportError:
        JPL = None
    yield
    TPL._REGISTRY.clear()
    TPL._REGISTRY.update(saved)
    if JPL is not None:
        JPL._REGISTRY.clear()
        JPL._REGISTRY.update(jsaved)


def _net(env, outputs, latent=16, hidden=32):
    kind, enc = default_encoder_config(env.observation_space, latent_dim=latent,
                                       encoder_config={"hidden_size": (hidden,)})
    return NetworkConfig(encoder_kind=kind, encoder=enc,
                         head=MLPConfig(num_inputs=latent, num_outputs=outputs,
                                        hidden_size=(hidden,)), latent_dim=latent)


def _dqn():
    env = CartPole()
    return EvoDQN(env, _net(env, 2), adam(1e-3), num_envs=2, steps_per_iter=8, buffer_size=64,
                  batch_size=4, device="cpu")


def _ppo():
    env = CartPole()
    return EvoPPO(env, _net(env, 2), _net(env, 1), D.dist_config_from_space(env.action_space),
                  adam(3e-4), num_envs=2, rollout_len=8, update_epochs=1, num_minibatches=2,
                  device="cpu")


def _controller(engine, store, *, n_hosts=2, n_devices=4, pop=4, seed=3, **kw):
    kw.setdefault("registry", _registry())
    return ElasticPBTController(engine, pop, store, seed=seed,
                                hosts=make_emulated_hosts(n_hosts, SLOTS[:n_devices]),
                                heartbeat_timeout=HEARTBEAT, **kw)


@pytest.fixture(scope="module")
def dqn_ref_hist(tmp_path_factory):
    """Unkilled 4-generation stream (pop 4 over 2 hosts x 2 slots): the
    comparison target of every kill scenario. Its controller's population
    plan leaves the registry with the run (this fixture is set up before
    the per-test isolation saves the registry)."""
    from agilerl_tpu_torch.parallel import plan as TPL

    saved = dict(TPL._REGISTRY)
    try:
        return _controller(_dqn(), tmp_path_factory.mktemp("dqn_ref")).run(4)
    finally:
        TPL._REGISTRY.clear()
        TPL._REGISTRY.update(saved)


def _leaves_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(population_state_dict(a)["leaves"],
                                                    population_state_dict(b)["leaves"]))


# --------------------------------------------------------------------------- #
# host loss at a generation boundary
# --------------------------------------------------------------------------- #


class TestHostLoss:
    def test_unkilled_stream_is_scanrun(self, tmp_path, dqn_ref_hist):
        """The controller seeds its generator and population as ``ScanRun``
        does: unkilled, its stream and members are ScanRun's bit for bit."""
        run = ScanRun(_dqn(), 4, seed=3)
        assert run.run(4).tolist() == dqn_ref_hist
        ctl = _controller(_dqn(), tmp_path)
        ctl.run(4)
        assert _leaves_equal(ctl.pop, run.pop)

    def test_kill_recovers_bit_identical_stream(self, tmp_path, dqn_ref_hist):
        """Host 1 dies at generation boundary 2: the survivors re-form on 2
        slots (2 members each: zero idle slots), the lost members come back
        from the boundary snapshot, and the whole fitness stream is the
        unkilled run's bit for bit."""
        reg = _registry()
        inj = FaultInjector(kill_host_at={2: 1})
        ctl = _controller(_dqn(), tmp_path, fault_injector=inj, registry=reg,
                          restore_from="latest")
        assert ctl.run(4) == dqn_ref_hist
        assert inj.hosts_killed == [(2, 1)]
        assert ctl.layout() == {"devices": 2, "pop": 4, "members_per_device": 2}
        assert reg.counter("resilience/collective_timeouts_total").value >= 1
        assert reg.counter("resilience/hosts_lost_total").value == 1
        assert reg.counter("elastic/members_restored_total").value == 2
        assert reg.counter("resilience/recoveries_total").value == 1
        assert np.isfinite(reg.gauge("elastic/mttr_s").value)
        kinds = [k for k, _ in reg.sink.events]
        assert "elastic_recovery" in kinds and "elastic_mttr" in kinds

    def test_best_restore_survivors_identical_and_deterministic(self, tmp_path, dqn_ref_hist):
        """Best-fitness restore: two scripted runs agree exactly, and the
        survivors (host 0's slots 0-1) keep the unkilled stream up to the
        first generation after the kill (their fitness is read before the
        tournament mixes the restored members in)."""
        runs = []
        for sub in ("a", "b"):
            ctl = _controller(_dqn(), tmp_path / sub,
                              fault_injector=FaultInjector(kill_host_at={2: 1}))
            runs.append(ctl.run(4))
        assert runs[0] == runs[1]
        for row_ref, row_kill in zip(dqn_ref_hist[:3], runs[0][:3]):
            assert row_ref[:2] == row_kill[:2]

    def test_kill_leader_host_fails_over(self, tmp_path):
        ctl = _controller(_dqn(), tmp_path, fault_injector=FaultInjector(kill_host_at={1: 0}))
        assert len(ctl.run(3)) == 3
        ctl._heartbeat()
        assert ctl.membership.leader() == 1
        assert ctl.manager.latest().step == 3  # the new leader kept committing

    def test_corrupt_best_snapshot_falls_back_to_validated_walk(self, tmp_path):
        reg = _registry()
        ctl = _controller(_dqn(), tmp_path, registry=reg,
                          fault_injector=FaultInjector(kill_host_at={2: 1}))
        ctl.run(2)
        pkl = ctl.manager.best().path / "population.pkl"
        pkl.write_bytes(pkl.read_bytes()[: max(1, pkl.stat().st_size // 2)])
        with pytest.warns(RuntimeWarning):  # the snapshot-corrupt fallback warns
            ctl.run(2)
        assert reg.counter("elastic/members_restored_total").value == 2
        assert reg.counter("elastic/members_reinitialized_total").value == 0
        assert reg.counter("resilience/restore_fallbacks_total").value >= 1

    def test_all_hosts_lost_raises_membership_change(self, tmp_path):
        ctl = _controller(_dqn(), tmp_path)
        ctl.run(1)
        ctl.kill_host(0)
        ctl.kill_host(1)
        with pytest.raises(MembershipChange, match="all hosts lost"):
            ctl.run(1)

    def test_undersized_generation_timeout_errors_not_livelocks(self, tmp_path, monkeypatch):
        import time as _time

        ctl = _controller(_dqn(), tmp_path, max_dispatch_retries=1)
        ctl.run(1)  # a committed snapshot at the boundary
        ctl.generation_timeout = 0.05
        monkeypatch.setattr(ctl, "_dispatch", lambda: _time.sleep(5))
        with pytest.raises(MembershipChange, match="2 times in a row"):
            ctl.step_generation()

    def test_dispatch_changes_nothing_on_the_controller(self, tmp_path):
        """The off-policy engine writes its rings in place, but the dispatch
        runs on copies: the boundary state is untouched until the commit."""
        ctl = _controller(_dqn(), tmp_path)
        ctl.run(1)
        before = population_state_dict(ctl.pop)["leaves"]
        state = ctl._gen.get_state().clone()
        ctl._dispatch()
        assert all(np.array_equal(a, b)
                   for a, b in zip(before, population_state_dict(ctl.pop)["leaves"]))
        assert torch.equal(state, ctl._gen.get_state())

    def test_ppo_kill_recovers_bit_identical_stream(self, tmp_path):
        ref_hist = _controller(_ppo(), tmp_path / "ref").run(4)
        ctl = _controller(_ppo(), tmp_path / "kill",
                          fault_injector=FaultInjector(kill_host_at={2: 1}),
                          restore_from="latest")
        assert ctl.run(4) == ref_hist
        assert ctl.layout() == {"devices": 2, "pop": 4, "members_per_device": 2}


# --------------------------------------------------------------------------- #
# elastic resize
# --------------------------------------------------------------------------- #


class TestElasticResize:
    def _run_shrink_grow(self, store):
        reg = _registry()
        ctl = _controller(_dqn(), store, n_hosts=4, n_devices=4, registry=reg)
        ctl.run(2)
        ids_before = list(ctl.member_ids)
        fit_before = np.nan_to_num(np.asarray(ctl.fitness), nan=-np.inf)
        ctl.kill_host(3)
        ctl.run(1)  # shrink: 4 slots -> 3, pop 4 -> 3
        shrink_layout = dict(ctl.layout())
        ids_shrunk = list(ctl.member_ids)
        ctl.revive_host(3)
        ctl.run(1)  # grow: back to 4 slots, pop 3 -> 4
        return reg, ctl, ids_before, fit_before, shrink_layout, ids_shrunk

    def test_shrink_evicts_worst_then_grow_clones_winner(self, tmp_path):
        reg, ctl, ids_before, fit_before, shrink_layout, ids_shrunk = \
            self._run_shrink_grow(tmp_path)
        assert shrink_layout == {"devices": 3, "pop": 3, "members_per_device": 1}
        evicted = set(ids_before) - set(ids_shrunk)
        assert len(evicted) == 1
        assert fit_before[ids_before.index(evicted.pop())] == fit_before.min()
        assert ctl.layout() == {"devices": 4, "pop": 4, "members_per_device": 1}
        assert len(set(ctl.member_ids)) == 4 and max(ctl.member_ids) >= len(ids_before)
        assert reg.counter("elastic/members_evicted_total").value == 1
        assert reg.counter("elastic/members_cloned_total").value == 1
        lineage = [f for k, f in reg.sink.events if k == "elastic_lineage"]
        assert {e["op"] for e in lineage} >= {"evict", "clone"}
        resizes = [f for k, f in reg.sink.events if k == "elastic_resize"]
        assert [r["op"] for r in resizes] == ["shrink", "grow"]

    def test_shrink_grow_is_deterministic(self, tmp_path):
        _, c1, *_ = self._run_shrink_grow(tmp_path / "a")
        _, c2, *_ = self._run_shrink_grow(tmp_path / "b")
        assert c1.fitness_history == c2.fitness_history
        assert c1.member_id_history == c2.member_id_history
        assert _leaves_equal(c1.pop, c2.pop)

    def test_capacity_beyond_target_grows_population(self, tmp_path):
        ctl = _controller(_dqn(), tmp_path, n_hosts=2, n_devices=2, pop=2)
        ctl.run(1)
        ctl.hosts.extend(make_emulated_hosts(2, SLOTS[2:4]))
        for h in ctl.hosts[2:]:
            h.host_id += 2  # ids 2, 3
        ctl.run(1)
        assert ctl.layout() == {"devices": 4, "pop": 4, "members_per_device": 1}


# --------------------------------------------------------------------------- #
# decisions against the JAX controller
# --------------------------------------------------------------------------- #


class _TorchScoreEngine:
    """A population whose fitness is a fixed per-member score (ties
    included): the decisions alone, on the port's controller."""

    device = torch.device("cpu")

    def init_population(self, gen, pop_size):
        P = int(pop_size)
        return {"score": torch.as_tensor((np.arange(P) * 5 % 7).astype(np.float32)),
                "w": torch.arange(P * 3, dtype=torch.float32).reshape(P, 3)}

    def make_vmap_generation(self):
        return lambda pop, gen: (pop, pop["score"].clone())


def _jax_score_engine():
    jnp = pytest.importorskip("jax.numpy")

    class Engine:
        def init_population(self, key, pop_size):
            P = int(pop_size)
            return {"score": jnp.asarray((np.arange(P) * 5 % 7).astype(np.float32)),
                    "w": jnp.arange(P * 3, dtype=jnp.float32).reshape(P, 3)}

        def make_pod_generation(self, mesh=None, plan=None):
            return lambda pop, key: (pop, pop["score"])

    return Engine()


def _decisions(ctl):
    """Run the scenario: 4 hosts x 1 slot at pop 8, then host 3 lost
    (recovery restores its rows from the best snapshot and shrinks 8 -> 6),
    host 3 back (grows 6 -> 8 with the tournament RNG), then hosts 1 and 2
    lost (shrinks to 4) and both back."""
    out = []

    def record():
        out.append((dict(ctl.layout()), list(ctl.member_ids)))

    ctl.run(1)
    record()
    ctl.kill_host(3)
    ctl.run(1)
    record()
    ctl.revive_host(3)
    ctl.run(1)
    record()
    ctl.kill_host(1)
    ctl.kill_host(2)
    ctl.run(1)
    record()
    ctl.revive_host(1)
    ctl.revive_host(2)
    ctl.run(1)
    record()
    events = [(k, {f: v for f, v in e.items() if f in ("op", "member", "parent", "evicted")})
              for k, e in ctl.registry.sink.events if k in ("elastic_lineage", "elastic_resize")]
    return out, events, ctl.member_id_history, ctl._np_rng.bit_generator.state


def test_decisions_match_the_jax_controller(tmp_path):
    jax = pytest.importorskip("jax")
    from agilerl_tpu.observability.registry import MetricsRegistry as JRegistry
    from agilerl_tpu.parallel.elastic import ElasticPBTController as JController
    from agilerl_tpu.parallel.elastic import make_emulated_hosts as j_hosts

    jctl = JController(_jax_score_engine(), 8, tmp_path / "jax", seed=5,
                       hosts=j_hosts(4, jax.devices()[:4]), heartbeat_timeout=HEARTBEAT,
                       registry=JRegistry(sink=ListSink()))
    tctl = ElasticPBTController(_TorchScoreEngine(), 8, tmp_path / "torch", seed=5,
                                hosts=make_emulated_hosts(4, SLOTS[:4]),
                                heartbeat_timeout=HEARTBEAT, registry=_registry())
    want, got = _decisions(jctl), _decisions(tctl)
    assert [lay for lay, _ in got[0]] == [lay for lay, _ in want[0]]
    assert got[0] == want[0]  # layouts and member ids after every step
    assert got[1] == want[1]  # evictions, clones (with parents), resizes
    assert got[2] == want[2]  # member-id history
    assert got[3] == want[3]  # the resize RNG's state
    assert {e["op"] for _, e in got[1]} >= {"evict", "clone"}


# --------------------------------------------------------------------------- #
# island migration
# --------------------------------------------------------------------------- #


class TestIslandMigration:
    def test_export_import_roundtrip(self, tmp_path):
        ex = tmp_path / "exchange"
        reg_a, reg_b = _registry(), _registry()
        a = _controller(_dqn(), tmp_path / "a", n_hosts=1, n_devices=2, pop=2, seed=1,
                        registry=reg_a, island=IslandConfig("A", ex, top_k=1, every=1))
        b = _controller(_dqn(), tmp_path / "b", n_hosts=1, n_devices=2, pop=2, seed=9,
                        registry=reg_b, island=IslandConfig("B", ex, top_k=1, every=1))
        a.run(1)  # exports A@1
        exports = list((ex / "island_A").iterdir())
        assert len(exports) == 1
        manifest = json.loads((exports[0] / "manifest.json").read_text())
        assert manifest["island"] == "A" and manifest["members"] == 1
        assert len(manifest["fitness"]) == 1
        assert reg_a.counter("elastic/migrations_exported_total").value == 1

        ids_before = list(b.member_ids)
        b.run(1)  # exports B@1, imports A@1 when it beats B's worst
        a_best = manifest["fitness"][0]
        b_worst = min(b.fitness_history[0])
        if a_best is not None and a_best > b_worst:
            assert reg_b.counter("elastic/migrations_imported_total").value == 1
            new_ids = set(b.member_ids) - set(ids_before)
            assert len(new_ids) == 1  # the migrant got a fresh lineage id
            migrations = [f for k, f in reg_b.sink.events
                          if k == "elastic_lineage" and f["op"] == "migrate"]
            assert migrations and migrations[0]["source_island"] == "island_A"
            # the imported member is the exported row, bit for bit
            payload = pickle.loads((exports[0] / "members.pkl").read_bytes())
            slot = b.member_ids.index(new_ids.pop())
            for mine, theirs in zip(population_state_dict(b.pop)["leaves"], payload["leaves"]):
                if np.ndim(mine) == 0:
                    assert mine == theirs  # a host value, the same for every member
                else:
                    np.testing.assert_array_equal(mine[slot], np.asarray(theirs)[0])
        else:
            assert reg_b.counter("elastic/migrations_imported_total").value == 0

    def test_torn_export_skip_and_warn(self, tmp_path):
        ex = tmp_path / "exchange"
        inj = FaultInjector(truncate_at_ops=[0], match=("wrote",), path_match="members.pkl")
        with inj:
            a = _controller(_dqn(), tmp_path / "a", n_hosts=1, n_devices=2, pop=2, seed=1,
                            island=IslandConfig("A", ex, every=1))
            a.run(1)  # the export payload is truncated
        reg_b = _registry()
        b = _controller(_dqn(), tmp_path / "b", n_hosts=1, n_devices=2, pop=2, seed=9,
                        registry=reg_b, island=IslandConfig("B", ex, every=1))
        ids_before = list(b.member_ids)
        with pytest.warns(RuntimeWarning, match="failed hash validation"):
            b.run(1)
        assert reg_b.counter("elastic/torn_imports_total").value == 1
        assert reg_b.counter("elastic/migrations_imported_total").value == 0
        assert b.member_ids == ids_before

    def test_same_export_imported_once(self, tmp_path):
        ex = tmp_path / "exchange"
        reg_b = _registry()
        a = _controller(_dqn(), tmp_path / "a", n_hosts=1, n_devices=2, pop=2, seed=1,
                        island=IslandConfig("A", ex, every=1))
        a.run(1)
        b = _controller(_dqn(), tmp_path / "b", n_hosts=1, n_devices=2, pop=2, seed=9,
                        registry=reg_b, island=IslandConfig("B", ex, every=1))
        b.run(2)  # sees A@1 twice; imports it at most once
        assert reg_b.counter("elastic/migrations_imported_total").value <= 1


# --------------------------------------------------------------------------- #
# restart-resume, the entry point, the guards
# --------------------------------------------------------------------------- #


class TestResumeAndWiring:
    def test_restart_resume_continues_exact_stream(self, tmp_path):
        h1 = _controller(_dqn(), tmp_path / "run").run(3)
        ctl = _controller(_dqn(), tmp_path / "run")
        assert ctl.resume()
        h2 = ctl.run(2)
        ref = _controller(_dqn(), tmp_path / "ref")
        assert h1 + h2 == ref.run(5)
        assert _leaves_equal(ctl.pop, ref.pop)

    def test_train_elastic_pbt_entry_point(self, tmp_path):
        ctl = train_elastic_pbt(_dqn(), 4, 2, tmp_path, hosts=make_emulated_hosts(2, SLOTS[:4]),
                                heartbeat_timeout=HEARTBEAT, seed=3)
        assert ctl.generation == 2 and len(ctl.fitness_history) == 2
        ctl2 = train_elastic_pbt(_dqn(), 4, 1, tmp_path, hosts=make_emulated_hosts(2, SLOTS[:4]),
                                 heartbeat_timeout=HEARTBEAT, seed=3, resume=True)
        assert ctl2.generation == 3

    def test_layout_guards(self, tmp_path):
        with pytest.raises(ValueError, match="multiple of"):
            _controller(_dqn(), tmp_path, n_hosts=3, n_devices=3, pop=4)
        with pytest.raises(ValueError, match="evenly"):
            make_emulated_hosts(3, SLOTS[:4])
        with pytest.raises(ValueError, match="restore_from"):
            _controller(_dqn(), tmp_path, restore_from="newest")
        with pytest.raises(NotImplementedError, match="compile_cache"):
            _controller(_dqn(), tmp_path, compile_cache="store")
        # slots are distinct values: one host's never match another's
        hosts = make_emulated_hosts(2, SLOTS[:4])
        assert not set(hosts[0].devices) & set(hosts[1].devices)


def test_pod_mode_on_two_ranks_equals_the_emulation(tmp_path):
    """One controller per gloo rank (pod mode, one slot a rank, a
    generation_timeout), EvoPPO at pop 8: the stream equals the one-process
    emulation's bit for bit, rank 0 commits every snapshot with the whole
    population, and a world-size-1 controller resumed from that store
    continues the emulated stream bit for bit."""
    from tests.torch_dist_cases import evoppo
    from tests.torch_dist_harness import RankPool

    pool = RankPool(2)
    try:
        res = pool.run("elastic_pod", pop=8, generations=3, store=str(tmp_path / "pod"))
    finally:
        pool.close()
    ref = ElasticPBTController(evoppo(), 8, tmp_path / "emu", seed=0,
                               hosts=make_emulated_hosts(2, SLOTS[:2]), registry=_registry())
    want = ref.run(5)
    for r in res:
        assert r["hist"] == want[:3]
        assert r["layout"] == {"devices": 2, "pop": 8, "members_per_device": 4}
        assert r["ids"] == list(range(8))
    assert res[0]["snapshots"] == [1, 2, 3]
    back = ElasticPBTController(evoppo(), 8, tmp_path / "pod", seed=0,
                                hosts=make_emulated_hosts(1, SLOTS[:1]), registry=_registry())
    assert back.resume() and back.generation == 3
    assert back.run(2) == want[3:]
    assert _leaves_equal(back.pop, ref.pop)


# --------------------------------------------------------------------------- #
# spans
# --------------------------------------------------------------------------- #


def _spans(sink):
    return [e for e in sink.events if e["kind"] == "span"]


def _traced(tmp_path, sink, sample_rate=1.0, pop=4, **kw):
    tracer = Tracer(sink=sink, sample_rate=sample_rate, pod="pbt0", metrics=MetricsRegistry())
    return ElasticPBTController(_dqn(), pop_size=pop, store_dir=tmp_path / "store", seed=0,
                                hosts=make_emulated_hosts(2, SLOTS[:4]),
                                heartbeat_timeout=HEARTBEAT, snapshot_every=1,
                                registry=MetricsRegistry(sink=ListSink()), tracer=tracer, **kw)


class TestSpans:
    def test_generation_phases_and_host_loss_recovery_spans(self, tmp_path):
        sink = MemorySink()
        ctrl = _traced(tmp_path, sink)
        ctrl.run(1)
        spans = _spans(sink)
        gens = [s for s in spans if s["name"] == "elastic.generation"]
        assert len(gens) == 1 and gens[0]["parent_id"] is None
        by_id = {s["span_id"]: s for s in spans}
        dispatch = next(s for s in spans if s["name"] == "elastic.dispatch")
        snap = next(s for s in spans if s["name"] == "elastic.snapshot")
        assert by_id[dispatch["parent_id"]]["name"] == "elastic.generation"
        assert by_id[snap["parent_id"]]["name"] == "elastic.generation"
        assert all(s["status"] == "ok" for s in spans)
        sink.events.clear()
        ctrl.kill_host(1)
        ctrl.run(1)
        spans = _spans(sink)
        rec = next(s for s in spans if s["name"] == "elastic.recovery")
        assert rec["status"] == "error" and "host loss" in rec["status_message"]
        assert rec["attributes"]["lost"] == [1]
        gen = next(s for s in spans if s["name"] == "elastic.generation")
        assert rec["trace_id"] == gen["trace_id"] and gen["status"] == "ok"
        dispatch = next(s for s in spans if s["name"] == "elastic.dispatch")
        assert dispatch["trace_id"] == gen["trace_id"]

    def test_recovery_span_is_forced_at_zero_sample_rate(self, tmp_path):
        sink = MemorySink()
        ctrl = _traced(tmp_path, sink, sample_rate=0.0)
        ctrl.run(1)
        assert _spans(sink) == []
        ctrl.kill_host(1)
        ctrl.run(1)
        rec = next(s for s in _spans(sink) if s["name"] == "elastic.recovery")
        assert rec["status"] == "error"

    def test_grow_records_tournament_and_mutation_spans(self, tmp_path):
        sink = MemorySink()
        ctrl = _traced(tmp_path, sink, pop=8, max_members_per_device=2)
        ctrl.run(1)
        ctrl.kill_host(1)  # 4 slots -> 2: shrink 8 -> 4
        ctrl.run(1)
        sink.events.clear()
        ctrl.revive_host(1)  # capacity back: grow 4 -> 8 by clone + mutate
        ctrl.run(1)
        spans = _spans(sink)
        by_id = {s["span_id"]: s for s in spans}
        resize = [s for s in spans if s["name"] == "elastic.resize"]
        assert any(s["attributes"]["op"] == "grow" for s in resize)
        tournaments = [s for s in spans if s["name"] == "elastic.tournament"]
        mutations = [s for s in spans if s["name"] == "elastic.mutation"]
        assert len(tournaments) == 4 and len(mutations) == 4
        for s in tournaments + mutations:
            assert by_id[s["parent_id"]]["name"] == "elastic.resize"
