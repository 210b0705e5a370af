"""Parity of the port's traffic harness (agilerl_tpu_torch.benchmarking.traffic)
with the JAX package's, on the CPU: ``generate_trace`` and ``scenario_suite``
equal to the JAX traces for the same spec and seed (exact: both draw numpy
from one generator); a trace saved by one package loads in the other; the
rate curves, the clip to the grid and the schema gate; and the
``TrafficDriver`` over a tiny port ``ServingFleet`` against the JAX driver
over the JAX fleet on carried weights, greedy: the same completions token for
token, the same submit schedule (submitted, shed, completed, steps, delivered
tokens) in open and closed loop, and the same failover outcome and autoscale
reaction under a ``kill_host_at`` during a flash crowd. Each test imports the
JAX modules it compares with inside the test."""

import math

import numpy as np
import pytest
import torch

from agilerl_tpu_torch.benchmarking import traffic as TT
from agilerl_tpu_torch.llm import model as TM
from agilerl_tpu_torch.llm.autoscale import AutoscalePolicy
from agilerl_tpu_torch.llm.convert import params_from_numpy
from agilerl_tpu_torch.llm.fleet import ServingFleet
from agilerl_tpu_torch.llm.serving import AdmissionPolicy
from agilerl_tpu_torch.observability import MetricsRegistry
from agilerl_tpu_torch.resilience.faults import FaultInjector

torch.set_num_threads(1)

MODEL = dict(vocab_size=96, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq_len=256)
KW = dict(max_new_tokens=8, pad_id=0, eos_id=None, prompt_buckets=(32,), slots=3,
          block_size=8, decode_chunk=4)
KINDS = ("steady", "diurnal", "flash_crowd", "prefix_skew")


def _jt():
    pytest.importorskip("jax")
    from agilerl_tpu.benchmarking import traffic as JT

    return JT


def _spec(T, **over):
    """A scenario sized to the test fleet's grid (test_traffic.py's)."""
    kw = dict(name="t", vocab=90, duration_s=4.0, base_rate_rps=3.0, min_prompt=4,
              max_prompt=24, min_new=1, max_new=8)
    kw.update(over)
    return T.ScenarioSpec(**kw)


def _records(reqs):
    return [r.to_record() for r in reqs]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 7])
def test_generate_trace_equals_jax(kind, seed):
    JT = _jt()
    over = dict(kind=kind, duration_s=12.0, base_rate_rps=5.0)
    got, want = TT.generate_trace(_spec(TT, **over), seed), JT.generate_trace(_spec(JT, **over),
                                                                              seed)
    assert got and _records(got) == _records(want)
    assert all(g.tokens.dtype == np.int32 for g in got)
    assert _records(got) != _records(TT.generate_trace(_spec(TT, **over), seed + 1))


def test_scenario_suite_equals_jax_and_covers_the_four_shapes():
    JT = _jt()
    kw = dict(vocab=90, duration_s=4.0, base_rate_rps=3.0, max_prompt=24, max_new=8)
    got, want = TT.scenario_suite(**kw), JT.scenario_suite(**kw)
    assert [s.to_dict() for s in got] == [s.to_dict() for s in want]
    assert [s.kind for s in got] == list(KINDS)
    for g, w in zip(got, want):
        assert _records(TT.generate_trace(g, 3)) == _records(JT.generate_trace(w, 3))
        assert TT.ScenarioSpec.from_dict(dict(g.to_dict(), future_knob=1)) == g


def test_rate_curves_clip_and_prefix_skew():
    di = _spec(TT, kind="diurnal", diurnal_period_s=4.0, diurnal_amplitude=0.8)
    assert math.isclose(di.rate_at(0.0), di.base_rate_rps)
    assert math.isclose(di.rate_at(2.0), di.peak_rate())
    fc = _spec(TT, kind="flash_crowd", duration_s=10.0, burst_start_s=4.0,
               burst_duration_s=2.0, burst_x=6.0)
    assert fc.rate_at(3.9) == fc.rate_at(6.0) == fc.base_rate_rps
    assert fc.rate_at(4.0) == 6.0 * fc.base_rate_rps
    reqs = TT.generate_trace(_spec(TT, duration_s=20.0, base_rate_rps=8.0), seed=1)
    assert len(reqs) > 50
    assert all(4 <= r.tokens.size <= 24 and 1 <= r.max_new <= 8 for r in reqs)
    skew = TT.generate_trace(_spec(TT, kind="prefix_skew", duration_s=15.0,
                                   base_rate_rps=6.0, prefix_len=10), seed=5)
    shared = [r for r in skew if r.shared_prefix]
    assert len(shared) > len(skew) * 0.4
    assert all(np.array_equal(r.tokens[:10], shared[0].tokens[:10]) for r in shared)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_a_trace_saved_by_one_package_loads_in_the_other(tmp_path, writer):
    JT = _jt()
    W, L = (TT, JT) if writer == "torch" else (JT, TT)
    spec = _spec(W, kind="prefix_skew")
    reqs = W.generate_trace(spec, seed=11)
    path = W.save_trace(tmp_path / "t.jsonl", reqs, spec=spec, seed=11)
    header = L.trace_header(path)
    assert header["schema"] == L.TRACE_SCHEMA == W.TRACE_SCHEMA
    assert header["seed"] == 11 and header["n_requests"] == len(reqs)
    assert L.ScenarioSpec.from_dict(header["spec"]).to_dict() == spec.to_dict()
    loaded = L.load_trace(path)
    assert _records(loaded) == _records(reqs)
    assert all(r.tokens.dtype == np.int32 for r in loaded)
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"kind": "trace_header", "schema": 999}\n')
    with pytest.raises(ValueError, match="schema"):
        TT.load_trace(bad)


# --------------------------------------------------------------------------- #
# the driver over a real fleet, against the JAX driver over the JAX fleet
# --------------------------------------------------------------------------- #


class Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def weights():
    """The JAX fleet test's weights, and the same as port tensors."""
    jax = pytest.importorskip("jax")
    from agilerl_tpu.llm import model as JM

    jcfg = JM.GPTConfig(dtype=jax.numpy.float32, **MODEL)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = TM.GPTConfig(dtype=torch.float32, **MODEL)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params


def _drive(pkg, weights, trace, driver_kw, fleet_kw=None, autoscale=None, kill=None):
    """One run of either package's driver over its own 2-replica fleet:
    (the run's outcome, each request's tokens)."""
    jcfg, jparams, cfg, params = weights
    fleet_kw = dict(KW, **(fleet_kw or {}))
    if pkg == "jax":
        from agilerl_tpu.benchmarking import traffic as T
        from agilerl_tpu.llm.autoscale import AutoscalePolicy as Policy
        from agilerl_tpu.llm.fleet import ServingFleet as Fleet
        from agilerl_tpu.llm.serving import AdmissionPolicy as Admission
        from agilerl_tpu.observability import MetricsRegistry as Registry
        from agilerl_tpu.resilience.faults import FaultInjector as Faults

        c, p, dev = jcfg, jparams, {}
    else:
        T, Policy, Fleet, Admission, Registry, Faults = (
            TT, AutoscalePolicy, ServingFleet, AdmissionPolicy, MetricsRegistry, FaultInjector)
        c, p, dev = cfg, params, {"device": "cpu"}
    if "max_queue_admission" in fleet_kw:
        fleet_kw["admission"] = Admission(max_queue=fleet_kw.pop("max_queue_admission"))
    fleet = Fleet(c, 2, metrics=Registry(), **dev, **fleet_kw)
    kw = dict(driver_kw)
    if autoscale is not None:
        clock = Clock()
        kw["autoscale"] = Policy(clock=clock, metrics=fleet.metrics, **autoscale)
        kw["on_step"] = lambda step, vnow: setattr(clock, "t", vnow)
    if kill is not None:
        kw["fault_injector"] = Faults(kill_host_at=kill)
    res = T.TrafficDriver(fleet, **kw).run(trace, p, greedy=True, collect_outputs=True)
    out = {k: v for k, v in res.to_dict().items() if k != "wall_s"}
    toks = {i: (np.asarray(t).tolist(), np.asarray(e).tolist())
            for i, (t, e) in res.outputs.items()}
    return out, toks, sorted(fleet.replica_ids)


def test_open_and_closed_loop_equal_the_jax_driver(weights):
    """Open loop (arrival-faithful, 8 steps per virtual second) and closed
    loop (concurrency 4): the same outcome counts and every request's tokens
    equal to the JAX driver's, greedy."""
    JT = _jt()
    for kw in (dict(steps_per_s=8.0, seed=0),
               dict(mode="closed", concurrency=4, steps_per_s=8.0, seed=2)):
        trace = TT.generate_trace(_spec(TT, kind="diurnal"), seed=kw["seed"])
        jtrace = JT.generate_trace(_spec(JT, kind="diurnal"), seed=kw["seed"])
        got, got_toks, _ = _drive("torch", weights, trace, kw)
        want, want_toks, _ = _drive("jax", weights, jtrace, kw)
        assert got == want
        assert got["submitted"] == got["completed"] == len(trace) and got["shed"] == 0
        assert got_toks == want_toks and len(got_toks) == len(trace)
    with pytest.raises(ValueError, match="mode"):
        TT.TrafficDriver(object(), mode="sideways", metrics=MetricsRegistry())


def test_kill_under_burst_fails_over_like_the_jax_driver(weights):
    """A replica dies one virtual second into a flash crowd: every accepted
    ticket completes (failover re-dispatch), the kill and the autoscaler's
    scale-up are recorded, all as the JAX driver records them, with the same
    tokens for every completed request."""
    JT = _jt()
    over = dict(kind="flash_crowd", duration_s=5.0, burst_start_s=1.5, burst_duration_s=1.5,
                burst_x=8.0)
    auto = dict(min_replicas=2, max_replicas=4, backlog_high=2.0, shed_rate_high=1.0,
                up_cooldown_s=1.0, down_cooldown_s=1e9)
    fleet_kw = dict(max_queue_admission=8, max_queue=3)
    args = dict(driver_kw=dict(steps_per_s=8.0, seed=6), fleet_kw=fleet_kw, autoscale=auto,
                kill={2: 1})
    got, got_toks, got_ids = _drive("torch", weights, TT.generate_trace(_spec(TT, **over), 6),
                                    **args)
    want, want_toks, want_ids = _drive("jax", weights,
                                       JT.generate_trace(_spec(JT, **over), 6), **args)
    assert got == want and got_toks == want_toks and got_ids == want_ids
    assert got["kills"] == [{"virtual_s": 2.0, "replica": 1}]
    assert got["completed"] == got["submitted"]
    assert got["completed"] + got["shed"] == got["n_requests"]
    assert [e for e in got["scale_events"] if e["action"] == "up"]
    assert 1 not in got_ids and max(got_ids) >= 2
