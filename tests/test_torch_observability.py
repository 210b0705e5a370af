"""Parity of the port's observability modules (agilerl_tpu_torch.observability:
events, lineage, timeline, facade, export, slo; and utils/log_utils,
utils/profiling) with the JAX package's, on the CPU: the same inputs give
the same records, genealogies, merged dumps, Prometheus text, burn-rate
alerts and grades. Timestamps and per-run ids are dropped before comparing.
Each test imports the JAX module it mirrors inside the test."""

import json

import numpy as np
import pytest
import torch

from agilerl_tpu_torch import observability as TO
from agilerl_tpu_torch.llm import model as TM
from agilerl_tpu_torch.utils import log_utils as TL, profiling as TP


def _jo():
    pytest.importorskip("jax")
    from agilerl_tpu import observability as JO

    return JO


def _strip(events, drop=("ts",)):
    return [{k: v for k, v in e.items() if k not in drop} for e in events]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _events_ops(O, root):
    """JSONL sink: write, close, a torn tail, resume (seq continues past the
    last parseable line), read back past the garbage."""
    path = str(root / "run.jsonl")
    with O.JsonlSink(path) as sink:
        sink.emit("a", {"x": np.float32(1.5), "arr": np.arange(3), "t": torch.tensor(2.0),
                        "nested": {"k": (1, 2)}})
        sink.emit("b", {"y": None})
    with open(path, "a") as fh:
        fh.write('{"seq": 99, "kind": "tor')  # a crash mid-write
    sink = O.JsonlSink(path)
    sink.emit("c", {"z": "ok"})
    sink.close()
    sink.emit("late", {})  # dropped after close, never raised
    mem = O.MemorySink()
    mem.emit("m", {"v": [np.int64(4)]})
    O.NullSink().emit("n", {})
    return _strip(O.read_jsonl(path)) + _strip(mem.events)


def test_events_jsonl_and_seq_resume_match_jax(tmp_path):
    JO = _jo()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t, j = _events_ops(TO, tmp_path / "t"), _events_ops(JO, tmp_path / "j")
    # torch scalars have no meaning to the JAX sink beyond .item(): same value
    assert t == j
    assert [e["seq"] for e in t[:3]] == [0, 1, 2] and t[2]["kind"] == "c"


def _lineage_ops(O, root):
    reg = O.MetricsRegistry(sink=O.MemorySink())
    lin = O.LineageTracker(reg)
    lin.start_generation({0: 0.5, 1: 0.1})
    lin.record_selection(0, 2, 0.5, elite=True)
    lin.record_selection(0, 3, 0.5)
    lin.record_mutation(3, "rl_hp")
    lin.record_fitness(2, 0.7)
    lin.record_fitness(3, 0.2)
    lin.record_fitness(9, 1.0)  # unknown index: ignored
    lin.record_selection(2, 4, 0.7)
    lin.dump(str(root / "lineage.json"))
    return lin.to_json(), _strip(reg.sink.events), json.loads((root / "lineage.json").read_text())


def test_lineage_matches_jax(tmp_path):
    JO = _jo()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    assert _lineage_ops(TO, tmp_path / "t") == _lineage_ops(JO, tmp_path / "j")


def test_timeline_profiling_and_combine_logs_match_jax():
    """Step events (no MFU and no device memory on the CPU), aggregates,
    PhaseTimer, CombineLogs and the FLOP accounting; the port's peak table
    names the H100's bf16 dense peak and knows no CPU peak."""
    JO = _jo()
    import jax.numpy as jnp

    from agilerl_tpu.llm import model as JM
    from agilerl_tpu.utils import log_utils as JL, profiling as JP

    kw = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, d_model=64, max_seq_len=64)
    tcfg, jcfg = TM.GPTConfig(**kw), JM.GPTConfig(dtype=jnp.float32, **kw)
    assert TP.transformer_flops_per_token(tcfg) == JP.transformer_flops_per_token(jcfg)
    assert TP.peak_flops_info("cpu") == (None, False) and TP.estimate_mfu(tcfg, 10, 1.0) is None
    assert TP.PEAK_BF16_FLOPS == {"h100": 989e12}
    np.testing.assert_allclose(TP.estimate_mfu(tcfg, 100, 0.5, peak_flops=989e12),
                               JP.estimate_mfu(jcfg, 100, 0.5, peak_flops=989e12), rtol=1e-12)
    assert TO.device_memory_stats("cpu") == {} == JO.device_memory_stats()
    outs = []
    for O in (TO, JO):
        reg = O.MetricsRegistry(sink=O.MemorySink())
        tl = O.StepTimeline(reg, name="train", model_config=None, memory_stats_every=1)
        tl.timer.tick = iter([None, 0.5, 0.25, 0.125]).__next__
        first = tl.step(env_steps=8)
        events = [tl.step(env_steps=8, tokens=40, agent_index=1, metrics={"loss": 2.0},
                          host_time_s=0.1, device_time_s=0.2) for _ in range(3)]
        with O.PhaseTimer(reg, "serving/prefill") as pt:
            pass
        outs.append((first, events, tl.aggregate(), reg.counter("train/steps_total").value,
                     pt.elapsed_s is not None, sorted(reg.snapshot())))
    assert outs[0] == outs[1]
    combos = []
    for L in (TL, JL):
        c = L.CombineLogs()
        c.accum({"a": 1.0, "b": 2.0}, weight=3)
        c.accum({"a": 5.0}, weight=1)
        combos.append((c.reduce(), c.reduce(across_hosts=True)))
    assert combos[0] == combos[1] and combos[0][0]["a"] == 2.0


def _facade_ops(O, root):
    """init_run_telemetry over a JSONL path: config, step ticks, log_step,
    record_eval (closing a lineage record), a traced span, close."""
    telem = O.init_run_telemetry(config={"lr": 1e-3}, jsonl_path=str(root / "run.jsonl"),
                                 trace=1.0, name="train")
    assert O.init_run_telemetry(telemetry=telem) is telem
    telem.lineage.start_generation({0: 0.1})
    telem.lineage.record_selection(0, 1, 0.1)
    telem.step(tokens=10)
    telem.step(tokens=10)
    telem.log_step({"train/loss": 0.5, "agent": 1})
    agent = type("A", (), {"index": 1})()
    telem.record_eval([agent], [0.75])
    with telem.tracer.span("work", n=1):
        pass
    assert O.get_tracer() is telem.tracer
    telem.close()
    assert O.get_tracer() is not telem.tracer
    events = O.read_jsonl(str(root / "run.jsonl"))
    drop = ("ts", "step_time_s", "trace_id", "span_id", "parent_id", "start_s", "end_s",
            "duration_s", "pod", "tokens_per_sec")
    return _strip(events, drop)


def test_facade_matches_jax_and_refuses_wandb(tmp_path):
    JO = _jo()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t, j = _facade_ops(TO, tmp_path / "t"), _facade_ops(JO, tmp_path / "j")
    assert t == j
    assert [e["kind"] for e in t][:2] == ["run_config", "generation"]
    assert TO.get_registry is TO.registry.get_registry and TO.warn_once is TO.registry.warn_once
    assert TO.facade.get_registry is TO.registry.get_registry
    with pytest.raises(NotImplementedError, match="wandb"):
        TO.RunTelemetry(wb=True)


def _fill(O, reg, scale, buckets=(0.1, 0.5, 1.0)):
    reg.counter("serving/requests_total").inc(10 * scale)
    reg.gauge("fleet/replica_count").set(scale)
    h = reg.histogram("serving/ttft_s", buckets=buckets)
    for v in (0.05, 0.3, 0.7, 2.0)[:scale + 1]:
        h.observe(v)


def _export_ops(O, root):
    """Two pods publishing (throttled, forced), a pod restart (counter goes
    backwards), a torn newest snapshot, then the merged views."""
    clock = FakeClock(10.0)
    agg_reg = O.MetricsRegistry()
    regs = [O.MetricsRegistry(), O.MetricsRegistry()]
    pubs = [O.TelemetryPublisher(root, f"p{i}", reg, interval_s=5.0, clock=clock,
                                 metrics=agg_reg) for i, reg in enumerate(regs)]
    for i, reg in enumerate(regs):
        _fill(O, reg, i + 1)
    published = [p.publish() is not None for p in pubs]
    clock.t += 1.0
    published += [p.publish() is not None for p in pubs]  # throttled
    agg = O.TelemetryAggregator(root, metrics=agg_reg)
    merged = [agg.poll()]
    regs[0] = O.MetricsRegistry()  # pod p0 restarts its registry: its counter runs backwards
    regs[0].counter("serving/requests_total").inc(4)
    regs[0].histogram("serving/ttft_s", buckets=(0.1, 0.5, 1.0)).observe(0.05)
    pubs[0] = O.TelemetryPublisher(root, "p0", regs[0], clock=clock, metrics=agg_reg)
    clock.t += 10.0
    pubs[0].publish(force=True)
    newest = sorted((root / "pod_p1").iterdir())[-1]
    pubs[1].publish(force=True)
    torn = sorted(p for p in (root / "pod_p1").iterdir() if p.name != newest.name)[-1]
    (torn / "telemetry.pkl").write_bytes(b"bad")
    merged.append(agg.poll())
    merged.append(agg.poll())
    bad = O.MetricsRegistry()
    bad.histogram("serving/ttft_s", buckets=(0.2, 2.0)).observe(1.0)
    with pytest.raises(O.TelemetrySchemaError, match="bucket schema mismatch"):
        O.merge_histogram_dumps(regs[1].dump()["histograms"]["serving/ttft_s"],
                                bad.dump()["histograms"]["serving/ttft_s"], "serving/ttft_s")
    return dict(published=published, merged=merged, dump=agg.merged_dump(),
                snapshot=agg.snapshot(), text=agg.prometheus_text(), pods=agg.pods(),
                torn=agg_reg.counter("telemetry/torn_snapshots_total").value)


def test_export_publisher_and_aggregator_match_jax(tmp_path):
    JO = _jo()
    with pytest.warns(RuntimeWarning, match="torn"):
        t = _export_ops(TO, tmp_path / "t")
    with pytest.warns(RuntimeWarning, match="torn"):
        j = _export_ops(JO, tmp_path / "j")
    assert t == j
    # p0's pre-restart 10 is banked under its restarted 4; p1 adds 20
    assert t["dump"]["counters"]["serving/requests_total"] == 10 + 4 + 20
    assert t["dump"]["histograms"]["serving/ttft_s"]["count"] == 2 + 1 + 3
    assert t["torn"] == 1 and t["pods"] == ["p0", "p1"]


def _slo_ops(O, root):
    """A spec with latency / ratio / ceiling objectives over a registry fed
    on a fake clock: a burn that fires, stays firing, then clears; the grade;
    alert → scale-up attribution; the spec's bucket alignment."""
    spec = O.SLOSpec(name="fleet", objectives=[
        O.Objective(name="ttft", kind="latency", histogram="serving/ttft_s", threshold=0.5,
                    target=0.9),
        O.Objective(name="shed", kind="ratio", numerator="serving/shed_requests_total",
                    denominator="serving/requests_total", budget=0.1),
        O.Objective(name="rebalance", kind="counter_ceiling",
                    counter="fleet/rebalanced_requests_total", ceiling=3),
        O.Objective(name="decode", kind="latency", histogram="serving/decode_s",
                    threshold=0.07, target=0.5),
    ], alerting=O.AlertPolicy(fast_window_s=10.0, slow_window_s=30.0, burn_threshold=2.0,
                              min_events=3))
    sink = O.MemorySink()
    reg = O.MetricsRegistry(sink=sink)
    # a live instrument keeps its bounds: the decode threshold stays off-grid
    reg.histogram("serving/decode_s", buckets=(0.05, 0.1))
    applied = spec.apply_buckets(reg, base={"serving/ttft_s": (0.1, 1.0)})
    clock = FakeClock()
    ev = O.SLOEvaluator(spec, O.registry_source(reg, spec), clock=clock, metrics=reg)
    states = []
    for tick in range(12):
        bad = 4 <= tick < 8
        h = reg.histogram("serving/ttft_s")
        for v in ((0.9, 0.8, 0.2) if bad else (0.1, 0.2, 0.3)):
            h.observe(v)
        reg.counter("serving/requests_total").inc(3)
        reg.counter("serving/shed_requests_total").inc(1 if bad else 0)
        reg.histogram("serving/decode_s", buckets=(0.05, 0.1)).observe(0.06)
        if tick == 7:
            reg.counter("fleet/rebalanced_requests_total").inc(2)
            reg.emit("autoscale_decision", actioned=True, verdict="up", replica=2,
                     triggers=["ttft_p95_breach"], signals={"replicas": 1})
        clock.t += 5.0
        states.append(ev.evaluate())
    grade = ev.grade(scenario="burst", extra={"note": 1})
    O.write_report(grade, root / "report.json")
    return dict(applied=applied, states=states, grade=grade, active=ev.active_alerts,
                history=ev.alert_history, attribution=O.attribute_scale_ups(sink.events),
                report=json.loads((root / "report.json").read_text()),
                spec=spec.to_dict(), names=spec.metric_names(),
                aligned=O.aligned_buckets((0.1, 1.0), (0.5, 0.1)),
                warnings=sorted(e["key"] for e in sink.events if e["kind"] == "warning"))


def test_slo_evaluation_matches_jax(tmp_path):
    JO = _jo()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    with pytest.warns(RuntimeWarning):
        t = _slo_ops(TO, tmp_path / "t")
    with pytest.warns(RuntimeWarning):
        j = _slo_ops(JO, tmp_path / "j")
    assert t == j
    fired = [h["objective"] for h in t["history"] if h["phase"] == "fire"]
    assert "ttft" in fired and "shed" in fired
    assert any(h["phase"] == "clear" for h in t["history"])
    assert t["attribution"] and t["attribution"][0]["scale_up"]["replica"] == 2
    assert t["warnings"] == ["bucket-config-late:serving/decode_s",
                             "slo-threshold-off-grid:decode"]
    spec = TO.SLOSpec.from_dict(t["spec"])
    assert spec.to_dict() == t["spec"]
    with pytest.raises(ValueError, match="unknown fields"):
        TO.Objective.from_dict({"name": "x", "kind": "latency", "histogram": "h",
                                "threshold": 1.0, "bogus": 1})
    yaml = pytest.importorskip("yaml")
    path = TO.save_slo_spec(spec, tmp_path / "spec.yaml")
    assert TO.load_slo_spec(path).to_dict() == t["spec"]
    assert yaml.safe_load(path.read_text())["name"] == "fleet"
