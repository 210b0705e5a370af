"""Million-user traffic harness: production-shaped load over the serving
fleet, deterministic and record/replay-able. The port of
``agilerl_tpu/benchmarking/traffic.py`` (whole): the draws are numpy from one
generator, so a trace from a given spec and seed equals the JAX package's
request for request, and a trace saved by either package loads in the other.

This module generates the workload shapes the Orca / DistServe serving
lineage measures against and drives them through the port's
``llm/fleet.ServingFleet`` ``submit()`` / ``step()`` surface:

- **Heavy-tail sizes** — prompt and output lengths are lognormal (clipped
  to the fleet's bucket grid): most requests are short, the tail is long —
  the mix that exercises continuous batching, paged-KV admission, and the
  decode-budget raggedness real chat traffic has.
- **Arrival processes** — open-loop inhomogeneous Poisson over a VIRTUAL
  time axis: ``steady`` (constant rate), ``diurnal`` (sinusoidal day
  curve), ``flash_crowd`` (a burst window multiplying the base rate —
  the thundering-herd case), ``prefix_skew`` (a fraction of requests share
  one system prompt — the prefix-cache/affinity case). Closed-loop mode
  (fixed concurrency, submit-on-completion) measures capacity instead of
  latency-under-load.
- **Determinism** — every draw flows through one ``np.random.Generator``
  derived via :func:`agilerl_tpu_torch.utils.rng.derive_rng`: the
  same seed yields the identical request trace, and a trace saved with
  :func:`save_trace` replays exactly (:func:`load_trace` round-trips
  token-for-token). Virtual time advances ``1/steps_per_s`` per fleet
  scheduler step, so the submit SCHEDULE — which requests arrive before
  which step, what the queue depth is when admission decides — is a pure
  function of the trace, not of host speed.
- **Degraded runs** — the driver consults a
  :class:`~agilerl_tpu_torch.resilience.faults.FaultInjector` host-loss schedule
  at virtual-second boundaries (``kill_host_at={virtual_second:
  replica_id}``) and drives an optional
  :class:`~agilerl_tpu_torch.llm.autoscale.AutoscalePolicy` every step, so one
  scenario run exercises replica kill under burst, SLO shedding, failover
  re-dispatch, and the autoscaler's graded reaction — the standing
  workload generator the SLO engine (``observability/slo.py``) scores.

Each request's sampling key is the fleet's counter key
(``llm/generate.request_key(seed)`` folded with the request's index, where
the JAX package folds a PRNG key): greedy runs decode the same tokens,
sampled runs draw other numbers from the same seed.
"""

from __future__ import annotations

import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from agilerl_tpu_torch.utils.rng import derive_rng

#: trace-file schema version (bump on layout changes)
TRACE_SCHEMA = 1


@dataclasses.dataclass
class TrafficRequest:
    """One synthetic request: WHEN it arrives (virtual seconds from
    scenario start), WHAT it asks (prompt tokens, output budget), and its
    provenance tags (trace index, shared-prefix membership)."""

    index: int
    arrival_s: float
    tokens: np.ndarray
    max_new: int
    shared_prefix: bool = False

    def to_record(self) -> Dict[str, Any]:
        return {
            "index": int(self.index),
            "arrival_s": float(self.arrival_s),
            "tokens": [int(t) for t in self.tokens],
            "max_new": int(self.max_new),
            "shared_prefix": bool(self.shared_prefix),
        }

    @classmethod
    def from_record(cls, rec: Dict[str, Any]) -> "TrafficRequest":
        return cls(
            index=int(rec["index"]),
            arrival_s=float(rec["arrival_s"]),
            tokens=np.asarray(rec["tokens"], np.int32),
            max_new=int(rec["max_new"]),
            shared_prefix=bool(rec.get("shared_prefix", False)),
        )


@dataclasses.dataclass
class ScenarioSpec:
    """Declarative description of one traffic scenario — everything
    :func:`generate_trace` needs, serializable for provenance.

    ``kind`` selects the arrival curve: ``steady`` | ``diurnal`` |
    ``flash_crowd`` | ``prefix_skew`` (prefix-skew arrivals are steady; the
    skew is in the PROMPTS: ``shared_fraction`` of requests start with one
    ``prefix_len``-token system prompt). Lengths are lognormal —
    ``exp(N(log_mean, sigma))`` — clipped to ``[min_*, max_*]``."""

    name: str
    kind: str = "steady"
    duration_s: float = 10.0
    base_rate_rps: float = 4.0
    vocab: int = 512
    # heavy-tail prompt lengths
    prompt_len_log_mean: float = 2.3      # exp(2.3) ~ 10 tokens median
    prompt_len_sigma: float = 0.7
    min_prompt: int = 4
    max_prompt: int = 28
    # heavy-tail output budgets
    out_len_log_mean: float = 2.0         # exp(2.0) ~ 7 tokens median
    out_len_sigma: float = 0.8
    min_new: int = 1
    max_new: int = 32
    # diurnal curve
    diurnal_amplitude: float = 0.8
    diurnal_period_s: float = 10.0
    # flash crowd
    burst_start_s: float = 4.0
    burst_duration_s: float = 2.0
    burst_x: float = 6.0
    # prefix skew
    shared_fraction: float = 0.7
    prefix_len: int = 12

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ScenarioSpec":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    # -- the arrival-rate curve -------------------------------------------
    def rate_at(self, t: float) -> float:
        """Requests/second at virtual time ``t`` (the inhomogeneous-Poisson
        intensity)."""
        base = float(self.base_rate_rps)
        if self.kind == "diurnal":
            # trough at t=0, peak mid-period: one "day" per period
            phase = 2.0 * math.pi * (t / self.diurnal_period_s)
            return base * (1.0 + self.diurnal_amplitude
                           * 0.5 * (1.0 - math.cos(phase)))
        if self.kind == "flash_crowd":
            in_burst = (self.burst_start_s <= t
                        < self.burst_start_s + self.burst_duration_s)
            return base * (self.burst_x if in_burst else 1.0)
        return base  # steady / prefix_skew

    def peak_rate(self) -> float:
        if self.kind == "diurnal":
            return self.base_rate_rps * (1.0 + self.diurnal_amplitude)
        if self.kind == "flash_crowd":
            return self.base_rate_rps * self.burst_x
        return self.base_rate_rps


def _heavy_tail_len(rng: np.random.Generator, log_mean: float, sigma: float,
                    lo: int, hi: int) -> int:
    return int(np.clip(round(math.exp(rng.normal(log_mean, sigma))), lo, hi))


def generate_trace(spec: ScenarioSpec, seed: int) -> List[TrafficRequest]:
    """The deterministic scenario generator: same ``(spec, seed)`` ⇒ the
    identical request trace, equal to the JAX package's for the same spec
    and seed. All randomness flows through ONE Generator derived via
    ``utils/rng``: no global-stream draws.

    Arrivals are inhomogeneous Poisson by thinning: candidate gaps are
    exponential at the PEAK rate, each accepted with probability
    ``rate(t)/peak`` — exact for any bounded intensity, and one rng stream
    keeps the whole trace (arrivals, acceptance, lengths, token values)
    reproducible from the single seed."""
    rng = derive_rng(seed=int(seed))
    peak = max(spec.peak_rate(), 1e-9)
    shared = None
    if spec.kind == "prefix_skew":
        shared = rng.integers(
            3, spec.vocab, size=int(spec.prefix_len)).astype(np.int32)
    out: List[TrafficRequest] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / peak))
        if t >= spec.duration_s:
            break
        if float(rng.random()) >= spec.rate_at(t) / peak:
            continue  # thinned: intensity below peak at this instant
        is_shared = (spec.kind == "prefix_skew"
                     and float(rng.random()) < spec.shared_fraction)
        plen = _heavy_tail_len(rng, spec.prompt_len_log_mean,
                               spec.prompt_len_sigma, spec.min_prompt,
                               spec.max_prompt)
        if is_shared:
            # shared system prompt + a short per-user suffix, clipped to
            # the same grid the cold prompts use
            suffix = rng.integers(
                3, spec.vocab,
                size=max(1, min(plen, spec.max_prompt - shared.size)),
            ).astype(np.int32)
            tokens = np.concatenate([shared, suffix])
        else:
            tokens = rng.integers(3, spec.vocab, size=plen).astype(np.int32)
        out.append(TrafficRequest(
            index=len(out), arrival_s=t, tokens=tokens,
            max_new=_heavy_tail_len(rng, spec.out_len_log_mean,
                                    spec.out_len_sigma, spec.min_new,
                                    spec.max_new),
            shared_prefix=is_shared))
    return out


def scenario_suite(vocab: int = 512, duration_s: float = 10.0,
                   base_rate_rps: float = 4.0, max_prompt: int = 28,
                   max_new: int = 32) -> List[ScenarioSpec]:
    """The standing four-scenario suite: steady heavy-tail, diurnal,
    flash-crowd, prefix-skew, one spec set shared by the benchmark and the
    tests, so 'the scenario a run was graded on' is a name, not a
    copy-pasted parameter blob."""
    common = dict(vocab=int(vocab), duration_s=float(duration_s),
                  base_rate_rps=float(base_rate_rps),
                  max_prompt=int(max_prompt), max_new=int(max_new))
    return [
        ScenarioSpec(name="steady_heavy_tail", kind="steady", **common),
        ScenarioSpec(name="diurnal", kind="diurnal",
                     diurnal_period_s=float(duration_s), **common),
        ScenarioSpec(name="flash_crowd", kind="flash_crowd",
                     burst_start_s=0.4 * duration_s,
                     burst_duration_s=0.2 * duration_s, **common),
        ScenarioSpec(name="prefix_skew", kind="prefix_skew",
                     prefix_len=max(4, int(max_prompt) // 2), **common),
    ]


# --------------------------------------------------------------------------- #
# record / replay
# --------------------------------------------------------------------------- #

def save_trace(path: Union[str, Path], requests: Sequence[TrafficRequest],
               spec: Optional[ScenarioSpec] = None,
               seed: Optional[int] = None) -> Path:
    """Write a request trace as JSONL — one header line (schema, provenance:
    the generating spec + seed when known) then one line per request —
    atomically, so a crash mid-write can never leave a half-trace a later
    replay run trusts."""
    from agilerl_tpu_torch.resilience.atomic import atomic_write_bytes

    path = Path(path)
    lines = [json.dumps({
        "kind": "trace_header", "schema": TRACE_SCHEMA,
        "n_requests": len(requests),
        "spec": spec.to_dict() if spec is not None else None,
        "seed": int(seed) if seed is not None else None,
    })]
    lines.extend(json.dumps(r.to_record()) for r in requests)
    atomic_write_bytes(path, ("\n".join(lines) + "\n").encode())
    return path


def load_trace(path: Union[str, Path]) -> List[TrafficRequest]:
    """Load a recorded trace; token-for-token identical to what
    :func:`save_trace` wrote (ints and floats round-trip JSON exactly)."""
    requests: List[TrafficRequest] = []
    with open(path, encoding="utf-8") as fh:
        header = json.loads(fh.readline())
        if header.get("kind") != "trace_header":
            raise ValueError(f"{path}: not a traffic trace (missing header)")
        if header.get("schema") != TRACE_SCHEMA:
            raise ValueError(
                f"{path}: trace schema {header.get('schema')} != "
                f"{TRACE_SCHEMA}")
        for line in fh:
            line = line.strip()
            if line:
                requests.append(TrafficRequest.from_record(json.loads(line)))
    return requests


def trace_header(path: Union[str, Path]) -> Dict[str, Any]:
    """The provenance header of a recorded trace."""
    with open(path, encoding="utf-8") as fh:
        return json.loads(fh.readline())


# --------------------------------------------------------------------------- #
# the driver
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class TrafficRunResult:
    """What one scenario run did — the deterministic half of a scenario
    grade (submit/shed/completion/token counts are a pure function of the
    trace and step schedule; wall-clock latency histograms live in the
    fleet's telemetry, which the SLO engine reads separately)."""

    scenario: str
    mode: str
    n_requests: int
    submitted: int
    shed: int
    completed: int
    steps: int
    virtual_s: float
    wall_s: float
    delivered_tokens: int
    kills: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    scale_events: List[Dict[str, Any]] = dataclasses.field(
        default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class TrafficDriver:
    """Drive a :class:`~agilerl_tpu_torch.llm.fleet.ServingFleet` (or anything
    with its ``submit/step/result/open_requests`` surface) through one
    request trace.

    - ``mode="open"`` — arrival-time-faithful: virtual time advances
      ``1/steps_per_s`` per fleet step and every request whose
      ``arrival_s`` has passed is submitted before that step runs. Sheds
      happen exactly as admission control dictates at that queue state.
    - ``mode="closed"`` — fixed-concurrency: keep ``concurrency`` requests
      in flight, submit the next the moment one finishes (``no_shed`` —
      closed-loop measures capacity, so shedding the replacement request
      would deadlock the loop's own flow control).
    - ``autoscale`` — an :class:`~agilerl_tpu_torch.llm.autoscale.AutoscalePolicy`
      applied every ``autoscale_every`` steps (its cooldowns run on its own
      clock; inject a fake one for deterministic tests).
    - ``fault_injector`` — a :class:`~agilerl_tpu_torch.resilience.faults.
      FaultInjector` whose ``kill_host_at`` schedule is keyed by VIRTUAL
      second: at each virtual-second boundary the scheduled replica is
      killed via ``fleet.kill_replica`` (lease-expiry detection when the
      fleet has a heartbeat store, immediate otherwise).
    - ``on_step(step, vnow)`` — per-step hook; the SLO evaluator's
      continuous-evaluation cadence hangs off this in the bench/tests.

    The driver never blocks on wall time — virtual time IS the step count —
    so a run is as fast as the fleet can step and the submit schedule is
    reproducible across hosts of any speed."""

    def __init__(
        self,
        fleet,
        *,
        mode: str = "open",
        steps_per_s: float = 50.0,
        concurrency: int = 8,
        seed: int = 0,
        autoscale=None,
        autoscale_every: int = 1,
        fault_injector=None,
        on_step: Optional[Callable[[int, float], None]] = None,
        max_steps: int = 200_000,
        metrics=None,
    ):
        if mode not in ("open", "closed"):
            raise ValueError(f"unknown driver mode {mode!r}")
        if steps_per_s <= 0:
            raise ValueError("steps_per_s must be positive")
        self.fleet = fleet
        self.mode = mode
        self.steps_per_s = float(steps_per_s)
        self.concurrency = int(concurrency)
        self.seed = int(seed)
        self.autoscale = autoscale
        self.autoscale_every = max(1, int(autoscale_every))
        self.fault_injector = fault_injector
        self.on_step = on_step
        self.max_steps = int(max_steps)
        self.metrics = metrics if metrics is not None else fleet.metrics

    # -- internals ---------------------------------------------------------
    def _submit(self, req: TrafficRequest, key, no_shed: bool) -> Optional[int]:
        return self.fleet.submit(req.tokens, max_new=req.max_new, key=key,
                                 no_shed=no_shed)

    def _kill_scheduled(self, vsec_from: int, vsec_to: int,
                        kills: List[Dict[str, Any]], vnow: float) -> None:
        if self.fault_injector is None:
            return
        for s in range(vsec_from + 1, vsec_to + 1):
            rid = self.fault_injector.host_to_kill(s)
            if rid is None:
                continue
            live = set(self.fleet.replica_ids)
            if rid not in live:
                continue  # already dead/retired — nothing to kill
            self.fleet.kill_replica(int(rid))
            kills.append({"virtual_s": float(s), "replica": int(rid)})
            self.metrics.emit("traffic_fault", fault="replica_kill",
                              replica=int(rid), virtual_s=float(s),
                              at_s=vnow)

    def run(self, requests: Sequence[TrafficRequest], params, lora=None,
            greedy: bool = True, scenario: str = "trace",
            collect_outputs: bool = False) -> TrafficRunResult:
        """Serve the whole trace to completion (every submitted request
        finishes — sheds are terminal) and return the run's deterministic
        outcome counts. ``collect_outputs`` keeps each request's decoded
        tokens on the result (``.outputs``: index → (tokens, emits)) for
        token-level A/Bs; off by default to bound memory on big traces."""
        from agilerl_tpu_torch.llm.generate import fold_in, request_key

        requests = list(requests)
        base_key = request_key(self.seed)
        scale0 = len(getattr(self.fleet, "replica_ids", []))
        tickets: Dict[int, int] = {}     # fleet ticket -> request index
        outputs: Dict[int, Any] = {}
        outcomes = {"submitted": 0, "shed": 0, "completed": 0}
        delivered = 0
        kills: List[Dict[str, Any]] = []
        scale_events: List[Dict[str, Any]] = []
        idx = 0
        step = 0
        vsec = -1
        t0 = time.perf_counter()
        self.metrics.emit("traffic_scenario", scenario=scenario,
                          mode=self.mode, n_requests=len(requests),
                          steps_per_s=self.steps_per_s)
        while True:
            vnow = step / self.steps_per_s
            new_vsec = int(vnow)
            if new_vsec != vsec:
                self._kill_scheduled(vsec, new_vsec, kills, vnow)
                vsec = new_vsec
            if self.mode == "open":
                while idx < len(requests) and requests[idx].arrival_s <= vnow:
                    req = requests[idx]
                    t = self._submit(
                        req, fold_in(base_key, req.index),
                        no_shed=False)
                    if t is None:
                        outcomes["shed"] += 1
                    else:
                        tickets[t] = req.index
                        outcomes["submitted"] += 1
                    idx += 1
            else:
                while (idx < len(requests)
                       and len(tickets) < self.concurrency):
                    req = requests[idx]
                    t = self._submit(
                        req, fold_in(base_key, req.index),
                        no_shed=True)
                    tickets[t] = req.index
                    outcomes["submitted"] += 1
                    idx += 1
            if idx >= len(requests) and not tickets \
                    and not self.fleet.open_requests:
                break
            if self.autoscale is not None \
                    and step % self.autoscale_every == 0:
                acted = self.autoscale.apply(self.fleet)
                if acted is not None:
                    scale_events.append({
                        "action": acted[0], "replica": int(acted[1]),
                        "virtual_s": vnow, "step": step})
            if self.on_step is not None:
                self.on_step(step, vnow)
            for t in self.fleet.step(params, lora=lora, greedy=greedy):
                toks, emits = self.fleet.result(t)
                ri = tickets.pop(t)
                outcomes["completed"] += 1
                delivered += int(np.asarray(emits).sum())
                if collect_outputs:
                    outputs[ri] = (toks, emits)
            step += 1
            if step >= self.max_steps:
                raise RuntimeError(
                    f"traffic run not drained after {self.max_steps} steps "
                    f"({len(tickets)} in flight, {len(requests) - idx} "
                    "unsubmitted — a killed replica with no failover path?)")
        result = TrafficRunResult(
            scenario=scenario, mode=self.mode, n_requests=len(requests),
            submitted=outcomes["submitted"], shed=outcomes["shed"],
            completed=outcomes["completed"], steps=step,
            virtual_s=step / self.steps_per_s,
            wall_s=time.perf_counter() - t0,
            delivered_tokens=int(delivered), kills=kills,
            scale_events=scale_events)
        if collect_outputs:
            result.outputs = outputs  # type: ignore[attr-defined]
        self.metrics.emit("traffic_scenario_done",
                          **{k: v for k, v in result.to_dict().items()
                             if k not in ("kills", "scale_events")},
                          replicas_start=scale0,
                          replicas_end=len(self.fleet.replica_ids))
        return result
