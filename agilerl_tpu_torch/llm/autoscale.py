"""Autoscaling POLICY for the serving fleet: the port of
``agilerl_tpu/llm/autoscale.py`` (whole).

``ServingFleet`` has the mechanisms (``scale_up()`` spawns a replica into
the lease set, ``scale_down()`` retires one gracefully); this module
decides WHEN to call them, deliberately split the same way the admission controller is
(:class:`~agilerl_tpu_torch.llm.serving.AdmissionPolicy`): :meth:`decide` is a
pure function of the fleet's existing SLO telemetry
(:meth:`~agilerl_tpu_torch.llm.fleet.ServingFleet.slo_signals` — rolling p95
TTFT, per-replica backlog, shed counts), so it unit-tests with synthetic
signals and a fake clock; :meth:`apply` adds the stateful parts (cooldown
timers, shed-delta tracking) and actually calls the fleet.

Thresholds follow the standard queue-theoretic shape: scale UP when
sustained backlog / latency / shedding says the current replica set cannot
drain arrivals, scale DOWN when the fleet is sustainedly idle — with
asymmetric cooldowns (fast up, slow down) so a burst cannot flap the
fleet. The flywheel's rollout tier drives one of these per rollout tick
(``llm/flywheel.RolloutPod``)."""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

from agilerl_tpu_torch import observability


class AutoscalePolicy:
    """Threshold autoscaler over :meth:`ServingFleet.slo_signals`.

    - ``backlog_high`` / ``backlog_low``: mean queued+in-flight rows per
      replica that trigger up / permit down (the queue-depth telemetry).
    - ``ttft_p95_high_s``: optional p95-TTFT SLO; breaching it triggers up
      and blocks down (None disables the latency trigger).
    - ``shed_rate_high``: optional shed-count delta between consecutive
      :meth:`apply` calls that triggers up (shedding means admission
      control is already refusing traffic — the strongest scale-up
      signal); any shedding at all blocks down.
    - ``up_cooldown_s`` / ``down_cooldown_s``: minimum spacing between
      scale actions (per direction, measured on the injected ``clock``) so
      one burst cannot add N replicas before the first one takes load.
    """

    def __init__(
        self,
        min_replicas: int = 1,
        max_replicas: int = 8,
        backlog_high: float = 8.0,
        backlog_low: float = 1.0,
        ttft_p95_high_s: Optional[float] = None,
        shed_rate_high: Optional[float] = None,
        up_cooldown_s: float = 10.0,
        down_cooldown_s: float = 60.0,
        clock=time.time,
        metrics=None,
    ):
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.backlog_high = float(backlog_high)
        self.backlog_low = float(backlog_low)
        self.ttft_p95_high_s = ttft_p95_high_s
        self.shed_rate_high = shed_rate_high
        self.up_cooldown_s = float(up_cooldown_s)
        self.down_cooldown_s = float(down_cooldown_s)
        self.clock = clock
        self.metrics = (metrics if metrics is not None
                        else observability.get_registry())
        self._last_up_s: Optional[float] = None
        self._last_down_s: Optional[float] = None
        self._last_shed_total: Optional[float] = None
        #: the last structured decision record :meth:`decide` built — what
        #: :meth:`apply` enriches (cooldown state, actuation) and emits
        self.last_decision: Optional[Dict[str, Any]] = None

    def _thresholds(self) -> Dict[str, Any]:
        return {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "backlog_high": self.backlog_high,
            "backlog_low": self.backlog_low,
            "ttft_p95_high_s": self.ttft_p95_high_s,
            "shed_rate_high": self.shed_rate_high,
        }

    # -- the pure decision -------------------------------------------------
    def decide(self, signals: Dict[str, Any],
               shed_delta: float = 0.0) -> Optional[str]:
        """``"up"`` / ``"down"`` / None for one signal snapshot. Pure —
        no clocks, no counters — so tests feed synthetic signals directly.
        Cooldowns are :meth:`apply`'s job, not a reason to distort the
        decision itself.

        Every call leaves a STRUCTURED record of what it saw and why in
        :attr:`last_decision` (signals, thresholds, the triggers that
        fired, the verdict); :meth:`apply` adds cooldown/actuation state
        and emits it through the owner's sink as an ``autoscale_decision``
        event — the record an SLO report joins against alert timestamps to
        attribute ``fleet/scale_up_latency_s`` to the breach that triggered
        the scale-up."""
        replicas = int(signals.get("replicas", 0))
        mean_backlog = float(signals.get("mean_backlog", 0.0))
        p95 = signals.get("p95_ttft_s")
        # the TTFT window is count-bounded, not time-decayed: with zero
        # outstanding work it FREEZES at the last burst's percentile, so a
        # stale breach must neither pin an idle fleet hot (scale-up to max)
        # nor block its scale-down forever
        busy = (mean_backlog > 0.0
                or float(signals.get("fleet_backlog", 0.0)) > 0.0)
        triggers = []
        verdict: Optional[str] = None
        if replicas < self.min_replicas:
            triggers.append("below_min_replicas")
            verdict = "up"
        else:
            if mean_backlog >= self.backlog_high:
                triggers.append("backlog_high")
            if (self.ttft_p95_high_s is not None and p95 is not None
                    and busy and p95 >= self.ttft_p95_high_s):
                triggers.append("ttft_p95_breach")
            if (self.shed_rate_high is not None
                    and shed_delta >= self.shed_rate_high):
                triggers.append("shedding")
            if triggers:
                verdict = "up" if replicas < self.max_replicas else None
                if verdict is None:
                    triggers.append("at_max_replicas")
            else:
                slow_ok = (self.ttft_p95_high_s is None or p95 is None
                           or p95 < self.ttft_p95_high_s or not busy)
                cold = (mean_backlog <= self.backlog_low
                        and shed_delta <= 0.0
                        and float(signals.get("fleet_backlog", 0.0)) <= 0.0
                        and slow_ok)
                if cold and replicas > self.min_replicas:
                    triggers.append("sustained_idle")
                    verdict = "down"
        self.last_decision = {
            "verdict": verdict,
            "triggers": triggers,
            "signals": {k: signals.get(k) for k in (
                "replicas", "mean_backlog", "max_backlog", "fleet_backlog",
                "p95_ttft_s", "shed_total")},
            "shed_delta": float(shed_delta),
            "thresholds": self._thresholds(),
        }
        return verdict

    # -- the stateful actuator ---------------------------------------------
    def _cooldown_state(self, now: float) -> Dict[str, Any]:
        up_rem = (max(0.0, self.up_cooldown_s - (now - self._last_up_s))
                  if self._last_up_s is not None else 0.0)
        down_rem = (max(0.0, self.down_cooldown_s - (now - self._last_down_s))
                    if self._last_down_s is not None else 0.0)
        return {"up_remaining_s": round(up_rem, 6),
                "down_remaining_s": round(down_rem, 6)}

    def _emit_decision(self, decision: Dict[str, Any]) -> None:
        """One structured ``autoscale_decision`` event through the owner's
        sink per non-trivial decision: everything the policy saw (signals,
        thresholds, triggers), its verdict, the cooldown state, and whether
        it actually actuated — the SLO report's attribution record (which
        breach triggered the scale-up whose ``fleet/scale_up_latency_s``
        sample the report grades)."""
        self.metrics.counter(
            "fleet/autoscale_decisions_total",
            help="structured autoscale decisions emitted").inc()
        self.metrics.emit("autoscale_decision", **decision)

    def apply(self, fleet) -> Optional[Tuple[str, int]]:
        """Read the fleet's signals, decide, enforce cooldowns, and call
        ``scale_up()`` / ``scale_down()``. Returns ``(action, replica_id)``
        when an action fired, else None. Every decision with a non-None
        verdict — actuated or cooldown-blocked — is emitted as a structured
        ``autoscale_decision`` event (quiet no-pressure ticks are recorded
        in :attr:`last_decision` but not emitted: at step cadence they
        would be sink spam)."""
        signals = fleet.slo_signals()
        shed_total = float(signals.get("shed_total", 0.0))
        shed_delta = (shed_total - self._last_shed_total
                      if self._last_shed_total is not None else 0.0)
        action = self.decide(signals, shed_delta)
        decision = self.last_decision
        now = float(self.clock())
        decision["cooldown"] = self._cooldown_state(now)
        decision["actioned"] = False
        decision["replica"] = None
        if action is None:
            # no pressure: roll the shed window forward (delta is a rate
            # per apply interval, not a lifetime accumulator)
            self._last_shed_total = shed_total
            if decision["triggers"]:
                # a trigger fired but actuation is impossible (at max
                # replicas): still worth an attribution record
                decision["blocked_by"] = "replica_bounds"
                self._emit_decision(decision)
            return None
        if action == "up":
            if (self._last_up_s is not None
                    and now - self._last_up_s < self.up_cooldown_s):
                # cooldown-blocked: do NOT consume the shed window, or
                # shedding observed during the cooldown could never
                # trigger the scale-up once it expires
                decision["blocked_by"] = "up_cooldown"
                self._emit_decision(decision)
                return None
            self._last_shed_total = shed_total
            rid = fleet.scale_up()
            self._last_up_s = now
        else:
            if (self._last_down_s is not None
                    and now - self._last_down_s < self.down_cooldown_s):
                decision["blocked_by"] = "down_cooldown"
                self._emit_decision(decision)
                return None
            self._last_shed_total = shed_total
            rid = fleet.least_loaded_replica()
            if rid is None:
                decision["blocked_by"] = "no_retirable_replica"
                self._emit_decision(decision)
                return None
            fleet.scale_down(rid)
            self._last_down_s = now
        self.metrics.counter(
            f"fleet/autoscale_{action}_total",
            help="autoscale policy actions taken").inc()
        decision["actioned"] = True
        decision["replica"] = int(rid)
        self._emit_decision(decision)
        self.metrics.emit(
            "fleet_autoscale", action=action, replica=int(rid),
            mean_backlog=signals.get("mean_backlog"),
            p95_ttft_s=signals.get("p95_ttft_s"), shed_delta=shed_delta,
            replicas=signals.get("replicas"))
        return action, int(rid)
