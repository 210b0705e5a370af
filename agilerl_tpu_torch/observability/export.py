"""Cross-process telemetry plane (the port of
``agilerl_tpu/observability/export.py``, whole): per-pod metric snapshots through the
shared commit-dir protocol, merged into one fleet-level view.

:class:`~agilerl_tpu_torch.observability.registry.MetricsRegistry` is
process-local by design — each serving replica, rollout pod, learner pod
and PBT host owns its own. This module is the layer that crosses the
process boundary, the same way every other cross-pod interaction in the
repo already does: atomic commit-dir entries
(:class:`~agilerl_tpu_torch.resilience.store.CommitDirStore` — publish / sha-
validate / skip-torn / last-K GC), so a reader either sees a complete,
hash-valid snapshot or nothing.

- :class:`TelemetryPublisher` — one per pod. ``publish()`` dumps the pod's
  registry at full resolution (counter/gauge values, raw histogram bucket
  counts — NOT the lossy percentile summary) and commits it under
  ``<dir>/pod_<id>/snap_<seq>/``, throttled to ``interval_s``.
- :class:`TelemetryAggregator` — ``poll()`` walks every pod's newest
  loadable snapshot (torn entries skipped AND counted —
  ``telemetry/torn_snapshots_total`` — exactly like every other store
  consumer) and folds it into fleet state. Merge semantics:

  * **counters** — each pod's stream is monotone; the fleet value is the
    sum of per-pod values, REBASED across pod restarts (a value that went
    backwards means the pod restarted its registry: the old high-water
    mark is banked and the new stream accumulates on top — the fleet
    counter never runs backwards).
  * **gauges** — last beat wins: the value from the newest snapshot
    (by publish timestamp, pod id tie-break) that carries the gauge.
  * **histograms** — bucket-wise addition, schema-checked: two pods
    exporting the same histogram name with different bucket bounds is a
    configuration error and raises :class:`TelemetrySchemaError` rather
    than silently mis-merging. Restart-rebased like counters.

  ``snapshot()`` / ``prometheus_text()`` mirror the single-registry
  surface exactly — the merged view is materialized INTO a fresh
  ``MetricsRegistry``, so the exposition format cannot drift from the
  per-pod one.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

from agilerl_tpu_torch.observability.registry import MetricsRegistry

#: snapshot payload schema version (bump on layout changes)
TELEMETRY_SCHEMA = 1

_POD_PREFIX = "pod_"
_SNAP_PREFIX = "snap_"


class TelemetrySchemaError(ValueError):
    """Two pods exported the same histogram with incompatible bucket
    schemas — bucket-wise merge would be silently wrong."""


def merge_histogram_dumps(a: Dict[str, Any], b: Dict[str, Any],
                          name: str = "") -> Dict[str, Any]:
    """Bucket-wise exact merge of two histogram dumps; raises
    :class:`TelemetrySchemaError` on mismatched bucket bounds."""
    if list(a["bounds"]) != list(b["bounds"]):
        raise TelemetrySchemaError(
            f"histogram {name or '<unnamed>'}: bucket schema mismatch "
            f"({a['bounds']} vs {b['bounds']}) — pods must share bucket "
            "bounds for a bucket-wise merge to be exact")
    return {
        "bounds": list(a["bounds"]),
        "counts": [int(x) + int(y)
                   for x, y in zip(a["counts"], b["counts"])],
        "sum": float(a["sum"]) + float(b["sum"]),
        "count": int(a["count"]) + int(b["count"]),
    }


def _zero_hist(like: Dict[str, Any]) -> Dict[str, Any]:
    return {"bounds": list(like["bounds"]),
            "counts": [0] * len(like["counts"]), "sum": 0.0, "count": 0}


class TelemetryPublisher:
    """Periodic per-pod snapshot publisher (the write half of the plane).

    ``directory`` is the SHARED telemetry root; this pod owns
    ``<directory>/pod_<pod>/``. ``interval_s`` throttles ``publish()``
    (``force=True`` bypasses — e.g. a final flush at shutdown);
    ``keep_last`` bounds the per-pod entry count (the aggregator only ever
    needs the newest loadable one, older entries are crash insurance)."""

    def __init__(self, directory: Union[str, Path], pod: str,
                 registry: MetricsRegistry, interval_s: float = 10.0,
                 keep_last: int = 2, clock=time.time, metrics=None,
                 tracer=None):
        from agilerl_tpu_torch.resilience.store import CommitDirStore

        self.pod = str(pod)
        self.registry = registry
        self.interval_s = float(interval_s)
        self.clock = clock
        self._store = CommitDirStore(
            Path(directory) / f"{_POD_PREFIX}{self.pod}",
            payload_name="telemetry.pkl",
            prefix=_SNAP_PREFIX,
            keep_last=int(keep_last),
            torn_counter="telemetry/torn_snapshots_total",
            torn_help="telemetry snapshots skipped as torn/corrupt",
            warn_prefix="torn-telemetry",
            metrics=metrics if metrics is not None else registry,
            tracer=tracer,
        )
        self.metrics = self._store.metrics
        # resume the snapshot seq past any EXISTING entries (a restarted
        # pod reusing its telemetry dir): restarting at 0 would make the
        # fresh snapshot the GC's oldest entry — deleted on its own
        # publish, leaving the aggregator frozen on pre-crash state
        from agilerl_tpu_torch.resilience.store import entry_seq

        self._seq = max(
            (s for s in (entry_seq(p.name) for p in self._store.entries())
             if s is not None), default=0)
        self._last_publish_s: Optional[float] = None

    def publish(self, force: bool = False) -> Optional[Path]:
        """Commit one snapshot (None when throttled by ``interval_s``)."""
        now = float(self.clock())
        if (not force and self._last_publish_s is not None
                and now - self._last_publish_s < self.interval_s):
            return None
        self._last_publish_s = now
        self._seq += 1
        payload = {
            "schema": TELEMETRY_SCHEMA,
            "pod": self.pod,
            "seq": self._seq,
            "ts": now,
            "metrics": self.registry.dump(),
        }
        path = self._store.publish(
            f"{_SNAP_PREFIX}{self._seq:08d}", payload,
            manifest_extra={"pod": self.pod, "seq": self._seq, "ts": now})
        self.metrics.counter(
            "telemetry/snapshots_published_total",
            help="per-pod telemetry snapshots committed").inc()
        return path


class TelemetryAggregator:
    """The read half: fold every pod's newest loadable snapshot into one
    fleet-level metric view (see the module docstring for the per-type
    merge semantics)."""

    def __init__(self, directory: Union[str, Path], metrics=None,
                 tracer=None):
        from agilerl_tpu_torch import observability

        self.directory = Path(directory)
        self.metrics = (metrics if metrics is not None
                        else observability.get_registry())
        self._tracer = tracer
        self._stores: Dict[str, Any] = {}
        # per-(pod, metric) monotone state: bases bank pre-restart totals
        self._counter_last: Dict[str, Dict[str, float]] = {}
        self._counter_base: Dict[str, Dict[str, float]] = {}
        self._hist_last: Dict[str, Dict[str, Dict[str, Any]]] = {}
        self._hist_base: Dict[str, Dict[str, Dict[str, Any]]] = {}
        # per-pod newest (ts, seq) and gauge dicts for last-beat-wins
        self._pod_ts: Dict[str, Tuple[float, int]] = {}
        self._gauges: Dict[str, Dict[str, float]] = {}
        # entries already counted as torn: a PERSISTENTLY torn newest
        # snapshot must be skipped on later polls without re-loading it —
        # re-validating it every poll would inflate the torn counter and
        # spam forced anomaly spans for one static file
        self._torn_seen: Dict[str, set] = {}

    def _pod_store(self, pod: str):
        store = self._stores.get(pod)
        if store is None:
            from agilerl_tpu_torch.resilience.store import CommitDirStore

            store = CommitDirStore(
                self.directory / f"{_POD_PREFIX}{pod}",
                payload_name="telemetry.pkl",
                prefix=_SNAP_PREFIX,
                torn_counter="telemetry/torn_snapshots_total",
                torn_help="telemetry snapshots skipped as torn/corrupt",
                warn_prefix="torn-telemetry",
                metrics=self.metrics,
                tracer=self._tracer,
            )
            self._stores[pod] = store
        return store

    def pods(self) -> List[str]:
        """Pod ids with a snapshot directory under the telemetry root."""
        if not self.directory.is_dir():
            return []
        return sorted(
            d.name[len(_POD_PREFIX):] for d in self.directory.iterdir()
            if d.is_dir() and d.name.startswith(_POD_PREFIX))

    def poll(self) -> int:
        """Read every pod's newest LOADABLE snapshot (torn entries counted
        + skipped, walked past to the previous one) and fold it into the
        aggregate. Returns how many pods contributed fresh state."""
        from agilerl_tpu_torch.resilience.atomic import CorruptSnapshotError
        from agilerl_tpu_torch.resilience.store import read_manifest

        merged = 0
        for pod in self.pods():
            store = self._pod_store(pod)
            torn = self._torn_seen.setdefault(pod, set())
            payload = None
            for entry in reversed(store.entries()):
                if entry.name in torn:
                    continue  # counted once already; don't re-validate
                # freshness probe off the MANIFEST (ts/seq are written
                # there precisely so they're readable without unpickling):
                # an unchanged pod — retired members included — costs one
                # small JSON read per poll, not a sha256-validated payload
                # load that is then discarded
                try:
                    mf = read_manifest(entry)
                    stamp = (float(mf.get("ts", 0.0)), int(mf.get("seq", 0)))
                    if self._pod_ts.get(pod) == stamp:
                        break  # newest candidate already folded
                except (CorruptSnapshotError, TypeError, ValueError):
                    pass  # unreadable manifest: let load() count the tear
                payload = store.load(entry)
                if payload is not None:
                    break
                if entry.exists():
                    torn.add(entry.name)  # torn (not GC'd): skip next poll
            if payload is None or payload.get("schema") != TELEMETRY_SCHEMA:
                continue
            stamp = (float(payload.get("ts", 0.0)),
                     int(payload.get("seq", 0)))
            if self._pod_ts.get(pod) == stamp:
                continue  # nothing new since the last poll
            self._pod_ts[pod] = stamp
            self._fold(pod, payload)
            merged += 1
        if merged:
            self.metrics.counter(
                "telemetry/snapshots_merged_total",
                help="pod snapshots folded into the fleet aggregate",
            ).inc(merged)
        self.metrics.gauge(
            "telemetry/pods",
            help="pods contributing to the fleet aggregate").set(
            len(self._pod_ts))
        return merged

    def _fold(self, pod: str, payload: Dict[str, Any]) -> None:
        dump = payload.get("metrics") or {}
        last = self._counter_last.setdefault(pod, {})
        base = self._counter_base.setdefault(pod, {})
        for name, v in (dump.get("counters") or {}).items():
            v = float(v)
            if v < last.get(name, 0.0):
                # the pod restarted its registry: bank the old high-water
                # mark so the fleet total stays monotone
                base[name] = base.get(name, 0.0) + last[name]
            last[name] = v
        hlast = self._hist_last.setdefault(pod, {})
        hbase = self._hist_base.setdefault(pod, {})
        for name, h in (dump.get("histograms") or {}).items():
            prev = hlast.get(name)
            if prev is not None and int(h["count"]) < int(prev["count"]):
                b = hbase.get(name) or _zero_hist(prev)
                hbase[name] = merge_histogram_dumps(b, prev, name)
            hlast[name] = {"bounds": list(h["bounds"]),
                           "counts": [int(c) for c in h["counts"]],
                           "sum": float(h["sum"]), "count": int(h["count"])}
        self._gauges[pod] = dict(dump.get("gauges") or {})

    # -- merged views ------------------------------------------------------
    def merged_dump(self) -> Dict[str, Any]:
        """The fleet aggregate in ``registry.dump()`` form."""
        counters: Dict[str, float] = {}
        for pod in self._counter_last:
            base = self._counter_base.get(pod, {})
            for name, v in self._counter_last[pod].items():
                counters[name] = (counters.get(name, 0.0)
                                  + base.get(name, 0.0) + v)
            for name, b in base.items():
                if name not in self._counter_last[pod]:
                    counters[name] = counters.get(name, 0.0) + b
        histograms: Dict[str, Dict[str, Any]] = {}
        for pod in self._hist_last:
            pod_hists = dict(self._hist_base.get(pod, {}))
            for name, h in self._hist_last[pod].items():
                pod_hists[name] = (merge_histogram_dumps(
                    pod_hists[name], h, name) if name in pod_hists else h)
            for name, h in pod_hists.items():
                histograms[name] = (merge_histogram_dumps(
                    histograms[name], h, name) if name in histograms else h)
        gauges: Dict[str, float] = {}
        # last beat wins: apply gauge dicts oldest-first so the newest
        # snapshot's value lands last (pod id breaks exact-ts ties)
        order = sorted(self._gauges,
                       key=lambda p: (self._pod_ts.get(p, (0.0, 0)), p))
        for pod in order:
            gauges.update(self._gauges[pod])
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}

    def _materialize(self) -> MetricsRegistry:
        """Build a real registry holding the merged state, so snapshot /
        exposition semantics are EXACTLY the single-registry ones."""
        dump = self.merged_dump()
        reg = MetricsRegistry()
        for name, v in sorted(dump["counters"].items()):
            reg.counter(name).inc(float(v))
        for name, v in sorted(dump["gauges"].items()):
            reg.gauge(name).set(v)
        for name, h in sorted(dump["histograms"].items()):
            hist = reg.histogram(name, buckets=h["bounds"])
            # package-internal fill: a merged histogram IS raw bucket
            # state, not a stream of observations to replay
            hist._counts = [int(c) for c in h["counts"]]
            hist._sum = float(h["sum"])
            hist._count = int(h["count"])
        return reg

    def snapshot(self) -> Dict[str, Any]:
        """Fleet-level ``MetricsRegistry.snapshot()`` view of the merged
        state (call :meth:`poll` first to refresh)."""
        return self._materialize().snapshot()

    def prometheus_text(self) -> str:
        """Fleet-level Prometheus exposition of the merged state."""
        return self._materialize().prometheus_text()
