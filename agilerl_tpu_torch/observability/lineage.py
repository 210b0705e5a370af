"""Evolution lineage (the port of ``agilerl_tpu/observability/lineage.py``,
whole): per-generation fitness distributions and a
parent→child mutation genealogy.

The tracker is hooked into the evolution machinery itself
(``hpo/tournament.py`` records selections, ``hpo/mutation.py`` records the
mutation class applied to each child) and closed out by the training loop's
next evaluation, which supplies each child's post-mutation fitness so the
tracker can attribute a fitness delta to the mutation that produced it.

Event flow per generation G:

1. ``TournamentSelection.select`` → ``start_generation`` (fitness
   distribution of the evaluated population, emitted as a ``generation``
   event) then ``record_selection`` per cloned child.
2. ``Mutations.mutation`` → ``record_mutation`` per child.
3. next eval → ``record_fitness`` per agent: the child's record gains
   ``child_fitness`` / ``fitness_delta`` and is emitted as a ``lineage``
   event.

``to_json()`` dumps the full genealogy (children of the final generation that
were never re-evaluated appear with ``child_fitness: null``).
"""

from __future__ import annotations

import json
import math
from typing import Any, Dict, List


def _stats(values: List[float]) -> Dict[str, float]:
    if not values:
        return {"count": 0}
    n = len(values)
    mean = sum(values) / n
    var = sum((v - mean) ** 2 for v in values) / n
    return {
        "count": n,
        "mean": round(mean, 6),
        "std": round(math.sqrt(var), 6),
        "min": min(values),
        "max": max(values),
    }


class LineageTracker:
    def __init__(self, registry=None):
        self.registry = registry
        self.generation = 0
        self.generations: List[Dict[str, Any]] = []
        #: child agent-index -> open record awaiting its post-mutation fitness
        self._pending: Dict[int, Dict[str, Any]] = {}

    # -- hooks (called from hpo/ and the training loop) --------------------
    def start_generation(self, fitness_by_index: Dict[int, float]) -> None:
        """Called by tournament selection with the just-evaluated population's
        fitnesses, BEFORE cloning the next generation."""
        self.generation += 1
        fitnesses = [float(v) for v in fitness_by_index.values()]
        record = {
            "generation": self.generation,
            "fitness": _stats(fitnesses),
            "fitness_by_index": {int(k): float(v)
                                 for k, v in fitness_by_index.items()},
            "children": [],
        }
        self.generations.append(record)
        if self.registry is not None:
            self.registry.emit(
                "generation",
                generation=self.generation,
                fitness=record["fitness"],
                fitness_by_index=record["fitness_by_index"],
            )

    def record_selection(
        self,
        parent_index: int,
        child_index: int,
        parent_fitness: float,
        elite: bool = False,
    ) -> None:
        if not self.generations:
            self.start_generation({})
        child = {
            "generation": self.generation,
            "parent": int(parent_index),
            "child": int(child_index),
            "parent_fitness": float(parent_fitness),
            "elite": bool(elite),
            "mutation": None,
            "child_fitness": None,
            "fitness_delta": None,
        }
        self.generations[-1]["children"].append(child)
        self._pending[int(child_index)] = child

    def record_mutation(self, child_index: int, mutation: str) -> None:
        child = self._pending.get(int(child_index))
        if child is not None:
            child["mutation"] = str(mutation)

    def record_fitness(self, agent_index: int, fitness: float) -> None:
        """Close out a child's record with its first post-mutation fitness and
        emit the ``lineage`` event. Unknown indices (initial population,
        already-closed records) are ignored."""
        child = self._pending.pop(int(agent_index), None)
        if child is None:
            return
        child["child_fitness"] = float(fitness)
        child["fitness_delta"] = float(fitness) - child["parent_fitness"]
        if self.registry is not None:
            self.registry.emit("lineage", **child)

    # -- export ------------------------------------------------------------
    def mutation_effects(self) -> Dict[str, Dict[str, float]]:
        """Fitness-delta distribution per mutation class — the 'which
        mutations helped' readout."""
        by_mut: Dict[str, List[float]] = {}
        for gen in self.generations:
            for c in gen["children"]:
                if c["fitness_delta"] is not None:
                    by_mut.setdefault(c["mutation"] or "None", []).append(
                        c["fitness_delta"])
        return {k: _stats(v) for k, v in sorted(by_mut.items())}

    def to_json(self) -> Dict[str, Any]:
        return {
            "generations": self.generations,
            "mutation_effects": self.mutation_effects(),
        }

    def dump(self, path: str) -> None:
        """Atomic write (tmp + fsync + replace): lineage dumps land next to
        snapshots and get read by resume/analysis tooling — a kill mid-dump
        must leave the previous genealogy, never a torn JSON."""
        from agilerl_tpu_torch.resilience.atomic import atomic_write_bytes

        atomic_write_bytes(
            path, json.dumps(self.to_json(), indent=2).encode("utf-8"))
