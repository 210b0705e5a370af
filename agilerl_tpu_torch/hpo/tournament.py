"""Tournament selection: the port of ``agilerl_tpu/hpo/tournament.py``
(fitness = mean of the last ``eval_loop`` scores, elitism, k-way
tournaments). Pure numpy: the same Generator gives the same picks as the JAX
package."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from agilerl_tpu_torch.utils.rng import derive_rng


class TournamentSelection:
    def __init__(
        self,
        tournament_size: int = 2,
        elitism: bool = True,
        population_size: int = 6,
        eval_loop: int = 1,
        rng: Optional[np.random.Generator] = None,
        lineage=None,
    ):
        self.tournament_size = int(tournament_size)
        self.elitism = bool(elitism)
        self.population_size = int(population_size)
        self.eval_loop = int(eval_loop)
        self.rng = derive_rng(rng)
        #: optional lineage tracker (``start_generation``/``record_selection``):
        #: records the generation's fitness distribution and every selection
        self.lineage = lineage

    def _fitness(self, agent) -> float:
        window = agent.fitness[-self.eval_loop:]
        return float(np.mean(window)) if window else -np.inf

    def _tournament(self, fitnesses: np.ndarray) -> int:
        """k-way tournament: sample k entrants, return the fittest's index."""
        entrants = self.rng.choice(
            len(fitnesses), size=min(self.tournament_size, len(fitnesses)), replace=False
        )
        return int(entrants[np.argmax(fitnesses[entrants])])

    def select(self, population: List, target_size: Optional[int] = None) -> Tuple[object, List]:
        """Return (elite, next_generation). The elite is always cloned into the
        next generation when elitism is on. ``target_size`` draws the next
        generation at that size instead of ``population_size``."""
        fitnesses = np.array([self._fitness(a) for a in population])
        elite_idx = int(np.argmax(fitnesses))
        elite = population[elite_idx]
        if self.lineage is not None:
            self.lineage.start_generation({a.index: f for a, f in zip(population, fitnesses)})

        size = self.population_size if target_size is None else max(int(target_size), 1)
        max_id = max(a.index for a in population)
        new_population = []
        if self.elitism:
            new_population.append(elite.clone(index=elite.index))
            if self.lineage is not None:
                self.lineage.record_selection(elite.index, elite.index, fitnesses[elite_idx],
                                              elite=True)
        while len(new_population) < size:
            winner_idx = self._tournament(fitnesses)
            winner = population[winner_idx]
            max_id += 1
            new_population.append(winner.clone(index=max_id))
            if self.lineage is not None:
                self.lineage.record_selection(winner.index, max_id, fitnesses[winner_idx])
        return elite, new_population
