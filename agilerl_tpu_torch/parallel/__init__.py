"""The population as one program on one card: the port of
``agilerl_tpu/parallel/`` for evolutionary PPO (``generation``,
``population``). Pod sharding (slice 6), the off-policy scan tier
(``DeviceReplayRing``, ``ScanOffPolicy``: slice 5c-scan) and the multi-agent
population (slice 5d) come with their slices; the first two raise until then."""

from agilerl_tpu_torch.parallel.generation import (
    DeviceReplayRing,
    ScanOffPolicy,
    ScanRun,
    apply_evolution,
    evolve_actor_critic,
    gaussian_mutate,
    make_pod_generation,
    make_vmap_generation,
    mutation_noise,
    population_load_state_dict,
    population_state_dict,
    tournament_select,
)
from agilerl_tpu_torch.parallel.population import EvoPPO, MemberState

__all__ = [
    "DeviceReplayRing", "EvoPPO", "MemberState", "ScanOffPolicy", "ScanRun", "apply_evolution", "evolve_actor_critic",
    "gaussian_mutate", "make_pod_generation", "make_vmap_generation", "mutation_noise",
    "population_load_state_dict", "population_state_dict", "tournament_select",
]
