"""The population as one program on one card: the port of
``agilerl_tpu/parallel/`` for evolutionary PPO (``generation``,
``population``) and the off-policy family (the stacked replay rings,
``ScanOffPolicy``, ``off_policy``: ``EvoDQN``, ``EvoRainbow``, ``EvoDDPG``,
``EvoTD3``) and the multi-agent population (``multi_agent``: ``EvoIPPO``).
Pod sharding comes with slice 6; ``make_pod_generation`` raises until then."""

from agilerl_tpu_torch.parallel.generation import (
    DeviceReplayRing,
    ScanMemberState,
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
    ring_init,
    ring_nstep_gather,
    ring_sample_per,
    ring_sample_uniform,
    ring_update_priorities,
    ring_write,
    tournament_select,
)
from agilerl_tpu_torch.parallel.multi_agent import EvoIPPO, IPPOMemberState
from agilerl_tpu_torch.parallel.off_policy import EvoDDPG, EvoDQN, EvoRainbow, EvoTD3
from agilerl_tpu_torch.parallel.population import EvoPPO, MemberState

__all__ = [
    "DeviceReplayRing", "EvoDDPG", "EvoDQN", "EvoIPPO", "EvoPPO", "EvoRainbow", "EvoTD3",
    "IPPOMemberState", "MemberState",
    "ScanMemberState", "ScanOffPolicy", "ScanRun", "apply_evolution", "evolve_actor_critic",
    "gaussian_mutate", "make_pod_generation", "make_vmap_generation", "mutation_noise",
    "population_load_state_dict", "population_state_dict", "ring_init", "ring_nstep_gather",
    "ring_sample_per", "ring_sample_uniform", "ring_update_priorities", "ring_write",
    "tournament_select",
]
