"""The population as one program on one card: the port of
``agilerl_tpu/parallel/`` for evolutionary PPO (``generation``,
``population``) and the off-policy family (the stacked replay rings,
``ScanOffPolicy``, ``off_policy``: ``EvoDQN``, ``EvoRainbow``, ``EvoDDPG``,
``EvoTD3``) and the multi-agent population (``multi_agent``: ``EvoIPPO``).
``make_pod_generation`` shards a population's members over the ``pop``
axis of a mesh. The sharding plans (``plan``, ``mesh``, ``tree_paths``) and
the hand-run collectives (``comm``) live in their own modules, as do the
several-host helpers (``multihost``), the GPipe pipeline (``pipeline``) and
elastic PBT across hosts that can disappear (``elastic``)."""

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
from agilerl_tpu_torch.parallel.elastic import (
    ElasticPBTController,
    EmulatedHost,
    IslandConfig,
    Slot,
    device_slots,
    make_emulated_hosts,
)
from agilerl_tpu_torch.parallel.multihost import (
    barrier,
    broadcast_seed,
    call_with_collective_timeout,
    init_multihost,
)
from agilerl_tpu_torch.parallel.multi_agent import EvoIPPO, IPPOMemberState
from agilerl_tpu_torch.parallel.off_policy import EvoDDPG, EvoDQN, EvoRainbow, EvoTD3
from agilerl_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_hidden_fn,
    shard_stacked_blocks,
    stack_blocks,
    unstack_blocks,
)
from agilerl_tpu_torch.parallel.population import EvoPPO, MemberState

__all__ = [
    "DeviceReplayRing", "EvoDDPG", "EvoDQN", "EvoIPPO", "EvoPPO", "EvoRainbow", "EvoTD3",
    "IPPOMemberState", "MemberState",
    "ScanMemberState", "ScanOffPolicy", "ScanRun", "apply_evolution", "evolve_actor_critic",
    "gaussian_mutate", "make_pod_generation", "make_vmap_generation", "mutation_noise",
    "population_load_state_dict", "population_state_dict", "ring_init", "ring_nstep_gather",
    "ring_sample_per", "ring_sample_uniform", "ring_update_priorities", "ring_write",
    "tournament_select",
    "init_multihost", "broadcast_seed", "barrier", "call_with_collective_timeout",
    "ElasticPBTController", "EmulatedHost", "IslandConfig", "Slot", "device_slots",
    "make_emulated_hosts",
    "pipeline_apply", "pipeline_hidden_fn", "shard_stacked_blocks", "stack_blocks",
    "unstack_blocks",
]
