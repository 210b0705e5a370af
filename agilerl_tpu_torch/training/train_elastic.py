"""Entry point for elastic preemption-native PBT: the port of
``agilerl_tpu/training/train_elastic.py``.

``train_elastic_pbt`` is the loop-shaped wrapper around
:class:`~agilerl_tpu_torch.parallel.elastic.ElasticPBTController`: build the
controller over a host topology and a shared store, optionally resume from
the latest complete snapshot, drive N generations, and hand back the
controller (fitness history, member ids, layout).

One-process emulation::

    engine = EvoDQN(env, net_cfg, adam(1e-3), num_envs=4, device="cpu")
    ctl = train_elastic_pbt(
        engine, pop_size=4, generations=6, store_dir="runs/exp/elastic",
        hosts=make_emulated_hosts(2, device_slots(4, "cpu")), heartbeat_timeout=0.5,
        fault_injector=FaultInjector(kill_host_at={2: 1}),
    )

On several hosts, run one process per rank after
``parallel.multihost.init_multihost(...)`` with
``hosts=[EmulatedHost(rank, device_slots(1))]`` and the same shared
``store_dir``; pass ``resume=True`` so a restarted pod (at any world size)
continues the run from the last committed snapshot.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Union

from agilerl_tpu_torch.parallel.elastic import ElasticPBTController, EmulatedHost, IslandConfig


def train_elastic_pbt(
    engine,
    pop_size: int,
    generations: int,
    store_dir: Union[str, Path],
    *,
    seed: int = 0,
    hosts: Optional[List[EmulatedHost]] = None,
    n_hosts: Optional[int] = None,
    devices: Optional[Sequence] = None,
    heartbeat_timeout: float = 2.0,
    generation_timeout: Optional[float] = None,
    snapshot_every: int = 1,
    keep_last: int = 3,
    keep_best: bool = True,
    island: Optional[IslandConfig] = None,
    telemetry=None,
    fault_injector=None,
    max_members_per_device: Optional[int] = None,
    resume: bool = False,
    controller: Optional[ElasticPBTController] = None,
) -> ElasticPBTController:
    """Run ``generations`` of elastic PBT; returns the controller. Pass a
    pre-built ``controller`` to continue an in-process run (the topology
    kwargs are then ignored)."""
    if controller is None:
        controller = ElasticPBTController(
            engine, pop_size, store_dir,
            seed=seed, hosts=hosts, n_hosts=n_hosts, devices=devices,
            heartbeat_timeout=heartbeat_timeout, generation_timeout=generation_timeout,
            snapshot_every=snapshot_every, keep_last=keep_last, keep_best=keep_best,
            island=island, telemetry=telemetry, fault_injector=fault_injector,
            max_members_per_device=max_members_per_device,
        )
    if resume:
        controller.resume()
    controller.run(generations)
    return controller
