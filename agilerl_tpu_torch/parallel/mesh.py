"""Device meshes and the GRPO placements on them: the port of
``agilerl_tpu/parallel/mesh.py``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the process group's
ranks, one card per rank (the JAX ``Mesh`` over local devices); a
PartitionSpec becomes DTensor placements (``parallel/plan.py``). Data
parallelism shards batch rows over ``("dp", "fsdp")``; fsdp shards
parameters, which are gathered over the data axes where they are used
(``llm/model.py``); tp shards heads and feature columns.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from agilerl_tpu_torch.llm.model import GPTConfig
from agilerl_tpu_torch.parallel.plan import (
    P,
    PartitionSpec,
    ShardingPlan,
    gpt_param_rules,
    grpo_plan_for_mesh,
    lora_rules,
    match_partition_rules,
    mesh_axis_sizes,
    place_by_shape,
    spec_to_placements,
)


def _build(axes: Dict[str, int], device: Any = None):
    return ShardingPlan(name="mesh", axes=axes).build_mesh(device)


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, ep: int = 1, device: Any = None):
    """A (dp, fsdp, tp[, ep]) mesh over the process group (the ep axis only
    when > 1). The product must equal the world size."""
    axes = {"dp": int(dp), "fsdp": int(fsdp), "tp": int(tp)}
    if ep > 1:
        axes["ep"] = int(ep)
    return _build(axes, device)


def auto_mesh(n_devices: Optional[int] = None, device: Any = None):
    """Every rank on fsdp (pure ZeRO-style)."""
    from agilerl_tpu_torch.parallel.plan import live_device_count

    return make_mesh(fsdp=int(n_devices or live_device_count()), device=device)


def make_multislice_mesh(dcn_dp: int, fsdp: int, tp: int = 1, device: Any = None):
    """(dp, fsdp, tp) with the dp axis across slices. The port's mesh is one
    ``DeviceMesh`` whatever the links: the dp axis is outermost, so the
    ranks of one slice are consecutive."""
    return make_mesh(dp=dcn_dp, fsdp=fsdp, tp=tp, device=device)


def gpt_param_specs(config: GPTConfig, params: Optional[Dict] = None) -> Dict:
    """PartitionSpec tree of the GPT parameters (the rule engine's
    ``gpt_param_rules``); without ``params``, over a meta-device init."""
    if params is None:
        from agilerl_tpu_torch.llm.model import init_params

        params = init_params(0, config, device="meta")
    return match_partition_rules(gpt_param_rules(), params)


def filter_spec(spec: PartitionSpec, mesh) -> PartitionSpec:
    """Drop axis names the mesh does not carry, or carries at size 1."""
    sizes = mesh_axis_sizes(mesh)

    def keep(e):
        if e is None:
            return None
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if sizes.get(a, 1) > 1)
            return kept if kept else None
        return e if sizes.get(e, 1) > 1 else None

    return P(*(keep(e) for e in spec))


def lora_specs(lora: Any) -> Any:
    """LoRA: A row-sharded on fsdp, B column-sharded on tp."""
    return match_partition_rules(lora_rules(), lora)


def shard_like(tree: Any, template: Any, template_specs: Any, mesh) -> Any:
    """Every leaf whose shape matches a template leaf takes its spec."""
    return place_by_shape(tree, template, template_specs, mesh)


def shard_params(params: Any, config: GPTConfig, mesh) -> Any:
    """Place a GPT parameter tree by the built-in rule set, attention by
    whole heads."""
    return grpo_plan_for_mesh(mesh).place("params", params, mesh,
                                          heads=(config.n_head, config.kv_heads))


def batch_sharding(mesh):
    """Placements of a batch leaf: rows over (dp, fsdp)."""
    return spec_to_placements(filter_spec(P(("dp", "fsdp")), mesh), mesh)


def replicated(mesh):
    return spec_to_placements(P(), mesh)


def place_batch(batch: Dict[str, Any], mesh) -> Dict[str, Any]:
    """Every leaf of a batch dict as a DTensor with rows over (dp, fsdp)."""
    from agilerl_tpu_torch.parallel.plan import place_tensor

    pl = batch_sharding(mesh)
    return {k: place_tensor(torch.as_tensor(v), mesh, pl) for k, v in batch.items()}


# --------------------------------------------------------------------------- #
# Sharded GRPO steps
# --------------------------------------------------------------------------- #


def make_sharded_grpo_step(agent, mesh=None, plan=None, place: bool = True):
    """Place the agent's trees by the plan (``agent.to_mesh``) and return
    ``update(lora, opt_state, batch, clip, beta)``, which places the batch
    by the data layout and runs the agent's update on the placed tensors.
    ``place=False`` keeps an agent already placed on this mesh."""
    if place:
        agent.to_mesh(mesh=mesh, plan=plan)
    update = agent.jit_fn("update", agent._update_fn)
    mesh = agent.mesh

    def sharded_update(lora, opt_state, batch, clip, beta):
        return update(lora, opt_state, place_batch(batch, mesh), clip, beta)

    return sharded_update


def make_sharded_flywheel_step(agent, mesh=None, plan=None, rho_clip: float = 2.0):
    """The flywheel learner's step: the sharded update driven by trajectory
    batches carrying the behavior epoch's logprobs. The clipped-ratio anchor
    ``old_lp`` is the current adapter's logprobs, recomputed here on the
    placed batch, and the staleness is corrected once by
    ``rho = min(exp(old_lp - behavior_lp), rho_clip)`` on the pg term (as
    ``GRPO.learn_from_trajectory``). With neither ``mesh`` nor ``plan``, an
    agent already placed keeps its placement."""
    adopted = False
    if mesh is None and plan is None:
        mesh = getattr(agent, "mesh", None)
        plan = getattr(agent, "sharding_plan", None)
        adopted = mesh is not None or plan is not None
    raw = make_sharded_grpo_step(agent, mesh, plan=plan, place=not adopted)
    logprobs = agent.jit_fn("logprobs", agent._logprob_fn)
    mesh = agent.mesh

    def sharded_flywheel_update(lora, opt_state, batch, clip, beta):
        batch = place_batch(batch, mesh)
        loss_mask = batch["loss_mask"].float()
        behavior = batch.pop("behavior_lp").float() * loss_mask
        old_lp = logprobs(lora, batch["tokens"], batch["mask"]) * loss_mask
        batch["old_lp"] = old_lp
        batch["rho"] = torch.exp(old_lp - behavior).clamp_max(float(rho_clip))
        return raw(lora, opt_state, batch, clip, beta)

    return sharded_flywheel_update
