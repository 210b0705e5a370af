"""The cases that ``tests/torch_dist_harness.RankPool`` runs on every gloo rank
at once (no jax here). Each takes numpy inputs and returns numpy trees; the
test modules compare them with the JAX package and with the port's
single-process results."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from agilerl_tpu_torch.algorithms.grpo import GRPO, make_update_fn
from agilerl_tpu_torch.llm import model as M
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy
from agilerl_tpu_torch.parallel import plan as PL
from agilerl_tpu_torch.utils.tree import tree_map, tree_to_numpy


def _cfg(cfg_kw: Dict[str, Any]) -> M.GPTConfig:
    return M.GPTConfig(dtype=torch.float32, **cfg_kw)


def _placements(tree) -> Dict[str, str]:
    from agilerl_tpu_torch.parallel.tree_paths import named_tree_map

    out = {}

    def put(path, t):
        if hasattr(t, "placements"):
            out[path] = str(tuple(t.placements))

    named_tree_map(put, tree)
    return out


def _agent(cfg_kw, base, actor, reference, kw) -> GRPO:
    cfg = _cfg(cfg_kw)
    agent = GRPO(config=cfg, seed=0, device="cpu",
                 base_params=params_from_numpy(base, cfg, device="cpu"), **kw)
    agent.actor.params = lora_from_numpy(actor, device="cpu")
    agent.reference.params = lora_from_numpy(reference, device="cpu")
    agent.optimizer.init(agent.actor.params)
    return agent


def capture_grads(agent: GRPO) -> list:
    """Wrap ``agent``'s optimizer so that each gradient tree its step is
    handed (after the sum over the ranks, before clipping) lands, as numpy,
    in the returned list."""
    from agilerl_tpu_torch.algorithms.core.optimizer import Transform

    sink, tx = [], agent.optimizer.tx

    def update(grads, state, params=None):
        sink.append(tree_to_numpy(grads))
        return tx.update(grads, state, params)

    agent.optimizer.tx = Transform(tx.init, update)
    return sink


def sp_mesh(sp: int):
    """A mesh whose "sp" axis has ``sp`` ranks (the rest on "dp")."""
    world = dist.get_world_size()
    if sp == world:
        return init_device_mesh("cpu", (sp,), mesh_dim_names=("sp",))
    return init_device_mesh("cpu", (world // sp, sp), mesh_dim_names=("dp", "sp"))


# --------------------------------------------------------------------------- #
# Sharding plans
# --------------------------------------------------------------------------- #


def grpo_learn(cfg_kw, base, actor, reference, batch, kw, axes, learns: int = 1):
    """``GRPO.to_mesh(plan=make_grpo_plan(**axes))`` then ``learns`` learns;
    the ops of the learns' all-gathers."""
    from agilerl_tpu_torch.parallel.comm import collective_log

    agent = _agent(cfg_kw, base, actor, reference, kw)
    agent.to_mesh(plan=PL.make_grpo_plan(**axes))
    with collective_log() as log:
        losses = [agent.learn(batch) for _ in range(learns)]
    return {"losses": losses, "actor": tree_to_numpy(agent.actor.params),
            "adam": tree_to_numpy(agent.optimizer.opt_state),
            "placements": _placements(agent.actor.params),
            "base_placements": _placements(agent.base_params),
            "adam_placements": _placements(agent.optimizer.opt_state),
            "gather_ops": sorted({op for op, _ in log if "gather" in op})}


def grpo_remat_learn(cfg_kw, base, actor, reference, batch, kw, axes):
    """One placed learn with ``remat`` off and on: each one's loss, adapter
    and the count of its all-gathers (the fsdp gathers of the weights)."""
    from agilerl_tpu_torch.parallel.comm import collective_log

    out = {}
    for remat in (False, True):
        agent = _agent(dict(cfg_kw, remat=remat), base, actor, reference, kw)
        agent.to_mesh(plan=PL.make_grpo_plan(**axes))
        with collective_log() as log:
            loss = agent.learn(batch)
        out[remat] = {"loss": loss, "actor": tree_to_numpy(agent.actor.params),
                      "gathers": sum("all_gather" in op for op, _ in log)}
    return out


def plan_step(cfg_kw, base, lora, batch, axes):
    """One update through ``compile_step_with_plan`` (eager) on a fixed batch."""
    from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper

    cfg = _cfg(cfg_kw)
    opt = OptimizerWrapper(optimizer="adamw", lr=5e-6, max_grad_norm=0.1)
    lo = lora_from_numpy(lora, device="cpu")
    opt.init(lo)
    update = make_update_fn(cfg, opt.tx, lora_scale=2.0, use_flash=True)
    plan = PL.make_grpo_plan(**axes)
    step = PL.compile_step_with_plan(update, plan, ("params", "lora", "optimizer", "batch",
                                                    None, None), device="cpu")
    params = params_from_numpy(base, cfg, device="cpu")
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    new, _, loss, kl = step(params, lo, opt.opt_state, b, 0.2, 0.04)
    abstract = step.abstract_args(params, lo)
    return {"loss": float(loss), "kl": float(kl), "lora": tree_to_numpy(new),
            "placements": _placements(new),
            "abstract_wq": str(abstract[0]["blocks"]["0"]["wq"].placements)}


def flywheel_step(cfg_kw, base, actor, reference, batch, kw, axes):
    """``make_sharded_flywheel_step`` at staleness 0 against the sharded GRPO
    step with the on-policy anchor, and a uniformly stale record (beta 0)."""
    from agilerl_tpu_torch.parallel.mesh import (
        make_sharded_flywheel_step,
        make_sharded_grpo_step,
    )

    plan = PL.make_grpo_plan(**axes)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    agent = _agent(cfg_kw, base, actor, reference, kw)
    fly = make_sharded_flywheel_step(agent, plan=plan, rho_clip=2.0)
    logprobs = agent.jit_fn("logprobs", agent._logprob_fn)
    lp_cur = (logprobs(agent.actor.params, b["tokens"], b["mask"]) * b["loss_mask"]).detach()
    ref = _agent(cfg_kw, base, actor, reference, kw)
    ref_update = make_sharded_grpo_step(ref, plan=plan)
    b_ref = dict(b, old_lp=lp_cur)
    b_sync = {k: v for k, v in b.items() if k != "old_lp"}
    b_sync["behavior_lp"] = lp_cur
    _, _, f_loss, f_kl = fly(agent.actor.params, agent.optimizer.opt_state, b_sync, 0.2, 0.0)
    _, _, r_loss, r_kl = ref_update(ref.actor.params, ref.optimizer.opt_state, b_ref, 0.2, 0.0)
    agent2 = _agent(cfg_kw, base, actor, reference, kw)
    fly2 = make_sharded_flywheel_step(agent2, plan=plan, rho_clip=2.0)
    b_stale = {k: v for k, v in b.items() if k != "old_lp"}
    b_stale["behavior_lp"] = lp_cur - 0.5
    _, _, s_loss, _ = fly2(agent2.actor.params, agent2.optimizer.opt_state, b_stale, 0.2, 0.0)
    placed = agent2.jit_fn("update", agent2._update_fn)
    make_sharded_flywheel_step(agent2)
    kept = agent2.jit_fn("update", agent2._update_fn) is placed
    return {"f": (float(f_loss), float(f_kl)), "r": (float(r_loss), float(r_kl)),
            "s": float(s_loss), "kept": kept}


def sharding_mutation(cfg_kw, base, actor, reference, batch, kw, plans):
    """A pop of two GRPO agents on the first plan, mutated to the other."""
    from agilerl_tpu_torch.hpo.mutation import Mutations

    PL.clear_registry()
    try:
        PL.register_default_plans(dist.get_world_size())
        pop = []
        for i in range(2):
            a = _agent(cfg_kw, base, actor, reference, dict(kw, index=i))
            a.to_mesh(plan=plans[0])
            pop.append(a)
        before = [a.learn(batch)[0] for a in pop]
        mut = Mutations(no_mutation=0.0, architecture=0.0, parameters=0.0, activation=0.0,
                        rl_hp=0.0, sharding=1.0, rand_seed=0, sharding_plans=list(plans))
        mutated = mut.mutation(pop)
        after = [a.learn(batch)[0] for a in mutated]
        return {"before": before, "after": after, "muts": [m.mut for m in mutated],
                "plans": [m.sharding_plan.name for m in mutated],
                "registered": PL.registered_plans()}
    finally:
        PL.clear_registry()


def planned_serving(cfg_kw, params, seqs, axes=None, greedy: bool = True, key: int = 1,
                    max_new: int = 8, tp_pairs: bool = False, admission: bool = False):
    """A ``BucketedGenerator``, a ``ContinuousGenerator`` and a
    ``PrefillWorker`` -> ``ContinuousGenerator`` handoff under
    ``make_grpo_plan(**axes)`` (``axes=None``: no plan, in any process;
    ``tp_pairs``: ``make_grpo_plan(tp=2)`` on the "tp" rows of a (world / 2,
    2) mesh, so each pair of ranks serves on its own): their tokens, this
    rank's dense-cache and pool bytes beside the whole, the placements the
    plan gave them, the KV heads each handoff moved, the input shapes of
    every all-gather the two generators ran and the local shapes of the
    tp-sharded weights; with ``admission``, the host conversions
    (``SyncGuard``) of one continuous step that admits 1 and 4 requests."""
    from agilerl_tpu_torch.llm.fleet import PrefillWorker
    from agilerl_tpu_torch.llm.serving import BucketedGenerator, ContinuousGenerator
    from agilerl_tpu_torch.parallel.comm import collective_log

    cfg = _cfg(cfg_kw)
    plan = PL.make_grpo_plan(**axes) if axes is not None else None
    mesh = None
    if tp_pairs:
        plan = PL.make_grpo_plan(tp=2)
        mesh = init_device_mesh("cpu", (dist.get_world_size() // 2, 2),
                                mesh_dim_names=("dp", "tp"))["tp"]
    seqs = [np.asarray(s) for s in seqs]
    gkw = dict(max_new_tokens=max_new, pad_id=0, eos_id=None, prompt_buckets=(16,),
               decode_chunk=4, sharding_plan=plan, mesh=mesh, device="cpu")
    bg = BucketedGenerator(cfg, row_buckets=(8,), **gkw)
    placed = bg.place_params(params_from_numpy(params, cfg, device="cpu"))
    cg = ContinuousGenerator(cfg, slots=4, block_size=8, **gkw)
    out = {}
    with collective_log() as log:
        out["bucketed"] = bg.generate(seqs, key, placed, greedy=greedy)[:2]
        out["continuous"] = cg.generate(seqs, key, placed, greedy=greedy)[:2]
    out["gathers"] = sorted({shape for op, shape in log if "gather" in op})
    out["gather_ops"] = sorted({op for op, _ in log if "gather" in op})
    dense = M.init_caches(cfg, 8, 16 + max_new, device="meta")
    out["dense_whole_bytes"] = M.cache_bytes(dense)
    out["pool_whole_bytes"] = 2 * cg._pool.k.numel() * cg._pool.k.element_size()
    out["pool_rank_bytes"] = cg.pool_bytes
    if plan is not None:
        rank_dense = plan.zeros("kv", dense, bg.mesh, device="cpu")
        out["dense_rank_bytes"] = M.cache_bytes(rank_dense)
        out["dense_placements"] = str(tuple(rank_dense.k.placements))
        out["pool_placements"] = str(tuple(cg._pool.k.placements))
        out["wq"] = str(tuple(placed["blocks"]["0"]["wq"].placements))
        out["w_up"] = str(tuple(placed["blocks"]["0"]["w_up"].placements))
        out["kv_k"] = tuple(plan.resolve("kv", dense, bg.mesh).k)
        out["tp_weights"] = sorted({tuple(w.to_local().shape)
                                    for blk in placed["blocks"].values() for w in blk.values()
                                    if any(p.is_shard() for p in w.placements)})
    worker = PrefillWorker.matching(cg, sharding_plan=plan, mesh=mesh)
    replica = ContinuousGenerator(cfg, slots=4, block_size=8, **gkw)
    tickets, out["kv_heads"] = [], []
    for i, s in enumerate(seqs):
        payload = worker.prefill(s, (key, i), placed, greedy=greedy)
        out["kv_heads"].append(payload["kv_heads"])
        out["payload_heads"] = payload["k"].shape[2]
        tickets.append(replica.submit_prefilled(
            payload["tokens"], k_prompt=payload["k"], v_prompt=payload["v"],
            tok0=payload["tok0"], done0=payload["done0"], key_next=payload["key_next"],
            key=(key, i), kv_heads=payload["kv_heads"]))
    replica.run_until_drained(placed, greedy=greedy)
    out["handoff"] = np.stack([replica.result(t)[0] for t in tickets])
    if admission:
        from agilerl_tpu_torch.analysis import SyncGuard

        out["admission_syncs"] = {}
        for k in (1, 4):
            gen = ContinuousGenerator(cfg, slots=4, block_size=8, **gkw)
            for x in seqs[:k]:
                gen.submit(x)
            with SyncGuard(device="cpu") as guard:
                gen.step(placed, greedy=greedy)
            out["admission_syncs"][k] = guard.syncs
    return out


def evoppo(device="cpu"):
    """The EvoPPO engine of the JAX pod-generation test (CartPole, width 16)."""
    from agilerl_tpu_torch.algorithms.core import optimizer as O
    from agilerl_tpu_torch.envs.classic import CartPole
    from agilerl_tpu_torch.modules.mlp import MLPConfig
    from agilerl_tpu_torch.networks import distributions as D
    from agilerl_tpu_torch.networks.base import NetworkConfig
    from agilerl_tpu_torch.parallel.population import EvoPPO

    enc = MLPConfig(num_inputs=4, num_outputs=16, hidden_size=(16,), output_vanish=False)
    actor, critic = (NetworkConfig(encoder_kind="mlp", encoder=enc, latent_dim=16,
                                   head=MLPConfig(num_inputs=16, num_outputs=n,
                                                  hidden_size=(16,)))
                     for n in (2, 1))
    return EvoPPO(CartPole(), actor, critic, D.dist_config_from_space(CartPole().action_space),
                  O.adam(3e-4), num_envs=4, rollout_len=8, update_epochs=1,
                  num_minibatches=2, device=device)


def pod_generation(axis_size: int, pop: int, generations: int, seed: int = 0):
    """EvoPPO through ``ScanRun(plan=make_population_plan(...))``: this
    rank's members and the whole fitness history."""
    from agilerl_tpu_torch.parallel.generation import ScanRun, population_state_dict

    run = ScanRun(evoppo(), pop, seed=seed, plan=PL.make_population_plan(axis_size))
    fit = run.run(generations)
    return {"fitness": fit, "pop": population_state_dict(run.pop)["leaves"]}


# --------------------------------------------------------------------------- #
# Long context
# --------------------------------------------------------------------------- #


def ring(q, k, v, sp, causal, use_flash, mask=None):
    """The ring over ``sp`` ranks: whole output and this rank's gradients of
    sum(out ** 2) (each nonzero on the rank's own block only)."""
    from agilerl_tpu_torch.ops.ring_attention import make_ring_attention

    mesh = sp_mesh(sp)
    qq, kk, vv = (torch.tensor(t, requires_grad=True) for t in (q, k, v))
    fn = make_ring_attention(mesh, causal=causal, with_mask=mask is not None,
                             use_flash=use_flash)
    out = fn(qq, kk, vv, None if mask is None else torch.as_tensor(mask))
    (out ** 2).sum().backward()
    return {"out": out.detach().numpy(), "grads": [t.grad.numpy() for t in (qq, kk, vv)]}


def sp_logprobs(cfg_kw, params, lora, tokens, sp, flash):
    """``make_sp_logprob_fn`` and the gradient of -mean(lp) into the adapter,
    summed over the ring."""
    from agilerl_tpu_torch.llm.long_context import make_sp_logprob_fn
    from agilerl_tpu_torch.parallel.comm import all_reduce_sum_

    cfg = dataclasses.replace(_cfg(cfg_kw), use_flash_attention=flash)
    mesh = sp_mesh(sp)
    base = params_from_numpy(params, cfg, device="cpu")
    lo = tree_map(lambda t: t.requires_grad_(True), lora_from_numpy(lora, device="cpu"))
    lp = make_sp_logprob_fn(cfg, mesh)(base, lo, torch.as_tensor(tokens))
    (-lp.mean()).backward()
    group = mesh.get_group("sp")
    grads = tree_map(lambda t: all_reduce_sum_(t.grad.clone(), group), lo)
    return {"lp": lp.detach().numpy(), "grads": tree_to_numpy(grads)}


def grpo_sp_learn(cfg_kw, base, actor, reference, batch, kw, sp, flash):
    """``GRPO(sequence_parallel_axis="sp")`` on a mesh whose sp axis has
    ``sp`` ranks: one learn, with the gradient its optimizer step took."""
    cfg_kw = dict(cfg_kw, use_flash_attention=flash)
    agent = _agent(cfg_kw, base, actor, reference, dict(kw, sequence_parallel_axis="sp"))
    agent.to_mesh(mesh=sp_mesh(sp))
    grads = capture_grads(agent)
    try:
        loss, kl = agent.learn(batch)
    except ValueError as e:  # the batch contract: the same on every rank
        return {"refused": str(e)}
    return {"loss": loss, "kl": kl, "actor": tree_to_numpy(agent.actor.params),
            "adam": tree_to_numpy(agent.optimizer.opt_state), "grad": grads[0]}


def grpo_sp_remat(cfg_kw, base, actor, reference, batch, kw, sp):
    """One sp learn (flash engine) with ``remat`` off and on: each one's
    loss, the gradient its optimizer step took, and the flash forwards and
    backwards it ran on this rank."""
    from agilerl_tpu_torch.ops import flash_attention_vjp as fa

    out = {}
    for remat in (False, True):
        agent = _agent(dict(cfg_kw, use_flash_attention=True, remat=remat), base, actor,
                       reference, dict(kw, sequence_parallel_axis="sp"))
        agent.to_mesh(mesh=sp_mesh(sp))
        grads = capture_grads(agent)
        calls = {"fwd": 0, "bwd": 0}
        real = {"fwd": fa._fwd, "bwd": fa._bwd}

        def counted(name):
            def call(*a):
                calls[name] += 1
                return real[name](*a)
            return call

        fa._fwd, fa._bwd = counted("fwd"), counted("bwd")
        try:
            loss, _ = agent.learn(batch)
        finally:
            fa._fwd, fa._bwd = real["fwd"], real["bwd"]
        out[remat] = {"loss": loss, "grad": grads[0], "calls": calls}
    return out


# --------------------------------------------------------------------------- #
# Several hosts: the pipeline, the timed barrier, elastic PBT over ranks
# --------------------------------------------------------------------------- #


def pp_mesh(pp: int, fsdp: int = 1):
    """A mesh whose "pp" axis has ``pp`` ranks: ("pp", "fsdp") when ``fsdp``
    > 1 (their product the world), else ("dp", "pp") with the rest on dp."""
    world = dist.get_world_size()
    if fsdp > 1:
        return init_device_mesh("cpu", (pp, fsdp), mesh_dim_names=("pp", "fsdp"))
    if pp == world:
        return init_device_mesh("cpu", (pp,), mesh_dim_names=("pp",))
    return init_device_mesh("cpu", (world // pp, pp), mesh_dim_names=("dp", "pp"))


def _pipeline_loss(cfg, rest, stacked, tokens, mesh, micro, fsdp, mask=None):
    from agilerl_tpu_torch.parallel.pipeline import pipeline_apply

    tokens = torch.as_tensor(tokens)
    logits = pipeline_apply(cfg, {**rest, "blocks": {}}, tokens, mesh, micro,
                            attention_mask=None if mask is None else torch.as_tensor(mask),
                            stacked=stacked, fsdp_axis="fsdp" if fsdp > 1 else None)
    targets = torch.roll(tokens, -1, dims=1)
    lp = torch.log_softmax(logits, -1)
    return logits, -lp.gather(-1, targets[..., None]).mean()


def _pipeline_params(cfg_kw, params, pp, fsdp):
    from agilerl_tpu_torch.parallel.pipeline import shard_stacked_blocks, stack_blocks

    cfg = _cfg(cfg_kw)
    p = params_from_numpy(params, cfg, device="cpu")
    mesh = pp_mesh(pp, fsdp)
    stacked = shard_stacked_blocks(stack_blocks(p, cfg), mesh, "pp",
                                   "fsdp" if fsdp > 1 else None)
    rest = {k: v for k, v in p.items() if k != "blocks"}
    return cfg, mesh, rest, stacked


def pipeline_run(cfg_kw, params, tokens, pp: int, micro: int, fsdp: int = 1, mask=None,
                 grads: bool = False):
    """``pipeline_apply`` on this rank: logits, the loss of the next-token
    targets and, with ``grads``, the gradient of every leaf this rank holds
    (its stage's, and fsdp shard's, block slices) with its mesh coordinates."""
    cfg, mesh, rest, stacked = _pipeline_params(cfg_kw, params, pp, fsdp)
    leaves = list(rest.values()) + list(stacked.values())
    for t in leaves:
        t.requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        logits, loss = _pipeline_loss(cfg, rest, stacked, tokens, mesh, micro, fsdp, mask)
    out = {"logits": logits.detach().numpy(), "loss": loss.item(),
           "stage": mesh.get_local_rank("pp"),
           "shard": mesh.get_local_rank("fsdp") if fsdp > 1 else 0}
    if grads:
        g = torch.autograd.grad(loss, leaves)
        names = list(rest) + list(stacked)
        out["grads"] = {n: x.numpy() for n, x in zip(names, g)}
    return out


def pipeline_train(cfg_kw, params, tokens, pp: int, micro: int, steps: int = 2,
                   lr: float = 1e-2):
    """SGD steps on the sharded stack (and the replicated rest): the losses."""
    cfg, mesh, rest, stacked = _pipeline_params(cfg_kw, params, pp, 1)
    leaves = list(rest.values()) + list(stacked.values())
    losses = []
    for _ in range(steps):
        for t in leaves:
            t.requires_grad_(True)
        with torch.enable_grad():
            _, loss = _pipeline_loss(cfg, rest, stacked, tokens, mesh, micro, 1)
            g = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, gt in zip(leaves, g):
                t.sub_(lr * gt)
        losses.append(loss.item())
    return losses


def late_barrier(wait_s: float, late_s: float):
    """Rank 0 crosses a barrier with a ``wait_s`` timeout; the others enter it
    ``late_s`` seconds later. Rank 0 returns what the barrier raised and the
    timeout counter; every rank then crosses a plain barrier (the abandoned
    one completes when the late ranks enter) and an all-reduce."""
    import time

    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.parallel import multihost
    from agilerl_tpu_torch.resilience.membership import MembershipChange

    out = {}
    if dist.get_rank() == 0:
        reg = MetricsRegistry()
        t0 = time.perf_counter()
        try:
            multihost.call_with_collective_timeout(dist.barrier, wait_s, name="barrier:late",
                                                   registry=reg)
            out["raised"] = None
        except MembershipChange as e:
            out["raised"] = str(e)
        out["after_s"] = time.perf_counter() - t0
        out["timeouts"] = reg.counter("resilience/collective_timeouts_total").value
    else:
        time.sleep(late_s)
        dist.barrier()
    dist.barrier()
    t = torch.ones(1)
    dist.all_reduce(t)
    out["sum"] = float(t)
    return out


def elastic_pod(pop: int, generations: int, store: str, seed: int = 0,
                wait_s: float = 120.0):
    """An ``ElasticPBTController`` per rank (pod mode: one slot a rank) over
    the EvoPPO engine above, sharing ``store``: its fitness rows, layout and
    the snapshots rank 0 committed."""
    from agilerl_tpu_torch.parallel.elastic import ElasticPBTController, EmulatedHost, device_slots

    ctl = ElasticPBTController(evoppo(), pop, store, seed=seed,
                               hosts=[EmulatedHost(dist.get_rank(), device_slots(1, "cpu"))],
                               generation_timeout=wait_s, heartbeat_timeout=30.0)
    hist = ctl.run(generations)
    return {"hist": hist, "layout": ctl.layout(), "ids": ctl.member_ids,
            "snapshots": [s.step for s in ctl.manager.snapshots()]}


def multihost_worker(pid: int, nproc: int, port: int, conn) -> None:
    """One process of the two-process ``init_multihost`` test (the port of
    ``tests/test_parallel/_multihost_worker.py``): join over localhost,
    agree on a seed (rank 0 proposes 1234, rank 1 999), cross barriers, run
    a tournament on a replicated population with replicated fitness and a
    metric mean over hosts; the decisions go back through ``conn``."""
    import traceback

    torch.set_num_threads(1)
    try:
        from agilerl_tpu_torch.hpo.tournament import TournamentSelection
        from agilerl_tpu_torch.parallel.multihost import barrier, broadcast_seed, init_multihost
        from agilerl_tpu_torch.utils.spaces import Box, Discrete
        from agilerl_tpu_torch.utils.utils import aggregate_metrics_across_hosts, create_population

        init_multihost(f"127.0.0.1:{port}", nproc, pid, timeout=60.0)
        out = {"world": dist.get_world_size()}
        seed = broadcast_seed(1234 if pid == 0 else 999)
        out["seed"] = seed
        barrier("after-seed", timeout=60.0)
        pop = create_population("DQN", Box(low=-1, high=1, shape=(4,)), Discrete(2),
                                {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)}},
                                population_size=4, seed=seed, device="cpu")
        for agent, f in zip(pop, [3.0, 1.0, 4.0, 1.5]):  # replicated, as all-gathered scores
            agent.fitness = [f]
        tournament = TournamentSelection(tournament_size=2, elitism=True, population_size=4,
                                         eval_loop=1, rng=np.random.default_rng(seed))
        elite, new_pop = tournament.select(pop)
        out["elite"] = elite.index
        out["pop"] = [a.index for a in new_pop]
        out["agg"] = aggregate_metrics_across_hosts(1.0 + 2.0 * pid)
        barrier("done", timeout=60.0)
        conn.send(("ok", out))
    except Exception:  # noqa: BLE001 - the traceback goes to the test
        conn.send(("err", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# --------------------------------------------------------------------------- #
# Layout search
# --------------------------------------------------------------------------- #


def layout_search(cfg_kw, base, actor, reference, batch, kw, warmup: int = 0, steps: int = 1):
    """``search_layouts`` over the default GRPO plans for the world size:
    each call places a fresh agent by the candidate's plan (``donate``: args
    rebuilt per call) and learns once on ``batch``. The plan registry is
    restored after."""
    from agilerl_tpu_torch.observability import MemorySink, MetricsRegistry
    from agilerl_tpu_torch.parallel.layout_search import search_layouts

    saved = dict(PL._REGISTRY)
    PL.clear_registry()
    losses: Dict[str, list] = {}

    def args_for(plan, mesh):
        agent = _agent(cfg_kw, base, actor, reference, kw)
        agent.to_mesh(mesh=mesh, plan=plan)
        return (agent,)

    def learn(agent):
        out = agent.learn(batch)
        losses.setdefault(agent.sharding_plan.name, []).append(out)
        return out

    sink = MemorySink()
    reg = MetricsRegistry(sink=sink)
    try:
        result = search_layouts(learn, (None,), args_for, device="cpu", warmup=warmup,
                                steps=steps, donate=True, registry=reg)
    finally:
        PL._REGISTRY.clear()
        PL._REGISTRY.update(saved)
    return {"ranked": [c.plan.name for c in result.ranked],
            "summary": result.to_dict(), "losses": losses,
            "events": [e["plan"] for e in sink.events if e["kind"] == "layout_search"],
            "best_gauge": reg.gauge("layout_search/best_step_time_s").value}
