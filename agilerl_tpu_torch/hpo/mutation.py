"""Mutations engine: the port of ``agilerl_tpu/hpo/mutation.py``.

The option list and the draw that picks from it are the JAX package's
(five entries, plus sharding when its probability is set; one
``rng.choice`` per agent), so the same numpy seed gives the same picks, the
same architecture methods and magnitudes and the same hyperparameter
values. The architecture branch samples a method on the policy network and
applies it (or an analogous one) to every evolvable network, transactionally:
a failure restores every network and optimizer state. Parameter noise draws
from a ``torch.Generator`` (the JAX key's counterpart), so it matches by
distribution only. The activation branch is a no-op for agents that do not
support it (the policy-gradient ones). The sharding branch raises until
the distribution slice.

One repair against the JAX package: a ``learn_step`` mutation resizes every
rollout buffer of the agent, IPPO's per-group ``rollout_buffers`` too; the
JAX engine resizes ``rollout_buffer`` only, so an IPPO agent there keeps
its old horizon (GAE and the minibatches then run over stale rows).
"""

from __future__ import annotations

import warnings
from typing import Any, List, Optional

import numpy as np
import torch

from agilerl_tpu_torch.utils.rng import derive_key, derive_rng
from agilerl_tpu_torch.utils.tree import tree_copy, tree_map


class Mutations:
    def __init__(
        self,
        no_mutation: float = 0.2,
        architecture: float = 0.2,
        new_layer_prob: float = 0.2,
        parameters: float = 0.2,
        activation: float = 0.2,
        rl_hp: float = 0.2,
        mutation_sd: float = 0.1,
        activation_selection: Optional[List[str]] = None,
        mutate_elite: bool = True,
        rand_seed: Optional[int] = None,
        lineage=None,
        sharding: float = 0.0,
        sharding_plans: Optional[List[Any]] = None,
    ):
        self.no_mut = float(no_mutation)
        self.architecture_mut = float(architecture)
        self.new_layer_prob = float(new_layer_prob)
        self.parameters_mut = float(parameters)
        self.activation_mut = float(activation)
        self.rl_hp_mut = float(rl_hp)
        self.mutation_sd = float(mutation_sd)
        self.activation_selection = activation_selection or ["ReLU", "ELU", "GELU"]
        self.mutate_elite = bool(mutate_elite)
        # the two fallback draws of the JAX package, in its order
        self.rng = derive_rng(seed=rand_seed)
        self._key = derive_key(seed=rand_seed)
        #: optional lineage tracker (``record_mutation``)
        self.lineage = lineage
        self.sharding_mut = float(sharding)

    # ------------------------------------------------------------------ #
    def mutation(self, population: List, pre_training_mut: bool = False) -> List:
        """Apply one sampled mutation per agent."""
        options = [
            (self.no_mutation, self.no_mut),
            (self.architecture_mutate, self.architecture_mut),
            (self.parameter_mutation, self.parameters_mut),
            (self.activation_mutation, self.activation_mut),
            (self.rl_hyperparam_mutation, self.rl_hp_mut),
        ]
        if self.sharding_mut > 0:
            options.append((self.sharding_mutation, self.sharding_mut))
        if pre_training_mut:
            # before training starts only HP/no mutations
            options = [
                (self.no_mutation, self.no_mut),
                (self.rl_hyperparam_mutation, self.rl_hp_mut),
            ]
        fns = [f for f, _ in options]
        probs = np.array([p for _, p in options], np.float64)
        if probs.sum() == 0:
            probs = np.ones_like(probs)
        probs = probs / probs.sum()

        mutated = []
        for i, agent in enumerate(population):
            if i == 0 and not self.mutate_elite and not pre_training_mut:
                agent.mut = "None"
            else:
                fn = fns[int(self.rng.choice(len(fns), p=probs))]
                agent = fn(agent)
            if self.lineage is not None:
                self.lineage.record_mutation(agent.index, agent.mut)
            mutated.append(agent)
        return mutated

    # ------------------------------------------------------------------ #
    def no_mutation(self, agent):
        agent.mut = "None"
        return agent

    def architecture_mutate(self, agent):
        """Sample one mutation method on the policy network and apply it (or
        its analogue) to every evolvable eval network, with one shared numpy
        seed so the magnitudes agree; then rebuild the shared networks and
        re-init the optimizers. Any failure rolls the agent back to its
        networks and optimizer states before the call."""
        policy = getattr(agent, agent.registry.policy_group.eval)
        sample_net = next(iter(policy.values())) if isinstance(policy, dict) else policy
        if not hasattr(sample_net, "sample_mutation_method"):
            raise NotImplementedError(
                f"{type(agent).__name__}'s policy has no evolvable architecture in the port "
                "(the LLM modules' mutations come with a later slice)")
        method = sample_net.sample_mutation_method(self.new_layer_prob, self.rng)
        kind = (sample_net.mutation_method_kind(method)
                if hasattr(sample_net, "mutation_method_kind") else None)
        seed = int(self.rng.integers(0, 2**31 - 1))
        snapshot = _snapshot_networks(agent)
        # optimizer states are replaced, never edited, by every update: the
        # references are a full snapshot
        opt_snapshot = [(cfg.name, getattr(agent, cfg.name).opt_state)
                        for cfg in agent.registry.optimizer_configs]
        try:
            for group in agent.registry.groups:
                net = getattr(agent, group.eval)
                for sub in (net.values() if isinstance(net, dict) else [net]):
                    if not hasattr(sub, "apply_mutation"):
                        continue
                    resolved = _resolve_method(sub, method, kind)
                    if resolved is None:
                        continue  # no analogous change on this net: a deliberate no-op
                    sub.apply_mutation(resolved, rng=np.random.default_rng(seed))
            self._reinit_shared(agent)
            agent.reinit_optimizers()
            agent.mutation_hook()
            agent.mut = method
        except Exception as e:
            _restore_networks(snapshot)
            for opt_name, opt_state in opt_snapshot:
                getattr(agent, opt_name).opt_state = opt_state
            agent.mutation_hook()
            agent.mut = "None"
            warnings.warn(f"architecture mutation {method!r} rolled back (agent unchanged): "
                          f"{e!r}", RuntimeWarning, stacklevel=2)
        return agent

    def parameter_mutation(self, agent):
        """Gaussian noise (sd ``mutation_sd``) on a random ~10 % of every
        float weight of the policy network."""
        policy = getattr(agent, agent.registry.policy_group.eval)
        for net in (policy.values() if isinstance(policy, dict) else [policy]):
            seed = int(torch.randint(0, 2**62, (1,), generator=self._key))
            net.params = _gaussian_mutate(net.params, seed, self.mutation_sd)
        self._reinit_shared(agent)
        agent.mutation_hook()
        agent.mut = "param"
        return agent

    def activation_mutation(self, agent):
        """Swap the activation of every eval network for one drawn from
        ``activation_selection``; a no-op for agents without activation
        mutation (the policy-gradient ones), as in the JAX package."""
        if not getattr(agent, "supports_activation_mutation", True):
            agent.mut = "None"
            return agent
        new_act = str(self.rng.choice(self.activation_selection))
        for group in agent.registry.groups:
            net = getattr(agent, group.eval)
            for sub in (net.values() if isinstance(net, dict) else [net]):
                if hasattr(sub, "change_activation"):
                    sub.change_activation(new_act)
        self._reinit_shared(agent)
        agent.reinit_optimizers()
        agent.mutation_hook()
        agent.mut = "act"
        return agent

    def sharding_mutation(self, agent):
        raise NotImplementedError("sharding mutation is not ported yet (the distribution slice)")

    # ------------------------------------------------------------------ #
    def rl_hyperparam_mutation(self, agent):
        """Resample one scalar HP within its RLParameter space."""
        hp_config = agent.hp_config
        name = hp_config.sample(self.rng)
        if name is None:
            agent.mut = "None"
            return agent
        new_value = hp_config[name].mutate(getattr(agent, name), self.rng)
        setattr(agent, name, new_value)
        # any optimizer whose lr attribute matches gets the new rate
        for cfg in agent.registry.optimizer_configs:
            if cfg.lr == name:
                wrapper = getattr(agent, cfg.name)
                wrapper.set_lr(new_value)
                if getattr(wrapper, "lr_schedule", None) is not None:
                    # a scheduled optimizer bakes lr into its transform: the
                    # cached update callable holds the stale one
                    agent._clear_jit_cache()
        if name == "learn_step":
            # every rollout buffer's horizon (IPPO keeps one per group) is
            # the new learn_step, allocated afresh
            buffers = list(getattr(agent, "rollout_buffers", {}).values())
            if hasattr(agent, "rollout_buffer"):
                buffers.append(agent.rollout_buffer)
            for buf in buffers:
                buf.capacity = int(new_value)
                buf.state = None
        agent.mut = name
        return agent

    def _reinit_shared(self, agent) -> None:
        """Rebuild target/shared networks from their eval networks."""
        from agilerl_tpu_torch.algorithms.core.base import _net_pairs

        for group in agent.registry.groups:
            eval_net = getattr(agent, group.eval)
            for shared_name in group.shared_names():
                shared = getattr(agent, shared_name)
                for e, s in _net_pairs(eval_net if isinstance(eval_net, dict) else {"_": eval_net},
                                       shared if isinstance(shared, dict) else {"_": shared}):
                    s.config = e.config
                    s.params = tree_copy(e.params)


def _resolve_method(net, method: str, kind: Optional[str]) -> Optional[str]:
    """The exact or analogous mutation method of ``net``: networks with
    ``resolve_mutation_method`` match by scope, kind and direction; other
    evolvables by exact name, else the same direction in the same scope."""
    resolver = getattr(net, "resolve_mutation_method", None)
    if resolver is not None:
        return resolver(method, kind)
    methods = getattr(net, "mutation_methods", None)
    avail = list(methods()) if callable(methods) else None
    if avail is None:
        return method if hasattr(net, "apply_mutation") else None
    if method in avail:
        return method
    scope = method.split(".", 1)[0] if "." in method else ""
    direction = method.rsplit(".", 1)[-1].split("_", 1)[0]
    candidates = [m for m in avail
                  if (m.split(".", 1)[0] if "." in m else "") == scope
                  and m.rsplit(".", 1)[-1].split("_", 1)[0] == direction]
    return candidates[0] if candidates else None


def _snapshot_networks(agent):
    """(net, config, params containers, mutation bookkeeping) for every eval
    and shared network. Mutations replace leaves, never edit them, so new
    containers over the same leaves are a full snapshot."""
    snap = []
    names = set()
    for group in agent.registry.groups:
        names.add(group.eval)
        names.update(group.shared_names())
    for name in sorted(names):
        net = getattr(agent, name)
        for sub in (net.values() if isinstance(net, dict) else [net]):
            if hasattr(sub, "params"):
                snap.append((sub, getattr(sub, "config", None), tree_map(lambda x: x, sub.params),
                             getattr(sub, "last_mutation_attr", None),
                             getattr(sub, "last_mutation", None)))
    return snap


def _restore_networks(snapshot) -> None:
    for sub, config, params, lma, lm in snapshot:
        if config is not None:
            sub.config = config
        sub.params = params
        if hasattr(sub, "last_mutation_attr"):
            sub.last_mutation_attr = lma
        if hasattr(sub, "last_mutation"):
            sub.last_mutation = lm


@torch.no_grad()
def _gaussian_mutate(params: Any, seed: int, sd: float, frac: float = 0.1) -> Any:
    """New leaves: N(0, sd) noise added to a random ~``frac`` of the entries
    of every float leaf, drawn from a generator seeded with ``seed`` on each
    leaf's device."""
    gens = {}

    def mutate_leaf(leaf):
        if leaf.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            return leaf
        gen = gens.get(leaf.device)
        if gen is None:
            gen = gens[leaf.device] = torch.Generator(device=leaf.device).manual_seed(seed)
        mask = torch.rand(leaf.shape, generator=gen, device=leaf.device) < frac
        noise = torch.randn(leaf.shape, generator=gen, device=leaf.device) * sd
        return leaf + torch.where(mask, noise, torch.zeros_like(noise)).to(leaf.dtype)

    return tree_map(mutate_leaf, params)
