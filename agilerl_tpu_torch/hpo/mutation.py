"""Mutations engine: the port of ``agilerl_tpu/hpo/mutation.py``, its
no-mutation and RL-hyperparameter paths.

The option list and the draw that picks from it are the JAX package's
(five entries, plus sharding when its probability is set; one
``rng.choice`` per agent), so the same numpy seed gives the same picks and
the same hyperparameter values. The architecture, parameter and sharding
branches need the evolvable modules, the Gaussian parameter noise and the
sharding plans, which are not ported yet: they raise ``NotImplementedError``
when drawn. LLM training forbids all three, and the activation branch is
already a no-op for agents that do not support it (GRPO among them), as in
the JAX package; for other agents it raises.
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from agilerl_tpu_torch.utils.rng import derive_key, derive_rng


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
        # new_layer_prob, mutation_sd, activation_selection and
        # sharding_plans shape the branches that are not ported yet
        self.no_mut = float(no_mutation)
        self.architecture_mut = float(architecture)
        self.parameters_mut = float(parameters)
        self.activation_mut = float(activation)
        self.rl_hp_mut = float(rl_hp)
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
        raise NotImplementedError("architecture mutation needs the evolvable modules, "
                                  "which are not ported yet")

    def parameter_mutation(self, agent):
        raise NotImplementedError("parameter mutation is not ported yet")

    def activation_mutation(self, agent):
        """A no-op for agents without activation mutation (policy-gradient
        LLM agents), as in the JAX package."""
        if not getattr(agent, "supports_activation_mutation", True):
            agent.mut = "None"
            return agent
        raise NotImplementedError("activation mutation needs the evolvable modules, "
                                  "which are not ported yet")

    def sharding_mutation(self, agent):
        raise NotImplementedError("sharding mutation is not ported yet")

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
        agent.mut = name
        return agent
