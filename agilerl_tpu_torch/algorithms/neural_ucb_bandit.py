"""NeuralUCB contextual bandit: the port of
``agilerl_tpu/algorithms/neural_ucb_bandit.py``.

The confidence width of arm a is ``sqrt(lamb * nu * sum(g_a^2 / U))``, where
``g_a`` is the gradient of the value network's output at arm a's context
and ``U`` the diagonal approximation of the design matrix, a tree of tensors
shaped like the parameters (``lamb`` at the start). The arm with the largest
value + width is pulled, and ``U`` grows by the pulled arm's squared
gradient. The per-arm gradients come from ``torch.func.vmap`` over
``torch.func.grad_and_value`` of the network's pure ``apply``, on the
device; ``U`` takes the pulled arm's row by ``index_select`` on the arm
tensor, so a pull reads the device once, for the arm that ``get_action``
returns (as the JAX loop reads it); a host env's context is uploaded first
(on the card, a second synchronising copy). ``learn`` regresses the network on the
observed rewards with an L2 pull toward the anchor ``theta_0`` (the
parameters when ``U`` was last reset): one Adam step, one host read (the
loss). An architecture mutation resets ``theta_0`` and ``U``
(``_reinit_bandit_grads``, the registered mutation hook); checkpoints carry
both as host numpy (``bandit_state``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from agilerl_tpu_torch.algorithms.core.base import RLAlgorithm
from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper, grad_step
from agilerl_tpu_torch.algorithms.core.registry import (
    HyperparameterConfig,
    NetworkGroup,
    OptimizerConfig,
    RLParameter,
)
from agilerl_tpu_torch.networks.base import EvolvableNetwork
from agilerl_tpu_torch.utils.spaces import as_tensor
from agilerl_tpu_torch.utils.tree import (
    tree_copy,
    tree_from_numpy,
    tree_leaves,
    tree_map,
    tree_to_numpy,
)


def default_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr=RLParameter(min=1e-4, max=1e-2, dtype=float),
        batch_size=RLParameter(min=8, max=512, dtype=int),
        learn_step=RLParameter(min=1, max=16, dtype=int),
    )


class NeuralUCB(RLAlgorithm):
    def __init__(
        self,
        observation_space,
        action_space,
        index: int = 0,
        hp_config: Optional[HyperparameterConfig] = None,
        net_config: Optional[Dict[str, Any]] = None,
        gamma: float = 1.0,
        lamb: float = 1.0,
        reg: float = 0.000625,
        batch_size: int = 64,
        lr: float = 1e-3,
        learn_step: int = 2,
        device=None,
        **kwargs,
    ):
        super().__init__(observation_space, action_space, index=index,
                         hp_config=hp_config or default_hp_config(), device=device, **kwargs)
        self.gamma = float(gamma)
        self.lamb = float(lamb)
        self.reg = float(reg)
        self.batch_size = int(batch_size)
        self.lr = float(lr)
        self.learn_step = int(learn_step)
        self.net_config = dict(net_config or {})

        self.actor = EvolvableNetwork(observation_space, num_outputs=1, key=self.next_key(),
                                      device=self.dev, **self.net_config)
        self.optimizer = OptimizerWrapper(optimizer="adam", lr=self.lr)
        self.register_network_group(NetworkGroup(eval="actor", policy=True))
        self.register_optimizer(OptimizerConfig(name="optimizer", networks=["actor"], lr="lr"))
        self.finalize_registry()
        self._reinit_bandit_grads()
        self.register_mutation_hook("_reinit_bandit_grads")

    def _reinit_bandit_grads(self) -> None:
        """Reset the anchor ``theta_0`` to the current parameters and the
        diagonal design matrix ``U`` to ``lamb`` (after any architecture
        change)."""
        self.theta_0 = tree_copy(self.actor.params)
        self.U = tree_map(lambda p: torch.full_like(p, self.lamb), self.actor.params)

    @property
    def init_dict(self) -> Dict[str, Any]:
        return {
            "observation_space": self.observation_space,
            "action_space": self.action_space,
            "index": self.index,
            "net_config": self.net_config,
            "gamma": self.gamma,
            "lamb": self.lamb,
            "reg": self.reg,
            "batch_size": self.batch_size,
            "lr": self.lr,
            "learn_step": self.learn_step,
            "device": self.dev,
        }

    def _on_clone(self, parent) -> None:
        self.theta_0 = tree_copy(parent.theta_0)
        self.U = tree_copy(parent.U)

    def checkpoint_dict(self) -> Dict[str, Any]:
        ckpt = super().checkpoint_dict()
        # the anchor and the design matrix are the bandit's belief state
        ckpt["bandit_state"] = {"theta_0": tree_to_numpy(self.theta_0),
                                "U": tree_to_numpy(self.U)}
        return ckpt

    def _restore(self, ckpt: Dict[str, Any]) -> None:
        super()._restore(ckpt)
        if "bandit_state" in ckpt:
            self.theta_0 = tree_from_numpy(ckpt["bandit_state"]["theta_0"], self.dev)
            self.U = tree_from_numpy(ckpt["bandit_state"]["U"], self.dev)

    # ------------------------------------------------------------------ #
    def _arm_stats(self, context: torch.Tensor):
        """(values [arms], sum over leaves of g_a^2 / U [arms], per-arm
        gradients) at each arm's context."""
        config = self.actor.config

        def value(params, x):
            return EvolvableNetwork.apply(config, params, x[None])[0, 0]

        grads, values = torch.func.vmap(torch.func.grad_and_value(value),
                                        in_dims=(None, 0))(self.actor.params, context)
        sq = sum((g * g / u).reshape(g.shape[0], -1).sum(-1)
                 for g, u in zip(tree_leaves(grads), tree_leaves(self.U)))
        return values, sq, grads

    def _pull(self, scores: torch.Tensor, grads) -> np.ndarray:
        """The arm of the largest score; ``U`` grows by its squared gradient
        (on the device); one host read, the arm."""
        arm = torch.argmax(scores)
        self.U = tree_map(lambda u, g: u + torch.index_select(g, 0, arm.reshape(1))[0] ** 2,
                          self.U, grads)
        return arm.cpu().numpy()

    @torch.no_grad()
    def _greedy(self, context: torch.Tensor) -> np.ndarray:
        values = EvolvableNetwork.apply(self.actor.config, self.actor.params, context)[..., 0]
        return torch.argmax(values).cpu().numpy()

    def get_action(self, context: Any, training: bool = True, **kw) -> np.ndarray:
        """context: [num_arms, context_dim] features; returns the chosen arm
        (value only, no width and no ``U`` update, when not ``training``)."""
        context = self.preprocess_observation(context)
        if not training:
            return self._greedy(context)
        values, sq, grads = self._arm_stats(context)
        width = torch.sqrt(self.lamb * self.gamma * sq)
        return self._pull(values + width, grads)

    # ------------------------------------------------------------------ #
    def learn(self, experiences: Dict[str, Any]) -> float:
        """One Adam step on the mean squared reward error plus ``reg`` times
        the squared distance to ``theta_0``; returns the loss (one read)."""
        config = self.actor.config
        obs = self.preprocess_observation(experiences["obs"])
        reward = as_tensor(experiences["reward"], self.dev).float()
        theta_0 = self.theta_0

        def loss_of(p):
            pred = EvolvableNetwork.apply(config, p, obs)[..., 0]
            mse = torch.mean(torch.square(pred - reward))
            l2 = sum(torch.sum(torch.square(a - b))
                     for a, b in zip(tree_leaves(p), tree_leaves(theta_0)))
            return mse + self.reg * l2, None

        with torch.enable_grad():
            params, opt_state, loss, _ = grad_step(loss_of, self.actor.params,
                                                   self.optimizer.tx, self.optimizer.opt_state)
        self.actor.params = params
        self.optimizer.opt_state = opt_state
        return float(loss)

    def test(self, env, swap_channels: bool = False, max_steps: Optional[int] = 100,
             loop: int = 1) -> float:
        """Mean reward per greedy pull over ``loop`` runs of ``max_steps``
        pulls of ``env`` (one host read per pull); appended to ``fitness``."""
        steps = max_steps or 100
        rewards = []
        for _ in range(loop):
            context = env.reset()
            total = 0.0
            for _ in range(steps):
                arm = self.get_action(context, training=False)
                context, reward = env.step(arm)
                total += float(np.asarray(reward).squeeze())
            rewards.append(total / steps)
        fitness = float(np.mean(rewards))
        self.fitness.append(fitness)
        return fitness
