"""Classic-control envs on the device: the port of ``agilerl_tpu/envs/classic.py``
(CartPole-v1, Pendulum-v1, MountainCar-v0, MountainCarContinuous-v0 and the
rendered VisualCartPole), batched over ``[N]`` tensors with gymnasium's
dynamics and constants, and ``make`` / ``REGISTRY``."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from agilerl_tpu_torch.envs.core import TorchEnv
from agilerl_tpu_torch.utils.spaces import Box, Discrete


def _uniform(gen: torch.Generator, shape, low: float, high: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return low + u * (high - low)


def _flags(n: int, device, value: bool = False) -> torch.Tensor:
    return torch.full((n,), value, dtype=torch.bool, device=device)


def _scalar_action(action: torch.Tensor) -> torch.Tensor:
    """[N] from a [N] or [N, 1] Box action."""
    return action[:, 0] if action.dim() > 1 else action


class CartPoleState(NamedTuple):
    x: torch.Tensor
    x_dot: torch.Tensor
    theta: torch.Tensor
    theta_dot: torch.Tensor


class CartPole(TorchEnv):
    """CartPole-v1 dynamics (Euler integration, gymnasium's constants)."""

    max_episode_steps = 500

    def __init__(self):
        high = np.array([4.8, np.inf, 0.418, np.inf], dtype=np.float32)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.action_space = Discrete(2)

    def reset_fn(self, n, gen):
        vals = _uniform(gen, (n, 4), -0.05, 0.05)
        return CartPoleState(vals[:, 0], vals[:, 1], vals[:, 2], vals[:, 3]), vals

    def step_fn(self, state, action, gen):
        gravity, masscart, masspole = 9.8, 1.0, 0.1
        total_mass = masscart + masspole
        length = 0.5
        polemass_length = masspole * length
        force_mag, dt = 10.0, 0.02

        force = torch.where(action == 1, force_mag, -force_mag).float()
        costh, sinth = torch.cos(state.theta), torch.sin(state.theta)
        temp = (force + polemass_length * state.theta_dot ** 2 * sinth) / total_mass
        theta_acc = (gravity * sinth - costh * temp) / (
            length * (4.0 / 3.0 - masspole * costh ** 2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * costh / total_mass

        x = state.x + dt * state.x_dot
        x_dot = state.x_dot + dt * x_acc
        theta = state.theta + dt * state.theta_dot
        theta_dot = state.theta_dot + dt * theta_acc
        obs = torch.stack([x, x_dot, theta, theta_dot], dim=-1)
        terminated = torch.logical_or(torch.abs(x) > 2.4, torch.abs(theta) > 12 * math.pi / 180)
        reward = torch.ones_like(x)
        return (CartPoleState(x, x_dot, theta, theta_dot), obs, reward, terminated,
                _flags(x.shape[0], x.device))


class PendulumState(NamedTuple):
    theta: torch.Tensor
    theta_dot: torch.Tensor


class Pendulum(TorchEnv):
    """Pendulum-v1 dynamics."""

    max_episode_steps = 200

    def __init__(self):
        high = np.array([1.0, 1.0, 8.0], dtype=np.float32)
        self.observation_space = Box(-high, high, dtype=np.float32)
        self.action_space = Box(-2.0, 2.0, (1,), dtype=np.float32)

    @staticmethod
    def _obs(s: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(s.theta), torch.sin(s.theta), s.theta_dot], dim=-1)

    def reset_fn(self, n, gen):
        theta = _uniform(gen, (n,), -math.pi, math.pi)
        theta_dot = _uniform(gen, (n,), -1.0, 1.0)
        state = PendulumState(theta, theta_dot)
        return state, self._obs(state)

    def step_fn(self, state, action, gen):
        g, m, l, dt = 10.0, 1.0, 1.0, 0.05
        u = torch.clamp(_scalar_action(action).float(), -2.0, 2.0)
        th, thdot = state.theta, state.theta_dot
        norm_th = ((th + math.pi) % (2 * math.pi)) - math.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        newthdot = thdot + (3 * g / (2 * l) * torch.sin(th) + 3.0 / (m * l ** 2) * u) * dt
        newthdot = torch.clamp(newthdot, -8.0, 8.0)
        newth = th + newthdot * dt
        new = PendulumState(newth, newthdot)
        n = th.shape[0]
        return new, self._obs(new), -cost, _flags(n, th.device), _flags(n, th.device)


class MountainCarState(NamedTuple):
    position: torch.Tensor
    velocity: torch.Tensor


def _mountain_reset(n, gen):
    pos = _uniform(gen, (n,), -0.6, -0.4)
    vel = torch.zeros_like(pos)
    return MountainCarState(pos, vel), torch.stack([pos, vel], dim=-1)


def _mountain_move(state: MountainCarState, push: torch.Tensor):
    velocity = state.velocity + push + torch.cos(3 * state.position) * (-0.0025)
    velocity = torch.clamp(velocity, -0.07, 0.07)
    position = torch.clamp(state.position + velocity, -1.2, 0.6)
    velocity = torch.where((position <= -1.2) & (velocity < 0), torch.zeros_like(velocity),
                           velocity)
    return position, velocity


class MountainCar(TorchEnv):
    """MountainCar-v0 dynamics."""

    max_episode_steps = 200

    def __init__(self):
        self.observation_space = Box(np.array([-1.2, -0.07], np.float32),
                                     np.array([0.6, 0.07], np.float32))
        self.action_space = Discrete(3)

    def reset_fn(self, n, gen):
        return _mountain_reset(n, gen)

    def step_fn(self, state, action, gen):
        position, velocity = _mountain_move(state, (action - 1).float() * 0.001)
        terminated = (position >= 0.5) & (velocity >= 0)
        return (MountainCarState(position, velocity), torch.stack([position, velocity], dim=-1),
                torch.full_like(position, -1.0), terminated, _flags(position.shape[0],
                                                                     position.device))


class MountainCarContinuous(TorchEnv):
    """MountainCarContinuous-v0 dynamics (power-scaled Box(1) action, +100
    goal bonus minus the action cost)."""

    max_episode_steps = 999

    def __init__(self):
        self.observation_space = Box(np.array([-1.2, -0.07], np.float32),
                                     np.array([0.6, 0.07], np.float32))
        self.action_space = Box(-1.0, 1.0, (1,), dtype=np.float32)

    def reset_fn(self, n, gen):
        return _mountain_reset(n, gen)

    def step_fn(self, state, action, gen):
        force = torch.clamp(_scalar_action(action).float(), -1.0, 1.0)
        position, velocity = _mountain_move(state, force * 0.0015)
        terminated = (position >= 0.45) & (velocity >= 0)
        reward = torch.where(terminated, 100.0, 0.0) - 0.1 * force ** 2
        return (MountainCarState(position, velocity), torch.stack([position, velocity], dim=-1),
                reward, terminated, _flags(position.shape[0], position.device))


class VisualCartPole(CartPole):
    """CartPole with an image observation [N, H, W, 1] rendered on the device."""

    def __init__(self, size: int = 24):
        super().__init__()
        self.size = size
        self.observation_space = Box(0.0, 1.0, (size, size, 1), np.float32)

    def _render(self, state: CartPoleState) -> torch.Tensor:
        s = self.size
        dev = state.x.device
        xs = torch.arange(s, dtype=torch.float32, device=dev)[None, None, :]
        ys = torch.arange(s, dtype=torch.float32, device=dev)[None, :, None]
        cart_col = ((state.x + 2.4) / 4.8 * (s - 1))[:, None, None]
        cart_row = float(s - 3)
        cart = torch.exp(-((xs - cart_col) ** 2) / 4.0) * torch.exp(-((ys - cart_row) ** 2) / 2.0)
        theta = state.theta[:, None, None]
        tip_col = cart_col + torch.sin(theta) * s * 0.4
        tip_row = cart_row - torch.cos(theta) * s * 0.4
        pole = torch.exp(-((xs - tip_col) ** 2) / 4.0) * torch.exp(-((ys - tip_row) ** 2) / 4.0)
        return torch.clamp(cart + pole, 0.0, 1.0)[..., None]

    def reset_fn(self, n, gen):
        state, _ = super().reset_fn(n, gen)
        return state, self._render(state)

    def step_fn(self, state, action, gen):
        new, _, reward, terminated, truncated = super().step_fn(state, action, gen)
        return new, self._render(new), reward, terminated, truncated


REGISTRY = {
    "CartPole-v1": CartPole,
    "Pendulum-v1": Pendulum,
    "MountainCar-v0": MountainCar,
    "MountainCarContinuous-v0": MountainCarContinuous,
    "VisualCartPole-v0": VisualCartPole,
}


def make(env_id: str) -> TorchEnv:
    if env_id not in REGISTRY:
        raise KeyError(f"Unknown device env {env_id!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[env_id]()
