"""Optimizer wrapper: the port of ``agilerl_tpu/algorithms/core/optimizer.py``.

The JAX package builds its optimizers from optax. The port keeps optax's
functional shape (a transform is an ``init``/``update`` pair over parameter
trees, chained) and its arithmetic, so the same gradients give the same
steps:

- ``adamw`` is optax's: bias-corrected Adam, then ``+ weight_decay * param``
  with optax's default weight decay 1e-4 (``torch.optim.AdamW`` defaults to
  1e-2), then ``* -lr``;
- the clip is ``optax.clip_by_global_norm``: ``g * max_norm / ||g||`` only when
  ``||g|| >= max_norm`` (no ``+ 1e-6`` as in ``clip_grad_norm_``), and it runs
  before AdamW;
- the warmup-cosine schedule starts from 0 (``optax.warmup_cosine_decay_schedule``
  with ``init_value=0``), so the first step has learning rate 0;
- ``sgd`` and ``rmsprop`` are optax's at its defaults (``rmsprop``'s eps
  inside the square root, as optax has it; ``torch.optim.RMSprop`` adds it
  outside), momentum applied after the learning rate in ``rmsprop`` as in
  optax;
- without a schedule the learning rate lives in the state
  (``optax.inject_hyperparams``), so ``set_lr`` edits the state in place and
  rebuilds nothing.

Updates are functional: new tensors, under ``torch.no_grad``. Adam, SGD's
momentum, RMSProp's moments, the
learning-rate scale and the parameter update run as multi-tensor
(``torch._foreach_*``) ops over all leaves, each step of the formula one
launch, as optax runs them leaf by leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

Tree = Any
Schedule = Callable[[int], float]


class Transform(NamedTuple):
    """optax.GradientTransformation: ``update(updates, state, params)``
    returns ``(updates, state)``."""

    init: Callable[[Tree], Any]
    update: Callable[[Tree, Any, Optional[Tree]], Tuple[Tree, Any]]


class AdamState(NamedTuple):
    count: int
    mu: Tree
    nu: Tree


class ScheduleState(NamedTuple):
    count: int


class TraceState(NamedTuple):
    trace: Tree


class RmsState(NamedTuple):
    nu: Tree


class StddevState(NamedTuple):
    mu: Tree
    nu: Tree


class InjectState(NamedTuple):
    """optax.InjectHyperparamsState: hyperparameters held in the state."""

    count: int
    hyperparams: Dict[str, Any]
    inner_state: Any


def _empty(_params):
    return ()


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return Transform(init, update)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(x.float() * x.float()) for x in tree_leaves(tree)))


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(updates, state, params=None):
        # selected on the device: no host sync per step
        g_norm = global_norm(updates)
        keep = g_norm < max_norm
        return tree_map(lambda t: torch.where(keep, t, (t / g_norm.to(t.dtype)) * max_norm),
                        updates), state

    return Transform(_empty, update)


def clip_by_member_global_norm(max_norm: float) -> Transform:
    """``clip_by_global_norm`` over a population's stacked leaves ``[P, ...]``:
    one norm per member, over every dimension but the first, as a vmapped
    ``optax.clip_by_global_norm`` takes it (``clip_by_global_norm`` on the
    stacked tree would take one norm for the whole population)."""

    def update(updates, state, params=None):
        leaves = tree_leaves(updates)
        sq = sum(torch.sum(x.float().square().reshape(x.shape[0], -1), dim=1) for x in leaves)
        g_norm = torch.sqrt(sq)  # [P]

        def clip(t):
            n = g_norm.to(t.dtype).view((-1,) + (1,) * (t.dim() - 1))
            return torch.where(n < max_norm, t, (t / n) * max_norm)

        return tree_map(clip, updates), state

    return Transform(_empty, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> Transform:
    def init(params):
        return AdamState(0, tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        # one multi-tensor launch per step of the formula over every leaf
        g, m, v = tree_leaves(updates), tree_leaves(state.mu), tree_leaves(state.nu)
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(m, b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul(v, b2))
        count = state.count + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_add(
            torch._foreach_div(nu, c2), eps_root)), eps)
        out = torch._foreach_div(torch._foreach_div(mu, c1), den)
        return (_like(updates, out),
                AdamState(count, _like(updates, mu), _like(updates, nu)))

    return Transform(init, update)


def identity() -> Transform:
    return Transform(_empty, lambda updates, state, params=None: (updates, state))


def trace(decay: float, nesterov: bool = False) -> Transform:
    """optax.trace: momentum ``t = g + decay * t``; the update is ``t``, or
    ``g + decay * t`` with Nesterov."""

    def init(params):
        return TraceState(tree_map(torch.zeros_like, params))

    def update(updates, state, params=None):
        g = tree_leaves(updates)
        new = torch._foreach_add(g, torch._foreach_mul(tree_leaves(state.trace), decay))
        out = torch._foreach_add(g, torch._foreach_mul(new, decay)) if nesterov else new
        return _like(updates, out), TraceState(_like(updates, new))

    return Transform(init, update)


def _moment(g, m, decay: float, order: int):
    """optax's moment update ``(1 - decay) * g**order + decay * m``."""
    gp = g if order == 1 else torch._foreach_mul(g, g)
    return torch._foreach_add(torch._foreach_mul(gp, 1 - decay), torch._foreach_mul(m, decay))


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0) -> Transform:
    """optax.scale_by_rms (eps inside the square root, no bias correction)."""

    def init(params):
        return RmsState(tree_map(lambda p: torch.full_like(p, initial_scale), params))

    def update(updates, state, params=None):
        g = tree_leaves(updates)
        nu = _moment(g, tree_leaves(state.nu), decay, 2)
        out = torch._foreach_mul(g, torch._foreach_rsqrt(torch._foreach_add(nu, eps)))
        return _like(updates, out), RmsState(_like(updates, nu))

    return Transform(init, update)


def scale_by_stddev(decay: float = 0.9, eps: float = 1e-8,
                    initial_scale: float = 0.0) -> Transform:
    """optax.scale_by_stddev: the centered form, ``g / sqrt(nu - mu**2 + eps)``."""

    def init(params):
        return StddevState(tree_map(torch.zeros_like, params),
                           tree_map(lambda p: torch.full_like(p, initial_scale), params))

    def update(updates, state, params=None):
        g = tree_leaves(updates)
        mu = _moment(g, tree_leaves(state.mu), decay, 1)
        nu = _moment(g, tree_leaves(state.nu), decay, 2)
        var = torch._foreach_add(torch._foreach_sub(nu, torch._foreach_mul(mu, mu)), eps)
        out = torch._foreach_mul(g, torch._foreach_rsqrt(var))
        return _like(updates, out), StddevState(_like(updates, mu), _like(updates, nu))

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(updates, state, params=None):
        return tree_map(lambda g, p: g + weight_decay * p, updates, params), state

    return Transform(_empty, update)


def scale_by_learning_rate(learning_rate: Union[float, Schedule]) -> Transform:
    if callable(learning_rate):
        def update(updates, state, params=None):
            step = -learning_rate(state.count)
            return tree_map(lambda g: g * step, updates), ScheduleState(state.count + 1)

        return Transform(lambda params: ScheduleState(0), update)

    def update_const(updates, state, params=None):
        return _like(updates, torch._foreach_mul(tree_leaves(updates), -learning_rate)), state

    return Transform(_empty, update_const)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Transform:
    return chain(scale_by_adam(b1, b2, eps, eps_root), scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4) -> Transform:
    return chain(scale_by_adam(b1, b2, eps, eps_root), add_decayed_weights(weight_decay),
                 scale_by_learning_rate(learning_rate))


def sgd(learning_rate, momentum: Optional[float] = None,
        nesterov: bool = False) -> Transform:
    """optax.sgd: optional (Nesterov) momentum, then ``* -lr``."""
    return chain(trace(momentum, nesterov) if momentum is not None else identity(),
                 scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate, decay: float = 0.9, eps: float = 1e-8, initial_scale: float = 0.0,
            centered: bool = False, momentum: Optional[float] = None,
            nesterov: bool = False) -> Transform:
    """optax.rmsprop at its defaults (eps inside the square root, no bias
    correction): scale by the RMS (or, centered, the standard deviation) of
    the gradients, ``* -lr``, then optional momentum."""
    scale = scale_by_stddev if centered else scale_by_rms
    return chain(scale(decay, eps, initial_scale), scale_by_learning_rate(learning_rate),
                 trace(momentum, nesterov) if momentum is not None else identity())


def inject_hyperparams(factory: Callable[..., Transform]) -> Callable[..., Transform]:
    """Hold the factory's numeric hyperparameters in the state; each update
    rebuilds the inner transform from them (as optax does)."""

    def build(**hps) -> Transform:
        def init(params):
            return InjectState(0, dict(hps), factory(**hps).init(params))

        def update(updates, state, params=None):
            updates, inner = factory(**state.hyperparams).update(
                updates, state.inner_state, params)
            return updates, InjectState(state.count + 1, state.hyperparams, inner)

        return Transform(init, update)

    return build


def apply_updates(params: Tree, updates: Tree) -> Tree:
    new = torch._foreach_add(tree_leaves(params), tree_leaves(updates))
    return tree_map(lambda p, n: n.to(p.dtype), params, _like(params, new))


def _like(tree: Tree, leaves) -> Tree:
    """``leaves`` (in ``tree_leaves`` order) in the structure of ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _as_param(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient with its parameter's placements (a partial sum is
    reduced there)."""
    placements = getattr(x, "placements", None)
    if placements is not None and tuple(g.placements) != tuple(placements):
        return g.redistribute(x.device_mesh, placements)
    return g


def grad_step(loss_of: Callable[[Tree], Tuple[torch.Tensor, Any]], params: Tree,
              tx: Transform, opt_state: Any,
              reduce_grads: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
              ) -> Tuple[Tree, Any, torch.Tensor, Any]:
    """Differentiate ``loss_of(params) -> (loss, aux)`` into every leaf of
    ``params`` (a leaf off the graph gets a zero gradient) and take one step
    of ``tx``. Returns (params, opt_state, loss, aux), all off the graph.
    ``reduce_grads`` maps each gradient, in leaf order, before the step (a
    sum over the ranks of a sequence-parallel axis)."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, aux = loss_of(p)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else _as_param(g, x)
             for x, g in zip(leaves, grads)]
    if reduce_grads is not None:
        grads = [reduce_grads(g) for g in grads]
    it = iter(grads)
    grads = tree_map(lambda _: next(it), p)
    with torch.no_grad():
        p = tree_map(torch.Tensor.detach, p)
        updates, opt_state = tx.update(grads, opt_state, p)
        params = apply_updates(p, updates)
    return params, opt_state, loss.detach(), tree_map(_detached, aux)


def _detached(x: Any) -> Any:
    return x.detach() if isinstance(x, torch.Tensor) else x


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """optax.warmup_cosine_decay_schedule (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine down to
    ``end_value`` at ``decay_steps`` (which includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError("the cosine part of the schedule needs positive decay steps")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / cos_steps)) + alpha
        return peak_value * decayed

    return schedule


OPTIMIZERS: Dict[str, Callable[..., Transform]] = {
    "adam": adam,
    "adamw": adamw,
    "sgd": sgd,
    "rmsprop": rmsprop,
}


@dataclasses.dataclass
class CosineLRScheduleConfig:
    """Cosine schedule with warmup, consumed by the LLM algorithms."""

    num_epochs: int = 10
    warmup_proportion: float = 0.05
    min_lr_fraction: float = 0.1
    steps_per_epoch: int = 100


class OptimizerWrapper:
    """Holds a transform and its state over one parameter tree.

    ``params`` may be a dict {network_attr_name: net.params} so one optimizer
    can span several networks."""

    def __init__(
        self,
        optimizer: str = "adam",
        lr: float = 1e-3,
        max_grad_norm: Optional[float] = None,
        lr_schedule: Optional[CosineLRScheduleConfig] = None,
        **kwargs,
    ):
        if optimizer not in OPTIMIZERS:
            raise NotImplementedError(
                f"optimizer {optimizer!r} is not ported yet; available: {sorted(OPTIMIZERS)}")
        self.optimizer_name = optimizer
        self.lr = float(lr)
        self.max_grad_norm = max_grad_norm
        self.lr_schedule = lr_schedule
        self.kwargs = kwargs
        self.tx = self._build()
        self.opt_state = None

    def _build(self) -> Transform:
        if self.lr_schedule is not None:
            total = self.lr_schedule.num_epochs * self.lr_schedule.steps_per_epoch
            warmup = max(int(total * self.lr_schedule.warmup_proportion), 1)
            schedule = warmup_cosine_decay_schedule(
                init_value=0.0, peak_value=self.lr, warmup_steps=warmup,
                decay_steps=total, end_value=self.lr * self.lr_schedule.min_lr_fraction)
            base = OPTIMIZERS[self.optimizer_name](learning_rate=schedule, **self.kwargs)
        else:
            base = inject_hyperparams(OPTIMIZERS[self.optimizer_name])(
                learning_rate=self.lr, **self.kwargs)
        if self.max_grad_norm is not None:
            return chain(clip_by_global_norm(self.max_grad_norm), base)
        return base

    def init(self, params: Tree) -> None:
        self.opt_state = self.tx.init(params)

    def reinit(self, params: Tree) -> None:
        """Rebuild the state for new parameter shapes."""
        self.opt_state = self.tx.init(params)

    def set_lr(self, lr: float) -> None:
        """Edit lr in place in the state (no rebuild of the moments)."""
        self.lr = float(lr)
        if self.opt_state is not None:
            self.opt_state = _set_injected_lr(self.opt_state, self.lr)
        self.tx = self._build()

    @torch.no_grad()
    def state_dict(self) -> Any:
        """The optimizer state tree (what the checkpoints carry)."""
        return self.opt_state

    def load_state_dict(self, state: Any) -> None:
        self.opt_state = state

    def update(self, grads: Tree, params: Tree) -> Tree:
        updates, self.opt_state = self.tx.update(grads, self.opt_state, params)
        return apply_updates(params, updates)


def _set_injected_lr(opt_state: Any, lr: float) -> Any:
    """Find the InjectState and overwrite its learning_rate."""

    def visit(state):
        if isinstance(state, InjectState):
            return state._replace(hyperparams=dict(state.hyperparams, learning_rate=lr))
        if isinstance(state, dict):
            return {k: visit(v) for k, v in state.items()}
        if isinstance(state, tuple) and not hasattr(state, "_fields"):
            return tuple(visit(s) for s in state)
        return state

    return visit(opt_state)
