"""Replay buffers on the device: the port of
``agilerl_tpu/components/replay_buffer.py`` (``ReplayBuffer``,
``MultiStepReplayBuffer``, ``PrioritizedReplayBuffer`` and the staging path
``stage`` / ``flush`` / ``drain_staging``).

Storage is a dict of ``[capacity, ...]`` tensors on the buffer's device,
allocated at the first ``add`` with the dtypes ``jnp.asarray`` gives the JAX
package (float64 -> float32, int64 -> int32). The write cursor and the fill
are host integers (``BufferState.pos`` / ``.size``): every row count is known
on the host when it is written, so ``len()`` and ``is_full`` read them and
never sync the device. A write is one ``index_copy_`` per leaf at
``(pos + arange(n)) % capacity``; a chunk longer than the ring is written in
capacity-sized pieces, so no write has duplicate indices.

Staging: ``stage()`` queues transitions and ``flush()`` writes all of them as
one add. Host values (numpy, Python) are copied onto the CPU when staged, and
the chunk goes to the device in one non-blocking copy per leaf at the flush;
transitions that already are tensors (a ``TorchVecEnv``'s) are held as they
are and concatenated on their device. ``MultiStepReplayBuffer`` folds its
n-step windows over the whole staged chunk at once with the same ops, in
the same order, as one window at a time (its per-step ``add`` is that fold's
one-window case), so the rows are bit-equal either way.

The PER buffer samples by inverse CDF on a dense cumulative sum of the
priorities (``_per_sample``), as the JAX package does (the sum in f64, so
the card and the CPU pick the same rows); its uniform draws come first, as
an argument, so a caller can replay another stream's draws.
Sampling draws come from ``torch.Generator``s: the buffer's own (``seed``),
or one the caller passes.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from agilerl_tpu_torch.modules.base import split_key
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.utils.rng import derive_key
from agilerl_tpu_torch.utils.spaces import as_tensor
from agilerl_tpu_torch.utils.tree import tree_from_numpy, tree_leaves, tree_map, tree_to_numpy

PyTree = Any

# the dtypes jnp.asarray stores (64-bit types off)
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}


class BufferState(NamedTuple):
    """The ring: device storage and the host cursors."""

    storage: PyTree  # each leaf [capacity, ...] on the buffer's device
    pos: int  # write cursor
    size: int  # current fill


def _zeros_like_rows(rows: PyTree, capacity: int, device: torch.device) -> PyTree:
    """``[capacity, ...]`` zeros shaped like one row of ``rows``."""
    return tree_map(lambda x: torch.zeros((capacity,) + tuple(x.shape[1:]),
                                          dtype=_CANONICAL.get(x.dtype, x.dtype), device=device),
                    rows)


def _write_index(pos: int, n: int, capacity: int, device: torch.device) -> torch.Tensor:
    return (torch.arange(n, device=device) + pos) % capacity


def _add(state: BufferState, rows: PyTree) -> BufferState:
    """Write ``rows`` (``[n, ...]`` leaves, ``n <= capacity``) at the cursor."""
    leaves = tree_leaves(state.storage)
    capacity, device = leaves[0].shape[0], leaves[0].device
    n = _num_rows(rows)
    idx = _write_index(state.pos, n, capacity, device)
    tree_map(lambda buf, x: buf.index_copy_(
        0, idx, x.to(device=device, dtype=buf.dtype, non_blocking=True)), state.storage, rows)
    return BufferState(state.storage, (state.pos + n) % capacity, min(state.size + n, capacity))


def _gather(state: BufferState, idx: torch.Tensor) -> PyTree:
    return tree_map(lambda buf: buf[idx], state.storage)


def draw_indices(gen: torch.Generator, batch_size: int, size: int) -> torch.Tensor:
    """Uniform ring indices in ``[0, max(size, 1))`` on ``gen``'s device."""
    return torch.randint(0, max(size, 1), (batch_size,), generator=gen, device=gen.device)


def _num_rows(rows: PyTree) -> int:
    return int(tree_leaves(rows)[0].shape[0])


def _as_rows(transition: PyTree, batched: bool) -> PyTree:
    """A transition as ``[N, ...]`` tensors. Tensors are kept on their
    device; anything else is copied through numpy onto the CPU (staged rows
    outlive the step that made them, and host vector envs may reuse their
    arrays)."""

    def leaf(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, copy=True))
        return t if batched else t[None]

    return tree_map(leaf, transition)


def _concat(chunks: list) -> PyTree:
    if len(chunks) == 1:
        return chunks[0]
    return tree_map(lambda *xs: torch.cat(xs, dim=0), *chunks)


def drain_staging(memory, n_step_memory=None) -> None:
    """Drain the staging before any sample: fold the n-step buffer's staged
    steps and forward the raw rows its folds displaced to the main buffer
    (both rings then hold the same rows in the same order, the paired-index
    contract of PER and n-step sampling), then flush the main buffer."""
    if n_step_memory is not None and hasattr(n_step_memory, "take_raw"):
        raw = n_step_memory.take_raw()
        if raw is not None and memory is not None:
            memory.add(raw, batched=True)
    if memory is not None and hasattr(memory, "flush"):
        memory.flush()


class ReplayBuffer:
    """Uniform experience replay on ``device`` (the card when None, raising
    without one).

    ``seed=`` seeds the sampling generator (else one draw from the global
    numpy stream). ``len()`` counts flushed rows only.
    """

    def __init__(self, max_size: int, device: DeviceLike = None, seed: Optional[int] = None,
                 flush_every: Optional[int] = None):
        self.max_size = int(max_size)
        self.device = resolve_device(device)
        self.state: Optional[BufferState] = None
        # a cadence set here is kept when a training loop sets its default
        self._flush_every_user_set = flush_every is not None
        self.flush_every = max(int(flush_every), 1) if flush_every else 1
        self._staged: list = []
        self._staged_calls = 0
        self._size_host = 0
        self.seed(seed)

    def seed(self, seed: Optional[int] = None) -> None:
        """(Re)seed the sampling generator (a CPU ``torch.Generator``; each
        sample draws a generator on the device from it)."""
        self._key = derive_key(seed=seed)

    def _draw_key(self) -> torch.Generator:
        return split_key(self._key, self.device)

    def __len__(self) -> int:
        return self._size_host

    @property
    def is_full(self) -> bool:
        return len(self) >= self.max_size

    # -- device writes ------------------------------------------------- #
    def _device_add(self, rows: PyTree) -> None:
        if self.state is None:
            self.state = BufferState(_zeros_like_rows(rows, self.max_size, self.device), 0, 0)
        self.state = _add(self.state, rows)

    def add(self, transition: PyTree, batched: bool = False) -> None:
        """Append one transition (or a ``[N, ...]`` batch when ``batched``).
        Staged rows are flushed first, so the ring keeps the call order."""
        if self._staged:
            ReplayBuffer.flush(self)
        rows = _as_rows(transition, batched)
        if _num_rows(rows) > self.max_size:
            # longer than the ring: the flush writes it in capacity-sized pieces
            ReplayBuffer.stage(self, rows, batched=True)
            ReplayBuffer.flush(self)
            return
        self._device_add(rows)
        self._size_host = min(self._size_host + _num_rows(rows), self.max_size)

    def stage(self, transition: PyTree, batched: bool = False) -> None:
        """Queue a transition; flushes every ``flush_every`` calls."""
        self._staged.append(_as_rows(transition, batched))
        self._staged_calls += 1
        if self._staged_calls >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        """Write every staged row as one add (in capacity-sized pieces when
        the chunk is longer than the ring, so every write has distinct
        indices and the result equals per-step adds)."""
        if not self._staged:
            return
        chunk = _concat(self._staged)
        self._staged = []
        self._staged_calls = 0
        rows = _num_rows(chunk)
        for lo in range(0, rows, self.max_size):
            self._device_add(tree_map(lambda x: x[lo:lo + self.max_size], chunk))
        self._size_host = min(self._size_host + rows, self.max_size)

    def sample(self, batch_size: int, key: Optional[torch.Generator] = None,
               draws: Optional[torch.Tensor] = None) -> PyTree:
        """``batch_size`` rows at uniform indices (``draws``, when given,
        are the indices)."""
        self.flush()
        assert self.state is not None and len(self) > 0, "buffer is empty"
        if draws is None:
            key = key if key is not None else self._draw_key()
            draws = draw_indices(key, batch_size, self.state.size)
        return _gather(self.state, as_tensor(draws, self.device).long())

    def sample_from_indices(self, idx) -> PyTree:
        self.flush()
        return _gather(self.state, as_tensor(idx, self.device).long())

    def clear(self) -> None:
        self.state = None
        self._staged = []
        self._staged_calls = 0
        self._size_host = 0

    # -- snapshots ------------------------------------------------------- #
    def state_dict(self) -> Dict[str, Any]:
        """Host snapshot (numpy) of the ring, its cursors, the sampling
        generator's state (a numpy byte array) and the size mirror; staged
        rows are flushed first."""
        self.flush()
        sd: Dict[str, Any] = {
            "kind": type(self).__name__,
            "max_size": self.max_size,
            "flush_every": self.flush_every,
            "flush_every_user_set": self._flush_every_user_set,
            "size_host": self._size_host,
            "key": self._key.get_state().numpy(),
            "state": None,
        }
        if self.state is not None:
            sd["state"] = {"storage": tree_to_numpy(self.state.storage),
                           "pos": self.state.pos, "size": self.state.size}
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        """Restore a ``state_dict`` capture in place; sampling continues the
        captured generator's stream."""
        self._staged = []
        self._staged_calls = 0
        self.max_size = int(sd["max_size"])
        self.flush_every = max(int(sd["flush_every"]), 1)
        self._flush_every_user_set = bool(sd.get("flush_every_user_set", False))
        self._size_host = int(sd["size_host"])
        self._key = torch.Generator()
        self._key.set_state(torch.from_numpy(np.asarray(sd["key"], np.uint8).copy()))
        st = sd.get("state")
        self.state = None if st is None else BufferState(
            tree_from_numpy(st["storage"], self.device), int(st["pos"]), int(st["size"]))


# --------------------------------------------------------------------------- #
# N-step buffer
# --------------------------------------------------------------------------- #


def _on_one_device(seq: list) -> list:
    """Every transition of ``seq`` on the device of its last one (a window
    restored from a snapshot lies on the CPU)."""
    device = tree_leaves(seq[-1])[0].device
    return [tr if tree_leaves(tr)[0].device == device
            else tree_map(lambda x: x.to(device), tr) for tr in seq]


class MultiStepReplayBuffer(ReplayBuffer):
    """N-step return folding over vectorised envs.

    Keeps a window of the last n transitions; once it is full, every step
    pushes the FOLDED n-step transition (gamma-discounted reward sum,
    n-ahead ``next_obs`` and ``done``) into this buffer's ring and hands back
    the OLDEST raw transition for the main buffer. Both rings then append in
    lockstep, so index i is the same start step in both, and PER indices
    drawn on the main buffer gather the paired n-step rows here
    (``sample_from_indices``).

    Call ``reset_horizon()`` when the env is reset or the acting agent
    changes, so that no fold spans two trajectories.
    """

    def __init__(self, max_size: int, n_step: int = 3, gamma: float = 0.99,
                 device: DeviceLike = None, seed: Optional[int] = None,
                 flush_every: Optional[int] = None):
        super().__init__(max_size, device=device, seed=seed, flush_every=flush_every)
        self.n_step = int(n_step)
        self.gamma = float(gamma)
        self._horizon: list = []
        # staged raw steps not folded yet, and folded-but-untaken raw chunks
        self._staged_steps: list = []
        self._pending_raw: list = []

    def reset_horizon(self) -> None:
        """Fold the staged steps (they came before the reset), then start an
        empty window."""
        self.flush()
        self._horizon = []

    def clear(self) -> None:
        self._staged_steps = []
        self._pending_raw = []
        super().clear()
        self._horizon = []

    def add(self, transition: Dict, batched: bool = False) -> Optional[Dict]:
        """Keys: obs, action, reward, next_obs, done, and optionally
        ``_boundary`` (terminated | truncated: folds also stop at truncations
        and autoresets, while ``done`` stays terminated-only for the
        bootstrap). Returns the oldest raw transition once the window is
        full, else None."""
        self._horizon.append(_as_rows(transition, batched))
        if len(self._horizon) < self.n_step:
            return None
        fused, raw = self._fold_chunk(self._horizon, len(self._horizon) - 1)
        self._horizon.pop(0)
        ReplayBuffer.add(self, fused, batched=True)
        return raw if batched else tree_map(lambda x: x[0], raw)

    # -- staging: every window of a staged chunk folded at once --------- #
    def stage(self, transition: Dict, batched: bool = False) -> None:
        """Queue one raw step (no fold yet); folds every ``flush_every``
        steps. Do not mix with per-step ``add`` on one buffer: they share
        the window."""
        self._staged_steps.append(_as_rows(transition, batched))
        if len(self._staged_steps) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        """Fold every staged step (all window starts at once), stage the
        folded chunk into this ring and keep the displaced raw chunk for
        ``take_raw``, then write the ring's staging."""
        if self._staged_steps:
            steps, self._staged_steps = self._staged_steps, []
            seq = self._horizon + steps
            n = self.n_step
            if len(seq) >= n:
                fused, raw = self._fold_chunk(seq, len(self._horizon))
                self._horizon = seq[-(n - 1):] if n > 1 else []
                ReplayBuffer.stage(self, fused, batched=True)
                self._pending_raw.append(raw)
            else:
                self._horizon = seq
        ReplayBuffer.flush(self)

    def take_raw(self) -> Optional[Dict]:
        """The 1-step transitions displaced by folds since the last call, as
        one batched chunk for the main buffer."""
        self.flush()
        if not self._pending_raw:
            return None
        raw, self._pending_raw = _concat(self._pending_raw), []
        return raw

    def _fold_chunk(self, seq: list, n_prev: int) -> Tuple[Dict, Dict]:
        """Every n-step fold whose window ends in the new steps of ``seq``
        (the carried window, ``n_prev`` entries, then the new steps, each of
        ``[N, ...]`` leaves): window starts ``max(0, n_prev - n + 1) ..
        len(seq) - n``, in the order per-step adds make them. Returns
        (folded chunk, raw chunk), each flattened step-major to
        ``[M * N, ...]``."""
        n = self.n_step
        seq = _on_one_device(seq)
        starts = range(max(0, n_prev - n + 1), len(seq) - n + 1)

        def at(j, key):
            # [M, N, ...] across window position j
            return tree_map(lambda *xs: torch.stack(xs), *[seq[s + j][key] for s in starts])

        keys = [k for k in seq[0] if k != "_boundary"]
        first = {k: at(0, k) for k in keys}
        reward = torch.zeros_like(first["reward"], dtype=torch.float32)
        alive = torch.ones_like(reward)
        discount = 1.0
        next_obs = done = None
        for j in range(n):
            r = (first["reward"] if j == 0 else at(j, "reward")).float()
            d = torch.stack([seq[s + j].get("_boundary", seq[s + j]["done"])
                             for s in starts]).float()
            reward = reward + discount * r * alive
            if j == 0:
                next_obs = first["next_obs"]
                done = first["done"].float().clone()
            else:
                upd = alive.bool()
                next_obs = tree_map(
                    lambda cur, new: torch.where(
                        upd.view(upd.shape + (1,) * (new.dim() - upd.dim())), new, cur),
                    next_obs, at(j, "next_obs"))
                done = torch.where(upd, at(j, "done").float(), done)
            alive = alive * (1.0 - d)
            discount *= self.gamma

        def flat(x):
            return x.reshape((-1,) + tuple(x.shape[2:]))

        fused = {**first, "reward": reward, "next_obs": next_obs, "done": done}
        return tree_map(flat, fused), tree_map(flat, first)

    # -- snapshots ------------------------------------------------------- #
    def state_dict(self) -> Dict[str, Any]:
        """The ring's snapshot plus the n-step carry: the fold window and any
        folded-but-untaken raw chunks (staged steps are folded first)."""
        sd = super().state_dict()
        sd["n_step"] = self.n_step
        sd["gamma"] = self.gamma
        sd["horizon"] = [tree_to_numpy(tr) for tr in self._horizon]
        sd["pending_raw"] = [tree_to_numpy(c) for c in self._pending_raw]
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        super().load_state_dict(sd)
        self.n_step = int(sd["n_step"])
        self.gamma = float(sd["gamma"])
        self._horizon = [tree_from_numpy(tr, "cpu") for tr in sd.get("horizon", [])]
        self._pending_raw = [tree_from_numpy(c, "cpu") for c in sd.get("pending_raw", [])]
        self._staged_steps = []


# --------------------------------------------------------------------------- #
# Prioritized buffer: a dense priority array
# --------------------------------------------------------------------------- #


class PERState(NamedTuple):
    buffer: BufferState
    priorities: torch.Tensor  # [capacity] f32, alpha-powered
    max_priority: torch.Tensor  # 0-d f32 on the device


def _per_add(state: PERState, rows: PyTree) -> PERState:
    """Write ``rows`` at the cursor, each at the current max priority."""
    n = _num_rows(rows)
    idx = _write_index(state.buffer.pos, n, state.priorities.shape[0], state.priorities.device)
    buffer = _add(state.buffer, rows)
    state.priorities.index_copy_(0, idx, state.max_priority.expand(n))
    return PERState(buffer, state.priorities, state.max_priority)


def _per_sample(state: PERState, u: torch.Tensor,
                beta: float) -> Tuple[PyTree, torch.Tensor, torch.Tensor]:
    """Proportional sampling by inverse CDF on a dense cumulative sum, from
    uniform draws ``u`` in [0, 1): ``searchsorted(side="right")`` clipped to
    ``size - 1``. The importance weights are normalised by the largest
    weight any valid row could get (from the buffer's minimum priority), not
    by the batch's.

    The sum and the weights are taken in f64 and the weights returned in
    f32 (the JAX package sums in f32): an f32 cumulative sum over a full ring
    rounds differently on the card (a parallel scan) and on the CPU (a
    sequential one), enough to move an index at a row boundary; in f64 the
    two pick the same rows."""
    size = state.buffer.size
    capacity = state.priorities.shape[0]
    valid = torch.arange(capacity, device=u.device) < size
    p = torch.where(valid, state.priorities, 0.0).double()
    cdf = torch.cumsum(p, 0)
    total = cdf[-1]
    idx = torch.searchsorted(cdf, u.double() * total, right=True)
    idx = torch.clamp(idx, 0, max(size - 1, 0))
    batch = _gather(state.buffer, idx)
    denom = torch.clamp(total, min=1e-12)
    weights = (float(size) * (p[idx] / denom)) ** (-beta)
    p_min = torch.min(torch.where(valid, p, torch.inf)) / denom
    max_weight = (float(size) * torch.clamp(p_min, min=1e-12)) ** (-beta)
    return batch, idx, (weights / torch.clamp(max_weight, min=1e-12)).float()


def _per_update(state: PERState, idx: torch.Tensor, priorities: torch.Tensor,
                alpha: float) -> PERState:
    """Write ``max(|priority|, 1e-5) ** alpha`` at ``idx`` (a zero TD error
    must not zero a priority) and raise ``max_priority`` on the device. The
    rows of one batch that share an index carry one value (the same
    transition gives the same TD error), so the write order does not
    matter."""
    powered = torch.clamp(torch.abs(priorities), min=1e-5) ** alpha
    state.priorities.index_put_((idx,), powered)
    return PERState(state.buffer, state.priorities,
                    torch.maximum(state.max_priority, torch.max(powered)))


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay. Staged rows land in one
    ``_per_add``, each at the current max priority (the value per-step adds
    would give: ``max_priority`` moves only in ``update_priorities``)."""

    def __init__(self, max_size: int, alpha: float = 0.6, device: DeviceLike = None,
                 seed: Optional[int] = None, flush_every: Optional[int] = None):
        super().__init__(max_size, device=device, seed=seed, flush_every=flush_every)
        self.alpha = float(alpha)
        self.per_state: Optional[PERState] = None

    def _device_add(self, rows: PyTree) -> None:
        # every write of the base add / stage / flush comes through here
        if self.per_state is None:
            buf = BufferState(_zeros_like_rows(rows, self.max_size, self.device), 0, 0)
            self.per_state = PERState(
                buf, torch.zeros(self.max_size, dtype=torch.float32, device=self.device),
                torch.ones((), dtype=torch.float32, device=self.device))
        self.per_state = _per_add(self.per_state, rows)

    def sample(self, batch_size: int, beta: float = 0.4, key: Optional[torch.Generator] = None,
               draws: Optional[torch.Tensor] = None
               ) -> Tuple[PyTree, torch.Tensor, torch.Tensor]:
        """``(batch, idx, weights)`` by inverse CDF at uniforms in [0, 1)
        (``draws``, when given, are the uniforms)."""
        self.flush()
        assert self.per_state is not None and len(self) > 0, "buffer is empty"
        if draws is None:
            key = key if key is not None else self._draw_key()
            draws = torch.rand(batch_size, generator=key, device=key.device)
        return _per_sample(self.per_state, as_tensor(draws, self.device), float(beta))

    def update_priorities(self, idx, priorities) -> None:
        self.per_state = _per_update(self.per_state, as_tensor(idx, self.device).long(),
                                     as_tensor(priorities, self.device).float(), self.alpha)

    def sample_from_indices(self, idx) -> PyTree:
        self.flush()
        return _gather(self.per_state.buffer, as_tensor(idx, self.device).long())

    def clear(self) -> None:
        super().clear()
        self.per_state = None

    def state_dict(self) -> Dict[str, Any]:
        """The ring, the priority array and the running max priority (the
        base capture's ``state`` stays None: everything is in ``per_state``)."""
        sd = super().state_dict()
        sd["alpha"] = self.alpha
        sd["per_state"] = None
        if self.per_state is not None:
            buf = self.per_state.buffer
            sd["per_state"] = {"storage": tree_to_numpy(buf.storage), "pos": buf.pos,
                               "size": buf.size,
                               "priorities": self.per_state.priorities.cpu().numpy(),
                               "max_priority": float(self.per_state.max_priority)}
        return sd

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        super().load_state_dict(sd)
        self.alpha = float(sd.get("alpha", self.alpha))
        ps = sd.get("per_state")
        if ps is None:
            self.per_state = None
            return
        self.per_state = PERState(
            BufferState(tree_from_numpy(ps["storage"], self.device), int(ps["pos"]),
                        int(ps["size"])),
            torch.as_tensor(np.asarray(ps["priorities"], np.float32), device=self.device),
            torch.tensor(float(ps["max_priority"]), dtype=torch.float32, device=self.device))
