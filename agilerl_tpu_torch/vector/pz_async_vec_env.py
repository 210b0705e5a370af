"""Asynchronous (multiprocess) PettingZoo vectorisation: the port of
``agilerl_tpu/vector/pz_async_vec_env.py``.

Each env runs in a worker process of its own (``spawn`` context, so the env
factory must be picklable: a module-level class or function, or a
``functools.partial`` of one). Observations travel through typed shared
memory, one block per (agent, space leaf): Dict and Tuple spaces decompose
into leaves, each with its own dtype (bool stored as uint8); commands,
rewards, flags, infos and the final observations at an episode's end travel
over pipes. An agent missing from a step's dicts gets a placeholder (NaN for
float leaves, 0 for integer ones; NaN rewards), which ``AsyncAgentsWrapper``
reads as inactivity and the standard loops zero (``sanitize_ma_transition``).
A worker that raises sends its traceback, and the next ``reset`` or
``step_wait`` raises it. Spaces are read through ``utils.spaces.space_kind``,
so the port's spaces and gymnasium's both work. Everything here is host
numpy.
"""

from __future__ import annotations

import enum
import multiprocessing as mp
import traceback
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from agilerl_tpu_torch.utils.spaces import space_kind


class AsyncState(enum.Enum):
    DEFAULT = "default"
    WAITING_RESET = "reset"
    WAITING_STEP = "step"


# ctypes typecodes of the shared arrays, by numpy dtype name
_TYPECODES = {
    "float32": "f", "float64": "d",
    "int8": "b", "int16": "h", "int32": "i", "int64": "q",
    "uint8": "B", "uint16": "H", "uint32": "I", "uint64": "Q",
    "bool": "B",  # stored as uint8, cast back on read
}


def _space_leaves(space, prefix: str = "") -> List[Tuple[str, np.dtype, tuple]]:
    """A (possibly Dict / Tuple) space as its (key, dtype, shape) leaves."""
    kind = space_kind(space)
    if kind == "dict":
        out = []
        for k in space.spaces:
            out.extend(_space_leaves(space.spaces[k], f"{prefix}{k}."))
        return out
    if kind == "tuple":
        out = []
        for i, sub in enumerate(space.spaces):
            out.extend(_space_leaves(sub, f"{prefix}{i}."))
        return out
    if kind == "discrete":
        return [(prefix, np.dtype(space.dtype or np.int64), ())]
    shape = tuple(space.shape) if space.shape else ()
    return [(prefix, np.dtype(space.dtype or np.float32), shape)]


def _obs_leaves(space, obs) -> List[np.ndarray]:
    """An observation's leaves in ``_space_leaves`` order."""
    kind = space_kind(space)
    if kind == "dict":
        out = []
        for k in space.spaces:
            out.extend(_obs_leaves(space.spaces[k], obs[k]))
        return out
    if kind == "tuple":
        out = []
        for i, sub in enumerate(space.spaces):
            out.extend(_obs_leaves(sub, obs[i]))
        return out
    return [np.asarray(obs)]


def _rebuild_obs(space, leaves: List[np.ndarray]):
    """The inverse of ``_obs_leaves`` for batched ``[N, ...]`` leaves
    (consumed from the front of ``leaves``)."""
    kind = space_kind(space)
    if kind == "dict":
        return {k: _rebuild_obs(space.spaces[k], leaves) for k in space.spaces}
    if kind == "tuple":
        return tuple(_rebuild_obs(sub, leaves) for sub in space.spaces)
    return leaves.pop(0)


def placeholder_obs(space):
    """The observation of an agent absent from a step's dicts: NaN for float
    leaves (detectably invalid: ``AsyncAgentsWrapper`` keys inactivity on
    it), 0 for integer leaves."""
    kind = space_kind(space)
    if kind == "dict":
        return {k: placeholder_obs(space.spaces[k]) for k in space.spaces}
    if kind == "tuple":
        return tuple(placeholder_obs(sub) for sub in space.spaces)
    if kind == "discrete":
        return np.zeros((), dtype=space.dtype or np.int64)
    dtype = np.dtype(space.dtype or np.float32)
    if np.issubdtype(dtype, np.floating):
        return np.full(space.shape or (), np.nan, dtype=dtype)
    return np.zeros(space.shape or (), dtype=dtype)


def _async_worker(index, env_fn, pipe, parent_pipe, shm, agents, spaces_by_agent):
    """One env's loop: commands in over the pipe, observations out through
    the shared blocks, everything else back over the pipe."""
    parent_pipe.close()
    env = env_fn()
    leaves_by_agent = {a: _space_leaves(spaces_by_agent[a]) for a in agents}

    def write_obs(obs):
        for a in agents:
            space = spaces_by_agent[a]
            value = obs.get(a) if isinstance(obs, dict) else None
            if value is None:
                value = placeholder_obs(space)
            for (key, _, shape), leaf in zip(leaves_by_agent[a], _obs_leaves(space, value)):
                block, np_dtype = shm[a][key]
                size = int(np.prod(shape)) if shape else 1
                arr = np.frombuffer(block.get_obj(), dtype=np_dtype)
                arr[index * size:(index + 1) * size] = np.asarray(leaf, np_dtype).reshape(-1)

    try:
        while True:
            cmd, data = pipe.recv()
            if cmd == "reset":
                seed, options = data
                obs, info = env.reset(seed=seed, options=options)
                write_obs(obs)
                pipe.send((({a: info.get(a, {}) for a in agents}
                            if isinstance(info, dict) else {}), True))
            elif cmd == "step":
                action = {a: data[a] for a in env.agents} if env.agents else data
                obs, rew, term, trunc, info = env.step(action)
                final_obs = None
                if not env.agents:  # every agent's episode is over: autoreset
                    # the true final observations, before the reset replaces them
                    final_obs = {a: np.asarray(v, copy=True)
                                 if not isinstance(v, (dict, tuple)) else v
                                 for a, v in obs.items()}
                    obs, _ = env.reset()
                write_obs(obs)
                out = (
                    {a: float(rew[a]) if a in rew else float("nan") for a in agents},
                    {a: bool(term.get(a, False)) for a in agents},
                    {a: bool(trunc.get(a, False)) for a in agents},
                    {a: info.get(a, {}) for a in agents} if isinstance(info, dict) else {},
                    final_obs,
                )
                pipe.send((out, True))
            elif cmd == "close":
                env.close()
                pipe.send(((), True))
                break
    except Exception:
        pipe.send((traceback.format_exc(), False))


class AsyncPettingZooVecEnv:
    """``len(env_fns)`` PettingZoo parallel envs, each in a worker process.
    ``step`` autoresets an env whose agents are all done; ``info`` then
    carries ``final_obs`` (the pre-reset observations merged with the current
    ones) and ``autoreset`` (the [N] rows that just reset)."""

    def __init__(self, env_fns: List[Callable], context: str = "spawn"):
        ctx = mp.get_context(context)
        self.num_envs = len(env_fns)
        probe = env_fns[0]()
        self.agents = list(probe.possible_agents)
        self.possible_agents = list(probe.possible_agents)
        self.observation_spaces = {a: probe.observation_space(a) for a in self.agents}
        self.action_spaces = {a: probe.action_space(a) for a in self.agents}
        self.agent_ids = self.agents
        probe.close()
        self._shm: Dict[str, Dict[str, tuple]] = {}
        for a in self.agents:
            self._shm[a] = {}
            for key, dtype, shape in _space_leaves(self.observation_spaces[a]):
                np_dtype = np.dtype("uint8") if dtype == np.dtype(bool) else dtype
                size = int(np.prod(shape)) if shape else 1
                self._shm[a][key] = (ctx.Array(_TYPECODES[dtype.name], self.num_envs * size),
                                     np_dtype)
        self._pipes, self._procs = [], []
        for i, fn in enumerate(env_fns):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_async_worker,
                               args=(i, fn, child, parent, self._shm, self.agents,
                                     self.observation_spaces),
                               daemon=True)
            proc.start()
            child.close()
            self._pipes.append(parent)
            self._procs.append(proc)
        self._state = AsyncState.DEFAULT
        self._closed = False

    def observation_space(self, agent: str):
        return self.observation_spaces[agent]

    def action_space(self, agent: str):
        return self.action_spaces[agent]

    def _assert_is_running(self):
        if self._closed or not all(p.is_alive() for p in self._procs):
            raise RuntimeError("an env worker is not running (closed or died)")

    @staticmethod
    def _raise_if_errors(results):
        for out, ok in results:
            if not ok:
                raise RuntimeError(f"env worker error:\n{out}")

    def _read_leaves(self, a: str) -> List[np.ndarray]:
        leaves = []
        for key, dtype, shape in _space_leaves(self.observation_spaces[a]):
            block, np_dtype = self._shm[a][key]
            arr = np.frombuffer(block.get_obj(), dtype=np_dtype).copy()
            leaves.append(arr.astype(dtype, copy=False).reshape((self.num_envs,) + shape))
        return leaves

    def _read_obs(self) -> Dict[str, np.ndarray]:
        return {a: _rebuild_obs(self.observation_spaces[a], self._read_leaves(a))
                for a in self.agents}

    def reset(self, seed: Optional[int] = None, options=None):
        self._assert_is_running()
        if self._state is not AsyncState.DEFAULT:
            # a pending step's result would be taken for the reset's
            raise RuntimeError(f"reset called while an async call is pending "
                               f"(state={self._state.name})")
        for i, pipe in enumerate(self._pipes):
            pipe.send(("reset", (None if seed is None else seed + i, options)))
        results = [pipe.recv() for pipe in self._pipes]
        self._raise_if_errors(results)
        return self._read_obs(), {"env_infos": [r for r, _ in results]}

    def step_async(self, actions: Dict[str, np.ndarray]) -> None:
        self._assert_is_running()
        if self._state is not AsyncState.DEFAULT:
            raise RuntimeError(f"step_async called while an async call is pending "
                               f"(state={self._state.name})")
        for i, pipe in enumerate(self._pipes):
            act_i = {a: np.asarray(actions[a])[i] for a in self.agents}
            act_i = {a: int(v) if hasattr(self.action_spaces[a], "n") else v
                     for a, v in act_i.items()}
            pipe.send(("step", act_i))
        self._state = AsyncState.WAITING_STEP

    def step_wait(self):
        self._assert_is_running()
        if self._state is not AsyncState.WAITING_STEP:
            raise RuntimeError("step_wait called without a pending step_async "
                               f"(state={self._state.name})")
        results = [pipe.recv() for pipe in self._pipes]
        self._state = AsyncState.DEFAULT
        self._raise_if_errors(results)
        rews, terms, truncs, env_infos, finals = zip(*[r for r, _ in results])

        def stack(ds):
            return {a: np.array([d[a] for d in ds]) for a in self.agents}

        next_obs = self._read_obs()
        info: Dict = {"env_infos": list(env_infos),
                      "autoreset": np.array([f is not None for f in finals], bool)}
        if any(f is not None for f in finals):
            # the true pre-reset successor where an env just finished, the
            # current observation elsewhere
            final_obs = {}
            for a in self.agents:
                space = self.observation_spaces[a]
                rows = [_obs_leaves(space, finals[i][a])
                        if finals[i] is not None and a in finals[i] else None
                        for i in range(self.num_envs)]
                leaves = self._read_leaves(a)
                for li, (_, dtype, shape) in enumerate(_space_leaves(space)):
                    for i in range(self.num_envs):
                        if rows[i] is not None:
                            leaves[li][i] = np.asarray(rows[i][li], dtype).reshape(shape)
                final_obs[a] = _rebuild_obs(space, leaves)
            info["final_obs"] = final_obs
        return next_obs, stack(rews), stack(terms), stack(truncs), info

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def close(self):
        """Stop every worker (a second call does nothing)."""
        if self._closed:
            return
        self._closed = True
        try:
            for pipe in self._pipes:
                pipe.send(("close", None))
            for pipe in self._pipes:
                pipe.recv()
        except (BrokenPipeError, EOFError, ConnectionResetError, OSError):
            pass  # workers already dead (a propagated crash)
        for p in self._procs:
            p.join(timeout=2)
            if p.is_alive():
                p.terminate()
                p.join()
        for pipe in self._pipes:
            pipe.close()
