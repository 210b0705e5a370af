"""Crash-consistent whole-run snapshots: the port of
``agilerl_tpu/resilience/snapshot.py``.

A **snapshot** is a directory of pickled entries plus a ``manifest.json``
written last, committed atomically (``step_N.tmp/`` → fsync → ``os.replace``)
so a kill at any point leaves either nothing (ignorable ``*.tmp`` garbage) or
a complete, hash-validated snapshot. The capture spec covers everything a
"resumed run is the same run" guarantee needs:

- population: per-agent ``checkpoint_dict()`` (weights + HPs + ``steps`` +
  ``fitness``) **plus** the agent's random streams (its CPU
  ``torch.Generator`` and numpy Generator);
- replay-buffer rings (staging rings flushed first via the buffers' own
  ``state_dict`` which reuses ``stage()``/``flush()``);
- host RNG (numpy global + python ``random``) and the env's random stream;
- loop counters (``total_steps``, epsilon, fitness history, cadence state);
- tournament/mutation RNG and the lineage genealogy.

The torch rules, where the port differs from the JAX package:

- **Random streams.** A ``torch.Generator``'s state is stored as a numpy
  byte array with its device type (``utils/rng.generator_to_host``; the JAX
  package's ``key_to_host``). That covers the agent's ``_key``,
  ``Mutations._key``, a ``ScanRun``'s generator and a device env's
  (``TorchVecEnv._gen``, on the card). A CUDA generator's state restores
  only into a CUDA generator and a CPU one's only into a CPU one: any other
  pairing raises, and nothing is re-seeded quietly.
- **Payloads** are host numpy, as every store of the port: ``save`` refuses
  an entry that holds a tensor, so no CUDA tensor is ever pickled.
- **The frozen LLM base is left out.** A GRPO or DPO agent's
  ``checkpoint_dict()`` embeds ``init_dict``, whose ``base_params`` is the
  frozen base model (~14 GB at llama3-8b in bf16), and nothing reads it
  back: ``restore_agent`` goes through ``_restore``, which ignores
  ``init_dict``. So the snapshot records the base's fingerprint (every
  leaf's name, shape and dtype) in place of its weights, and restoring into
  an agent whose live base does not match raises. The JAX package pickles
  the base into every snapshot; this is a deviation.
- **LLM agents carry their reference adapter.** The agent's
  ``checkpoint_dict()`` holds the reference adapter and the dataset epoch it
  was taken at (``GRPO.checkpoint_dict``), so a run resumed mid-epoch keeps
  the reference of the epoch's start. The JAX snapshot leaves both out, and
  its resumed agent re-copies the restored actor into the reference.
- **``AsyncPytree``** (orbax in the JAX package) is written with
  ``torch.save`` of host tensors inside the staged directory; the sharded
  ``torch.distributed.checkpoint`` form waits for ``utils/checkpoint.py``.

:class:`CheckpointManager` owns the on-disk layout, retention (last K plus
the best-fitness snapshot) and the fallback scan: restore always lands on
the newest snapshot whose every entry validates against the manifest's
content hashes — torn or truncated snapshots are skipped with a warn-once,
never loaded.
"""

from __future__ import annotations

import copy
import json
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from agilerl_tpu_torch.resilience.atomic import (
    TMP_DIR_SUFFIX,
    CorruptSnapshotError,
    commit_dir,
    content_hash,
    load_validated_pickle,
    remove_stale_tmp_dirs,
    staged_pickle,
    staged_write_bytes,
)
from agilerl_tpu_torch.utils.rng import generator_from_host, generator_to_host

MANIFEST = "manifest.json"
SNAPSHOT_FORMAT = 1
_STEP_PREFIX = "step_"
_PYTREE_FILE = "tree.pt"


def _name_seq(name: str) -> int:
    """Resave sequence of a snapshot dir name (``step_N`` -> 0,
    ``step_N_3`` -> 3), parsed NUMERICALLY: a lexicographic name sort
    would rank ``_9`` above ``_10`` and hand restore/retention a stale
    same-step snapshot."""
    rest = name[len(_STEP_PREFIX):]
    if "_" not in rest:
        return 0
    try:
        return int(rest.rsplit("_", 1)[1])
    except ValueError:
        return 0


def _registry():
    from agilerl_tpu_torch.observability import get_registry

    return get_registry()


def _tensor_paths(obj: Any, path: str = "", out: Optional[List[str]] = None,
                  seen: Optional[set] = None) -> List[str]:
    """Paths of every ``torch.Tensor`` inside ``obj`` (dicts, lists, tuples
    and object attributes walked)."""
    out = [] if out is None else out
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        out.append(path or "<root>")
        return out
    if isinstance(obj, (str, bytes, int, float, bool, np.ndarray, np.generic, type(None))):
        return out
    if id(obj) in seen:
        return out
    seen.add(id(obj))
    if isinstance(obj, dict):
        for k, v in obj.items():
            _tensor_paths(v, f"{path}/{k}", out, seen)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for i, v in enumerate(obj):
            _tensor_paths(v, f"{path}/{i}", out, seen)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        for k, v in vars(obj).items():
            _tensor_paths(v, f"{path}.{k}", out, seen)
    return out


# --------------------------------------------------------------------------- #
# capture/restore helpers (duck-typed; every piece is optional)
# --------------------------------------------------------------------------- #


def capture_np_generator(gen: Optional[np.random.Generator]) -> Optional[dict]:
    if gen is None:
        return None
    return gen.bit_generator.state


def restore_np_generator(state: Optional[dict]) -> Optional[np.random.Generator]:
    if state is None:
        return None
    bg = getattr(np.random, state["bit_generator"])()
    bg.state = state
    return np.random.Generator(bg)


def base_fingerprint(tree: Any, prefix: str = "") -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, dtype) of every tensor leaf of a frozen base, in
    sorted order: what a snapshot keeps of an LLM agent's base instead of
    its weights."""
    out: List[Tuple[str, Tuple[int, ...], str]] = []
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            out.extend(base_fingerprint(tree[k], f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.extend(base_fingerprint(v, f"{prefix}/{i}"))
    elif isinstance(tree, torch.Tensor):
        out.append((prefix, tuple(tree.shape), str(tree.dtype).replace("torch.", "")))
    return out


def capture_agent(agent) -> Dict[str, Any]:
    """checkpoint_dict (params, HP config, steps, fitness) + random streams —
    a resumed agent continues the exact action/exploration sequence. An
    agent over a frozen base (``base_params``) keeps the base's fingerprint
    instead of its weights."""
    base = getattr(agent, "base_params", None)
    if base is not None:
        blob: Dict[str, Any] = {"ckpt": agent.checkpoint_dict(include_base=False),
                                "base_fingerprint": base_fingerprint(base)}
    else:
        blob = {"ckpt": agent.checkpoint_dict()}
    if hasattr(agent, "rng_state"):
        blob["rng"] = agent.rng_state()
    return blob


def restore_agent(agent, blob: Dict[str, Any]) -> bool:
    """Restore ``blob`` into ``agent`` in place. Raises ``ValueError``, the
    agent untouched, on a class mismatch or when the agent's frozen base
    does not match the snapshot's fingerprint (the JAX package warns once
    on a class mismatch and goes on with the live agent's fresh state)."""
    ckpt = blob["ckpt"]
    cls = ckpt.get("agilerl_tpu_torch_class")
    if cls is not None and cls != type(agent).__name__:
        raise ValueError(f"snapshot agent class {cls!r} != live agent "
                         f"{type(agent).__name__!r}")
    saved = blob.get("base_fingerprint")
    if saved is not None:
        live = base_fingerprint(getattr(agent, "base_params", None))
        if [tuple(map(_plain, e)) for e in saved] != [tuple(map(_plain, e)) for e in live]:
            diff = next((f"{a} != {b}" for a, b in zip(saved, live) if a != b),
                        f"{len(saved)} leaves != {len(live)}")
            raise ValueError("the live frozen base does not match the snapshot's "
                             f"fingerprint (first difference: {diff})")
    agent._restore(ckpt)
    if "rng" in blob and hasattr(agent, "set_rng_state"):
        agent.set_rng_state(blob["rng"])
    return True


def _plain(x):
    return tuple(int(i) for i in x) if isinstance(x, (list, tuple)) else x


def capture_host_rng() -> Dict[str, Any]:
    import random

    return {
        "numpy_global": np.random.get_state(),
        "python_random": random.getstate(),
    }


def restore_host_rng(blob: Optional[Dict[str, Any]]) -> None:
    if not blob:
        return
    import random

    if "numpy_global" in blob:
        np.random.set_state(blob["numpy_global"])
    if "python_random" in blob:
        random.setstate(tuple(
            tuple(x) if isinstance(x, list) else x for x in blob["python_random"]
        ))


def _env_attr_owner(env, attr: str):
    """Innermost wrapper-chain object that actually OWNS ``attr``. Wrappers
    (:class:`RetryingEnv`, gym-style proxies) forward attribute READS via
    ``__getattr__``, so a plain setattr on the outer object would only create
    a shadowing attribute and leave the wrapped env's real stream untouched —
    restore must assign on the owner. Ownership = the attribute lives in the
    instance dict or is defined by the class (e.g. gymnasium's ``np_random``
    property, whose setter forwards correctly)."""
    target, seen = env, set()
    while target is not None and id(target) not in seen:
        seen.add(id(target))
        if attr in getattr(target, "__dict__", {}) or hasattr(type(target), attr):
            return target
        target = getattr(target, "env", None)
    return None


def capture_env_rng(env) -> Optional[Dict[str, Any]]:
    """Best-effort env random-stream capture: an env's own ``state_dict``
    wins; the port's device envs (``TorchVecEnv``, ``MultiAgentTorchVecEnv``)
    hold a ``torch.Generator`` as ``_gen`` (on the card for a card env);
    gymnasium envs expose ``np_random``. Wrapper chains are walked to the
    owning env. The loops reset the env at every generation/agent boundary,
    so the random stream is the only env state a boundary snapshot needs
    for determinism."""
    if env is None:
        return None
    owner = _env_attr_owner(env, "state_dict")
    sd = getattr(owner, "state_dict", None)
    if callable(sd):
        try:
            return {"kind": "state_dict", "state": sd()}
        except Exception as e:
            # falling through to a stream-only capture silently breaks the
            # resumed-run-is-the-same-run guarantee for envs with data
            # cursors — say so once, like capture_buffers does
            _registry().warn_once(
                f"resilience:env_state_dict_failed:{type(env).__name__}",
                f"env {type(env).__name__}.state_dict() raised {e!r} — "
                "capturing only its random stream; a resumed run may not "
                "continue the same env stream",
            )
    owner = _env_attr_owner(env, "_gen")
    if owner is not None and isinstance(owner._gen, torch.Generator):
        return {"kind": "torch_generator", "gen": generator_to_host(owner._gen)}
    owner = _env_attr_owner(env, "np_random")
    np_random = getattr(owner, "np_random", None)
    if np_random is not None:
        try:
            return {"kind": "np_random", "state": np_random.bit_generator.state}
        except Exception:
            pass
    return None


def restore_env_rng(env, blob: Optional[Dict[str, Any]]) -> None:
    """Restore a ``capture_env_rng`` blob. A generator captured on one
    device type raises on another (``generator_from_host``)."""
    if not blob or env is None:
        return
    kind = blob.get("kind")
    if kind == "state_dict":
        owner = _env_attr_owner(env, "load_state_dict")
        if owner is None:
            raise ValueError(f"snapshot holds an env state_dict but {type(env).__name__} "
                             "has no load_state_dict")
        owner.load_state_dict(blob["state"])
    elif kind == "torch_generator":
        owner = _env_attr_owner(env, "_gen")
        if owner is None or not isinstance(owner._gen, torch.Generator):
            raise ValueError(f"snapshot holds an env generator but {type(env).__name__} "
                             "has none")
        generator_from_host(owner._gen, blob["gen"])
    elif kind == "np_random":
        gen = restore_np_generator(blob["state"])
        owner = _env_attr_owner(env, "np_random")
        if gen is not None and owner is not None:
            try:
                owner.np_random = gen
            except Exception:
                pass


def capture_evolution(tournament, mutation, lineage) -> Dict[str, Any]:
    blob: Dict[str, Any] = {}
    if tournament is not None and getattr(tournament, "rng", None) is not None:
        blob["tournament_rng"] = capture_np_generator(tournament.rng)
    if mutation is not None:
        if getattr(mutation, "rng", None) is not None:
            blob["mutation_rng"] = capture_np_generator(mutation.rng)
        if getattr(mutation, "_key", None) is not None:
            blob["mutation_key"] = generator_to_host(mutation._key)
    if lineage is not None:
        blob["lineage"] = capture_lineage(lineage)
    return blob


def restore_evolution(blob: Optional[Dict[str, Any]], tournament, mutation,
                      lineage) -> None:
    if not blob:
        return
    if tournament is not None and blob.get("tournament_rng") is not None:
        tournament.rng = restore_np_generator(blob["tournament_rng"])
    if mutation is not None:
        if blob.get("mutation_rng") is not None:
            mutation.rng = restore_np_generator(blob["mutation_rng"])
        if blob.get("mutation_key") is not None:
            generator_from_host(mutation._key, blob["mutation_key"])
    if lineage is not None and blob.get("lineage") is not None:
        restore_lineage(lineage, blob["lineage"])


def capture_lineage(tracker) -> Dict[str, Any]:
    """Genealogy as pure data. ``_pending`` holds references INTO
    ``generations`` — captured as positions so restore can rebuild the
    aliasing (a pickled tracker would carry its unpicklable registry).
    ``generations`` is referenced, not copied: the facade pickles the blob
    in the same synchronous call, and pending entries live in the newest
    generations, so the reverse scan stays O(1) over a long run."""
    positions: Dict[int, Tuple[int, int]] = {}
    for idx, child in tracker._pending.items():
        for gi in range(len(tracker.generations) - 1, -1, -1):
            hit = next(
                (ci for ci, c in enumerate(tracker.generations[gi]["children"])
                 if c is child), None,
            )
            if hit is not None:
                positions[int(idx)] = (gi, hit)
                break
    return {
        "generation": tracker.generation,
        "generations": tracker.generations,
        "pending": positions,
    }


def restore_lineage(tracker, blob: Dict[str, Any]) -> None:
    tracker.generation = int(blob["generation"])
    tracker.generations = copy.deepcopy(blob["generations"])
    tracker._pending = {
        int(idx): tracker.generations[gi]["children"][ci]
        for idx, (gi, ci) in blob["pending"].items()
    }


def capture_buffers(**buffers) -> Dict[str, Any]:
    """``state_dict`` every named buffer that supports it (``None`` values and
    plain user buffers without ``state_dict`` are skipped). The buffers flush
    their own staging rings first."""
    out = {}
    for name, buf in buffers.items():
        if buf is None:
            continue
        sd = getattr(buf, "state_dict", None)
        if callable(sd):
            out[name] = sd()
        else:
            _registry().warn_once(
                f"resilience:buffer_not_capturable:{name}",
                f"buffer {name!r} ({type(buf).__name__}) has no state_dict — "
                "its contents will NOT survive a resume",
            )
    return out


def restore_buffers(blob: Optional[Dict[str, Any]], **buffers) -> None:
    if not blob:
        return
    for name, buf in buffers.items():
        if buf is None or name not in blob:
            continue
        lsd = getattr(buf, "load_state_dict", None)
        if callable(lsd):
            lsd(blob[name])


# --------------------------------------------------------------------------- #
# CheckpointManager
# --------------------------------------------------------------------------- #


class AsyncPytree:
    """Wrap a snapshot entry value to write it with ``torch.save`` instead of
    pickling it into the manifest-hashed entry (the JAX package routes it
    through orbax): a tree of tensors, each written as a host tensor into a
    ``<name>.pytree/`` directory inside the staged snapshot, so it rides the
    same atomic commit. Loads come back as CPU tensors. The sharded
    ``torch.distributed.checkpoint`` form waits for ``utils/checkpoint.py``."""

    __slots__ = ("tree",)

    def __init__(self, tree: Any):
        self.tree = tree


def _save_pytree(directory: Path, tree: Any) -> None:
    from agilerl_tpu_torch.resilience.atomic import fsync_dir, fsync_file
    from agilerl_tpu_torch.utils.tree import tree_map

    directory.mkdir(parents=True)
    host = tree_map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, tree)
    path = directory / _PYTREE_FILE
    torch.save(host, path)
    fsync_file(path)
    fsync_dir(directory)


def _load_pytree(directory: Path) -> Any:
    return torch.load(directory / _PYTREE_FILE, map_location="cpu", weights_only=False)


class SnapshotInfo:
    """A committed snapshot directory + its parsed manifest."""

    __slots__ = ("path", "manifest")

    def __init__(self, path: Path, manifest: Dict[str, Any]):
        self.path = path
        self.manifest = manifest

    @property
    def step(self) -> int:
        return int(self.manifest.get("step", -1))

    @property
    def kind(self) -> str:
        return str(self.manifest.get("kind", "cadence"))

    @property
    def fitness(self) -> Optional[float]:
        f = self.manifest.get("fitness")
        return None if f is None else float(f)

    @property
    def member_fitness(self) -> Optional[List[Optional[float]]]:
        """Per-member fitness recorded at save time (manifest-level, so
        best-member restore and island top-k selection read it WITHOUT
        unpickling the population entry). ``None`` when the snapshot
        predates the field."""
        mf = self.manifest.get("member_fitness")
        if mf is None:
            return None
        return [None if f is None else float(f) for f in mf]

    @property
    def member_ids(self) -> Optional[List[int]]:
        """Stable member (slot-lineage) ids aligned with ``member_fitness``,
        for restoring a specific lost member from its snapshot row."""
        ids = self.manifest.get("member_ids")
        if ids is None:
            return None
        return [int(i) for i in ids]

    def best_member_index(self) -> Optional[int]:
        """Row index of the highest finite per-member fitness (None when the
        manifest carries no usable member fitness)."""
        mf = self.member_fitness
        if not mf:
            return None
        finite = [(f, i) for i, f in enumerate(mf)
                  if f is not None and np.isfinite(f)]
        if not finite:
            return None
        return max(finite)[1]

    @property
    def nbytes(self) -> int:
        """Bytes of the committed snapshot on disk (every file under it)."""
        return sum(f.stat().st_size for f in self.path.rglob("*") if f.is_file())

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"SnapshotInfo(step={self.step}, kind={self.kind!r}, path={self.path})"


class CheckpointManager:
    """Atomic versioned snapshots with retention and validated restore.

    Layout::

        <directory>/
          step_000000001000/           # committed snapshot
            population.pkl
            buffers.pkl
            ...
            manifest.json              # written LAST; per-entry sha256
          step_000000002000.tmp/       # crashed save — ignored, swept

    ``save()`` commits atomically; ``load()`` walks snapshots newest-first
    and returns the first whose every entry validates, so a torn or
    corrupted newest snapshot degrades to the previous complete one instead
    of crashing the resume.
    """

    def __init__(
        self,
        directory: Union[str, Path],
        keep_last: int = 3,
        keep_best: bool = True,
        registry=None,
    ):
        self.directory = Path(directory)
        self.keep_last = max(int(keep_last), 1)
        self.keep_best = bool(keep_best)
        self._registry = registry
        self.directory.mkdir(parents=True, exist_ok=True)
        remove_stale_tmp_dirs(self.directory)

    # -- registry plumbing ------------------------------------------------ #
    @property
    def registry(self):
        return self._registry if self._registry is not None else _registry()

    # -- write path ------------------------------------------------------- #
    def save(
        self,
        entries: Dict[str, Any],
        step: int,
        kind: str = "cadence",
        fitness: Optional[float] = None,
        extra_meta: Optional[Dict[str, Any]] = None,
        member_fitness: Optional[Any] = None,
        member_ids: Optional[Any] = None,
    ) -> Path:
        """Commit one snapshot atomically. ``entries`` maps entry name →
        picklable host object (an entry holding a ``torch.Tensor`` raises
        ``TypeError`` before anything is written); each is written to
        ``<name>.pkl`` with its sha256 recorded in the manifest, which is
        written last. Wrap a value in :class:`AsyncPytree` to write it with
        ``torch.save`` instead.

        ``member_fitness`` / ``member_ids`` record the population's
        per-member fitness at MANIFEST level (non-finite values stored as
        null) so best-member restore and island top-k selection never have
        to unpickle whole snapshots. When ``fitness`` is omitted it is
        derived as the best finite member fitness, keeping ``keep_best``
        retention consistent with the per-member field."""
        t0 = time.perf_counter()
        for name, obj in entries.items():
            if isinstance(obj, AsyncPytree):
                continue
            found = _tensor_paths(obj)
            if found:
                raise TypeError(f"snapshot entry {name!r} holds torch tensors at {found[:3]}: "
                                "payloads are host numpy")
        if member_fitness is not None:
            # element-wise, not np.asarray over the list: the input may be
            # exactly what SnapshotInfo.member_fitness returned, nulls and
            # all, and the round-trip must not crash on them
            cleaned = []
            for f in member_fitness:
                f = None if f is None else float(f)
                cleaned.append(f if f is not None and np.isfinite(f) else None)
            member_fitness = cleaned
            finite = [f for f in member_fitness if f is not None]
            if fitness is None and finite:
                fitness = max(finite)
        base = f"{_STEP_PREFIX}{int(step):012d}"
        # never overwrite a committed snapshot: a same-step resave (e.g. a
        # final snapshot right after a cadence one) commits under a suffixed
        # sibling name — the delete-old/publish-new race simply cannot
        # happen, and restore prefers the highest seq at equal step. The
        # seq continues from the MAX existing one, not the first free name:
        # retention frees earlier names, and reusing them would make the
        # (step, seq) order disagree with save order
        siblings = [
            d.name for d in self.directory.iterdir()
            if d.is_dir() and not d.name.endswith(TMP_DIR_SUFFIX)
            and (d.name == base or d.name.startswith(base + "_"))
        ]
        if siblings:
            seq = 1 + max(_name_seq(n) for n in siblings)
            final = self.directory / f"{base}_{seq:04d}"
        else:
            final = self.directory / base
        tmp = self.directory / (final.name + TMP_DIR_SUFFIX)
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest_entries: Dict[str, Dict[str, Any]] = {}
        for name, obj in entries.items():
            if isinstance(obj, AsyncPytree):
                # torch.save path: integrity is the directory's presence,
                # not a content hash (as the JAX package's orbax entries)
                fname = f"{name}.pytree"
                _save_pytree(tmp / fname, obj.tree)
                manifest_entries[fname] = {"kind": "pytree"}
                continue
            fname = name if name.endswith(".pkl") else f"{name}.pkl"
            sha, nbytes = staged_pickle(tmp / fname, obj)
            manifest_entries[fname] = {"sha256": sha, "bytes": nbytes}
        manifest = {
            "format": SNAPSHOT_FORMAT,
            "step": int(step),
            "kind": str(kind),
            "fitness": None if fitness is None else float(fitness),
            "time": time.time(),
            "entries": manifest_entries,
        }
        if member_fitness is not None:
            manifest["member_fitness"] = member_fitness
        if member_ids is not None:
            manifest["member_ids"] = [int(i) for i in member_ids]
        if extra_meta:
            manifest.update(extra_meta)
        staged_write_bytes(
            tmp / MANIFEST, json.dumps(manifest, indent=2).encode()
        )
        commit_dir(tmp, final)
        self._retain()
        reg = self.registry
        reg.counter("resilience/snapshots_total").inc()
        reg.gauge("resilience/snapshot_time_s").set(time.perf_counter() - t0)
        return final

    # -- scan/validate ---------------------------------------------------- #
    def snapshots(self) -> List[SnapshotInfo]:
        """Committed snapshots with a readable manifest, ascending by step.
        Uncommitted ``*.tmp`` dirs and manifest-less dirs are invisible."""
        out: List[SnapshotInfo] = []
        if not self.directory.is_dir():
            return out
        for d in self.directory.iterdir():
            if not d.is_dir() or not d.name.startswith(_STEP_PREFIX):
                continue
            if d.name.endswith(TMP_DIR_SUFFIX):
                continue
            mf = d / MANIFEST
            try:
                manifest = json.loads(mf.read_text())
            except (OSError, ValueError):
                continue
            out.append(SnapshotInfo(d, manifest))
        out.sort(key=lambda s: (s.step, _name_seq(s.path.name)))
        return out

    def validate(self, info: SnapshotInfo) -> bool:
        """Every manifest entry exists with a matching content hash (pytree
        entries: a non-empty directory)."""
        try:
            for fname, meta in info.manifest.get("entries", {}).items():
                if meta.get("kind") == "pytree":
                    d = info.path / fname
                    if not d.is_dir() or not any(d.iterdir()):
                        return False
                    continue
                data = (info.path / fname).read_bytes()
                if len(data) != int(meta.get("bytes", len(data))):
                    return False
                if content_hash(data) != meta["sha256"]:
                    return False
        except (OSError, KeyError, TypeError, ValueError):
            return False
        return True

    def latest(self, validate: bool = True) -> Optional[SnapshotInfo]:
        """Newest snapshot (optionally: newest snapshot that fully
        validates — the restore default)."""
        snaps = self.snapshots()
        for info in reversed(snaps):
            if not validate or self.validate(info):
                return info
            self.registry.warn_once(
                f"resilience:snapshot_corrupt:{info.path.name}",
                f"snapshot {info.path.name} failed validation — "
                "falling back to an older snapshot",
            )
            self.registry.counter("resilience/restore_fallbacks_total").inc()
        return None

    def best(self) -> Optional[SnapshotInfo]:
        """Highest-fitness committed snapshot (None when no snapshot carries
        a fitness)."""
        with_fit = [s for s in self.snapshots() if s.fitness is not None]
        if not with_fit:
            return None
        return max(with_fit, key=lambda s: (s.fitness, s.step))

    def load(self, info: Optional[SnapshotInfo] = None) -> Optional[
        Tuple[SnapshotInfo, Dict[str, Any]]
    ]:
        """Unpickle every entry of ``info`` (default: newest), hash-validated.
        Walks backwards past snapshots whose entries fail to load — restore
        always lands on the latest COMPLETE snapshot."""
        candidates = [info] if info is not None else list(reversed(self.snapshots()))
        for cand in candidates:
            try:
                entries = {}
                for fname, meta in cand.manifest.get("entries", {}).items():
                    if meta.get("kind") == "pytree":
                        try:
                            obj = _load_pytree(cand.path / fname)
                        except Exception as e:
                            raise CorruptSnapshotError(
                                f"pytree entry unreadable: {cand.path / fname}: {e}"
                            ) from e
                        entries[fname[: -len(".pytree")]] = obj
                        continue
                    obj = load_validated_pickle(
                        cand.path / fname, meta.get("sha256")
                    )
                    entries[fname[:-4] if fname.endswith(".pkl") else fname] = obj
                return cand, entries
            except CorruptSnapshotError as e:
                self.registry.warn_once(
                    f"resilience:snapshot_corrupt:{cand.path.name}",
                    f"snapshot {cand.path.name} unreadable ({e}) — "
                    "falling back to an older snapshot",
                )
                self.registry.counter("resilience/restore_fallbacks_total").inc()
        return None

    # -- retention -------------------------------------------------------- #
    def _retain(self) -> None:
        snaps = self.snapshots()
        keep = {s.path for s in snaps[-self.keep_last:]}
        if self.keep_best:
            best = self.best()
            if best is not None:
                keep.add(best.path)
        for s in snaps:
            if s.path not in keep:
                shutil.rmtree(s.path, ignore_errors=True)
