"""Tree and LLM checkpoints on ``torch.distributed.checkpoint`` (DCP): the
port of ``agilerl_tpu/utils/checkpoint.py``, where orbax writes them.

Pickle checkpoints (``EvolvableAlgorithm.save_checkpoint``) stay the
lightweight per-agent path; these helpers add:

- saves of arbitrarily large trees through DCP's file-system writer (one
  ``.distcp`` file per rank, every rank writing only its own shards when a
  process group is up; in one process with no group, one file);
- atomic versioned step directories (staged under ``step_N.tmp`` and
  published with the resilience subsystem's fsync + ``os.replace`` commit,
  so a kill mid-save never leaves a half-written step dir) with optional
  retention (``keep_last=K`` prunes older step dirs after each save). A save
  without a step is staged and committed the same way, so overwriting a
  checkpoint is atomic too.

DCP restores INTO tensors that the caller allocates. So that
``load_pytree(path)`` needs no template, every save writes the tree's
structure beside the shards (``structure.pkl``: the nesting of dicts, lists
and tuples, including named tuples such as optimizer states), and the
template is built from DCP's own metadata (each tensor's shape and dtype).
Tensor leaves go through DCP; numpy-array leaves go through it as tensors and
come back as numpy arrays of their dtype; any other leaf (ints, floats,
strings, None, numpy scalars) rides the structure file. With ``like`` the
tensors are restored onto the devices of ``like``'s leaves (the card, say);
without it, onto the CPU.
"""

from __future__ import annotations

import contextlib
import pickle
import shutil
import warnings
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

_STEP_PREFIX = "step_"
_STRUCTURE = "structure.pkl"
_TMP = ".tmp"


def step_dirs(path: Union[str, Path]) -> List[Path]:
    """Committed ``step_N`` directories under ``path``, ascending by step
    (uncommitted ``*.tmp`` staging dirs are invisible)."""
    path = Path(path)
    if not path.is_dir():
        return []
    out = []
    for d in path.iterdir():
        if not d.is_dir() or d.name.endswith(_TMP):
            continue
        if d.name.startswith(_STEP_PREFIX):
            try:
                out.append((int(d.name[len(_STEP_PREFIX):]), d))
            except ValueError:
                continue
    return [d for _, d in sorted(out)]


def retain_step_dirs(path: Union[str, Path], keep_last: int) -> int:
    """Prune all but the newest ``keep_last`` committed step dirs. Returns how
    many were removed."""
    dirs = step_dirs(path)
    removed = 0
    for d in dirs[: -max(int(keep_last), 1)]:
        shutil.rmtree(d, ignore_errors=True)
        removed += 1
    return removed


class _Leaf(tuple):
    """A leaf's place in the saved structure: ``(kind, payload)`` with kind
    ``"tensor"`` / ``"numpy"`` (payload: its DCP key) or ``"value"``
    (payload: the value itself)."""


def _split(tree: Any, prefix: str, tensors: Dict[str, torch.Tensor]) -> Any:
    """The tree's structure with every leaf replaced by a :class:`_Leaf`;
    tensor and numpy leaves land in ``tensors`` under their path. Raises
    ``ValueError`` where two leaves would share a path (``{"a/b": x, "a":
    {"b": y}}``, or the keys ``1`` and ``"1"`` side by side)."""
    if isinstance(tree, dict):
        return {k: _split(v, f"{prefix}{k}/", tensors) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_split(v, f"{prefix}{i}/", tensors) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    key = prefix[:-1]
    if isinstance(tree, torch.Tensor):
        kind, tensor = "tensor", tree.detach()
    elif isinstance(tree, np.ndarray) and tree.dtype.kind in "biuf":
        kind, tensor = "numpy", torch.from_numpy(np.ascontiguousarray(tree))
    else:
        return _Leaf(("value", tree))
    if key in tensors:
        raise ValueError(f"two leaves of the tree save under the key {key!r}")
    tensors[key] = tensor
    return _Leaf((kind, key))


def _join(structure: Any, tensors: Dict[str, torch.Tensor]) -> Any:
    if isinstance(structure, _Leaf):
        kind, payload = structure
        if kind == "tensor":
            return tensors[payload]
        if kind == "numpy":
            return tensors[payload].numpy()
        return payload
    if isinstance(structure, dict):
        return {k: _join(v, tensors) for k, v in structure.items()}
    if isinstance(structure, (list, tuple)):
        items = [_join(v, tensors) for v in structure]
        if hasattr(structure, "_fields"):
            return type(structure)(*items)
        return type(structure)(items)
    return structure


@contextlib.contextmanager
def _one_process():
    """DCP runs in one process when no process group is up, and says so in
    a warning at every call: this is that mode on purpose."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        yield


def _write(directory: Path, tree: Any) -> None:
    """DCP shards + the structure file into a fresh ``directory``."""
    import torch.distributed.checkpoint as dcp

    from agilerl_tpu_torch.resilience.atomic import atomic_pickle

    tensors: Dict[str, torch.Tensor] = {}
    structure = _split(tree, "", tensors)
    directory.mkdir(parents=True)
    if tensors:
        with _one_process():
            dcp.save(tensors, checkpoint_id=str(directory))
    atomic_pickle(directory / _STRUCTURE, structure)


def save_pytree(
    path: Union[str, Path],
    tree: Any,
    step: Optional[int] = None,
    keep_last: Optional[int] = None,
) -> None:
    """Save a tree of tensors (and numpy arrays and plain values) with DCP.

    With ``step``, the checkpoint is staged under ``step_N.tmp`` and
    atomically published as ``step_N`` (the resilience commit protocol), then
    older step dirs beyond ``keep_last`` are pruned. Without it, ``path``
    itself is staged and committed (an existing checkpoint there is
    replaced whole)."""
    from agilerl_tpu_torch.resilience.atomic import commit_dir

    path = Path(path).absolute()
    final = path if step is None else path / f"{_STEP_PREFIX}{step}"
    tmp = final.with_name(final.name + _TMP)
    if tmp.exists():
        shutil.rmtree(tmp)
    _write(tmp, tree)
    commit_dir(tmp, final)
    if step is not None and keep_last is not None:
        retain_step_dirs(path, keep_last)


def _like_devices(like: Any) -> Dict[str, torch.device]:
    tensors: Dict[str, torch.Tensor] = {}
    _split(like, "", tensors)
    return {k: t.device for k, t in tensors.items()}


def load_pytree(path: Union[str, Path], like: Any = None, step: Optional[int] = None) -> Any:
    """Restore a tree that :func:`save_pytree` wrote (from ``step_N`` when
    ``step`` is given). Without ``like`` the tensors come back on the CPU;
    with it, each on the device of ``like``'s leaf at the same place (the
    saved dtypes are kept, so a restore is bit-equal)."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    path = Path(path).absolute()
    target = path if step is None else path / f"{_STEP_PREFIX}{step}"
    with open(target / _STRUCTURE, "rb") as f:
        structure = pickle.load(f)
    tensors: Dict[str, torch.Tensor] = {}
    saved: Dict[str, Tuple[torch.Size, torch.dtype]] = {}
    if (target / ".metadata").exists():
        meta = FileSystemReader(str(target)).read_metadata().state_dict_metadata
        saved = {k: (m.size, m.properties.dtype) for k, m in meta.items()}
    devices = _like_devices(like) if like is not None else {}
    missing = sorted(set(devices) - set(saved))
    if missing:
        raise KeyError(f"{target}: the checkpoint has no tensor at {missing[:5]} of `like`")
    for key, (size, dtype) in saved.items():
        tensors[key] = torch.empty(size, dtype=dtype, device=devices.get(key, "cpu"))
    if tensors:
        with _one_process():
            dcp.load(tensors, checkpoint_id=str(target))
    return _join(structure, tensors)


def save_llm_checkpoint(agent, path: Union[str, Path], include_base: bool = False) -> None:
    """LLM checkpoint = adapters (+ optionally the base weights) + training
    attributes. Adapters only is the default, as the reference saves only the
    LoRA adapters (PEFT's ``save_pretrained``)."""
    from agilerl_tpu_torch.resilience.atomic import atomic_pickle

    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    save_pytree(path / "actor_adapter", agent.actor.params)
    save_pytree(path / "reference_adapter", agent.reference.params)
    if include_base:
        save_pytree(path / "base_params", agent.base_params)
    attrs = {
        "model_config": agent.model_config,
        "init_dict": {k: v for k, v in agent.init_dict.items() if k != "base_params"},
        "fitness": agent.fitness,
        "steps": agent.steps,
    }
    # atomic (tmp + fsync + replace): load_llm_checkpoint unpickles this file,
    # and a kill mid-dump must not leave a truncated pickle behind
    atomic_pickle(path / "attributes.pkl", attrs)


def load_llm_checkpoint(agent, path: Union[str, Path]) -> None:
    """Restore adapters (and the base, when saved) and the training
    attributes into an existing agent, each tensor onto the device of the
    agent's own (the reference requires re-instantiation for an LLM load;
    so does this)."""
    path = Path(path).absolute()
    agent.actor.params = load_pytree(path / "actor_adapter", agent.actor.params)
    agent.reference.params = load_pytree(path / "reference_adapter", agent.reference.params)
    if (path / "base_params").exists():
        agent.base_params = load_pytree(path / "base_params", agent.base_params)
    attrs_file = path / "attributes.pkl"
    if attrs_file.exists():
        with open(attrs_file, "rb") as f:
            attrs = pickle.load(f)
        agent.fitness = list(attrs.get("fitness", agent.fitness))
        agent.steps = list(attrs.get("steps", agent.steps))
    agent._clear_jit_cache()
