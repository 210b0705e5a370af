"""Crash-consistent stores for the serving fleet and the online flywheel:
the port of ``agilerl_tpu/resilience/``'s ``atomic.py``, ``store.py`` and
``membership.py`` (whole), and ``max_fitness``. The ``Resilience`` facade,
snapshots, process supervision, retry, fault injection and preemption are
not ported yet."""

from agilerl_tpu_torch.resilience.atomic import (
    CorruptSnapshotError,
    atomic_pickle,
    atomic_write_bytes,
    commit_dir,
    content_hash,
    set_fault_hook,
    staged_pickle,
    staged_write_bytes,
)
from agilerl_tpu_torch.resilience.facade import max_fitness
from agilerl_tpu_torch.resilience.membership import (
    HeartbeatStore,
    MembershipChange,
    MembershipEvent,
    pid_alive,
)
from agilerl_tpu_torch.resilience.store import (
    CommitDirStore,
    committed_entries,
    gc_entries,
    publish_entry,
    read_entry,
    read_manifest,
)

__all__ = [
    "max_fitness",
    "HeartbeatStore", "MembershipChange", "MembershipEvent", "pid_alive",
    "CorruptSnapshotError", "set_fault_hook",
    "atomic_write_bytes", "atomic_pickle", "commit_dir", "content_hash",
    "staged_write_bytes", "staged_pickle",
    "CommitDirStore", "publish_entry", "read_entry", "read_manifest",
    "committed_entries", "gc_entries",
]
