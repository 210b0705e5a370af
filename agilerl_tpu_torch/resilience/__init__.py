"""Resilience of the port: crash-consistent whole-run snapshots,
preemption-aware checkpointing, retry policies for flaky host edges, a
deterministic fault-injection harness, and the crash-consistent stores of
the serving fleet and the online flywheel. The port of
``agilerl_tpu/resilience/``'s ``atomic.py``, ``store.py``,
``membership.py``, ``retry.py``, ``preemption.py``, ``faults.py``,
``snapshot.py``, ``facade.py`` and ``proc.py`` (each whole; ``snapshot.py``
with the torch rules in its docstring, ``proc.py`` with children that install
their guard before importing torch)."""

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
from agilerl_tpu_torch.resilience.facade import Resilience, max_fitness
from agilerl_tpu_torch.resilience.faults import (
    FaultInjector,
    InjectedCrash,
    ScheduledFailureEnv,
)
from agilerl_tpu_torch.resilience.membership import (
    HeartbeatStore,
    MembershipChange,
    MembershipEvent,
    pid_alive,
)
from agilerl_tpu_torch.resilience.preemption import PreemptionGuard
from agilerl_tpu_torch.resilience.proc import (
    ProcessSupervisor,
    RoleContext,
    RoleSpec,
    SupervisedProcess,
    read_statuses,
    resolve_target,
    run_role,
)
from agilerl_tpu_torch.resilience.retry import (
    DEFAULT_ENV_POLICY,
    RetryingEnv,
    RetryPolicy,
    call_with_retries,
    with_retries,
)
from agilerl_tpu_torch.resilience.snapshot import (
    AsyncPytree,
    CheckpointManager,
    SnapshotInfo,
    base_fingerprint,
    capture_agent,
    capture_env_rng,
    capture_host_rng,
    restore_agent,
    restore_env_rng,
    restore_host_rng,
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
    "Resilience", "max_fitness",
    "AsyncPytree", "CheckpointManager", "SnapshotInfo", "base_fingerprint",
    "PreemptionGuard",
    "RoleSpec", "RoleContext", "SupervisedProcess", "ProcessSupervisor",
    "resolve_target", "read_statuses", "run_role",
    "RetryPolicy", "RetryingEnv", "call_with_retries", "with_retries",
    "DEFAULT_ENV_POLICY",
    "FaultInjector", "InjectedCrash", "ScheduledFailureEnv",
    "HeartbeatStore", "MembershipChange", "MembershipEvent", "pid_alive",
    "CorruptSnapshotError", "set_fault_hook",
    "atomic_write_bytes", "atomic_pickle", "commit_dir", "content_hash",
    "staged_write_bytes", "staged_pickle",
    "CommitDirStore", "publish_entry", "read_entry", "read_manifest",
    "committed_entries", "gc_entries",
    "capture_agent", "restore_agent",
    "capture_host_rng", "restore_host_rng",
    "capture_env_rng", "restore_env_rng",
]
