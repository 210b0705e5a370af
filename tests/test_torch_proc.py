"""The port's process supervision (agilerl_tpu_torch.resilience.proc and the
launcher's PodLauncher) over real subprocesses, on the CPU: the cases of
tests/test_resilience/test_proc.py (the idle role runs to done; a crashed
role restarts with a bumped incarnation and the supervisor gives up after
max_restarts; a SIGTERM drain; kill -9 detected within a lease; concurrent
publish_entry racers), the spec and status files read by the JAX package's
RoleSpec.from_json / read_statuses and the other way round, and a port child
that ends with no jax loaded (its guard went in before torch).

Every wait is on a state or a file, with a generous deadline of its own;
no test depends on host speed. The children import their roles from
tests/torch_launch_roles.py, a module without jax. Each test imports the JAX
modules it compares with inside the test."""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from agilerl_tpu_torch.observability import MetricsRegistry, read_jsonl
from agilerl_tpu_torch.resilience import proc as P
from agilerl_tpu_torch.resilience.membership import pid_alive
from agilerl_tpu_torch.resilience.store import (
    CorruptSnapshotError,
    committed_entries,
    read_entry,
)
from agilerl_tpu_torch.training.launch import PodLauncher

REPO_ROOT = str(Path(__file__).resolve().parents[1])
_ENV = {"PYTHONPATH": REPO_ROOT}
ROLES = "tests.torch_launch_roles"
IDLE = "agilerl_tpu_torch.training.launch:idle_role"
DEADLINE = 120.0  # seconds: a child imports torch; under 6 test workers, slowly


def _spec(root, name, target, kwargs=None, **over):
    base = dict(name=name, target=target, root=str(root), member_id=0, kwargs=kwargs or {},
                lease_timeout=2.0, poll_interval=0.01, env=dict(_ENV))
    base.update(over)
    return P.RoleSpec(**base)


def _wait_for(cond, what, timeout=DEADLINE, poll=0.05):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(poll)


def test_role_harness_runs_idle_role_to_done_without_jax(tmp_path):
    sup = P.ProcessSupervisor(tmp_path, lease_timeout=2.0, registry=MetricsRegistry())
    sup.spawn(_spec(tmp_path, "idle", IDLE, kwargs={"max_ticks": 3}))
    assert sup.wait(timeout=DEADLINE)
    assert sup.exits == {"idle": P.EXIT_DONE}
    st = P.read_statuses(tmp_path)["idle"]
    assert st["state"] == "done" and st["ticks"] == 3
    # the child's guard went in before torch and the package, and the child
    # never loaded jax
    assert st["loaded_at_guard"] == [] and st["jax_loaded"] is False
    # graceful completion tombstones the lease
    assert sup.heartbeat.alive() == {}


def test_supervisor_restarts_crashed_role_with_bumped_incarnation(tmp_path):
    reg = MetricsRegistry()
    sup = P.ProcessSupervisor(tmp_path, lease_timeout=2.0, max_restarts=2, registry=reg)
    sup.spawn(_spec(tmp_path, "flaky", f"{ROLES}:flaky_role"))
    assert sup.wait(timeout=2 * DEADLINE)
    # crashed once (restart), then the incarnation-1 child completed
    assert sup.exits == {"flaky": P.EXIT_DONE}
    assert sup.restarts == {"flaky": 1}
    assert reg.counter("resilience/proc_restarts_total").value == 1
    st = P.read_statuses(tmp_path)["flaky"]
    assert st["state"] == "done" and st["incarnation"] == 1
    assert sorted(p.name for p in (tmp_path / P.SPECS_DIR).iterdir()) == [
        "flaky.000.json", "flaky.001.json"]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    sup = P.ProcessSupervisor(tmp_path, lease_timeout=2.0, max_restarts=1,
                              registry=MetricsRegistry())
    sup.spawn(_spec(tmp_path, "flaky", f"{ROLES}:always_crash_role"))
    assert sup.wait(timeout=2 * DEADLINE)
    assert sup.exits == {"flaky": P.EXIT_CRASH}
    assert sup.restarts == {"flaky": 1}
    st = P.read_statuses(tmp_path)["flaky"]
    assert st["state"] == "crashed" and "injected" in st["error"]


def test_launcher_sigterm_drains_fleet_real_subprocesses(tmp_path):
    """Forever-running roles, SIGTERM through the supervisor: every role
    exits through its PreemptionGuard (drain hook ran, JSONL events flushed,
    lease tombstoned, status committed), and nothing is left running."""
    launcher = PodLauncher(tmp_path, lease_timeout=2.0, grace_s=60.0,
                           registry=MetricsRegistry())
    for name in ("alpha", "beta"):
        launcher.add_role(name, IDLE, kwargs={"max_ticks": None}, poll_interval=0.02,
                          env=dict(_ENV))
    launcher.start(join_timeout=DEADLINE)
    pids = {n: p.pid for n, p in launcher.supervisor.procs.items()}
    summary = launcher.shutdown()
    assert summary["exits"] == {"alpha": P.EXIT_PREEMPTED, "beta": P.EXIT_PREEMPTED}
    assert summary["escalated"] == [] and summary["orphans"] == []
    for name in ("alpha", "beta"):
        st = summary["statuses"][name]
        assert st["state"] == "preempted" and st["jax_loaded"] is False
        drain = json.loads((tmp_path / f"drain_{name}.json").read_text())
        assert drain["ticks"] == st["ticks"]
        events = read_jsonl(tmp_path / "logs" / f"{name}.events.jsonl")
        assert any(e.get("kind") == "preemption" for e in events)
        assert not pid_alive(pids[name])
    assert launcher.heartbeat.alive() == {}


def test_launcher_kill9_detected_fast_and_restarted(tmp_path):
    """kill -9 a role: the same-host pid probe surfaces the loss on the next
    poll (lease 10,000 s: only the probe can see it) and the supervisor
    respawns it with a bumped incarnation."""
    launcher = PodLauncher(tmp_path, lease_timeout=10_000.0, grace_s=60.0,
                           registry=MetricsRegistry())
    launcher.add_role("victim", IDLE, kwargs={"max_ticks": None}, poll_interval=0.02,
                      env=dict(_ENV))
    launcher.start(join_timeout=DEADLINE)
    victim = launcher.supervisor.procs["victim"]
    os.kill(victim.pid, signal.SIGKILL)
    victim.popen.wait(timeout=DEADLINE)
    # membership sees the crash at once (pid probe, not lease expiry)
    assert launcher.heartbeat.alive() == {}
    events = launcher.poll()
    assert [e["action"] for e in events] == ["restarted"]
    new = launcher.supervisor.procs["victim"]
    assert new.pid != victim.pid and new.spec.incarnation == 1
    _wait_for(lambda: bool(launcher.heartbeat.alive()), "the respawn's lease")
    summary = launcher.shutdown()
    assert summary["exits"]["victim"] == P.EXIT_PREEMPTED
    assert summary["orphans"] == []
    assert summary["statuses"]["victim"]["incarnation"] == 1


N_RACE_ENTRIES = 24


def test_publish_entry_concurrent_multiprocess_racers(tmp_path):
    """Two processes publish the same entry names into one commit directory:
    every committed entry reads hash-valid or vanishes (never a persistently
    torn read), and each seq ends committed exactly once."""
    store_dir = tmp_path / "race"
    env = dict(os.environ, **_ENV)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import sys; from {ROLES} import race_writer; "
         f"race_writer(sys.argv[1], {w}, {N_RACE_ENTRIES})", str(store_dir)],
        env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for w in (1, 2)]
    torn = 0
    deadline = time.monotonic() + 2 * DEADLINE
    while any(p.poll() is None for p in procs):
        for entry in committed_entries(store_dir, "entry_"):
            payload = None
            for _ in range(5):  # retries absorb mid-swap transients
                try:
                    payload = read_entry(entry)
                    break
                except (CorruptSnapshotError, OSError):
                    time.sleep(0.005)
            if payload is None:
                if entry.exists():
                    torn += 1
            else:
                assert payload["writer"] in (1, 2)
        assert time.monotonic() < deadline, "racers wedged"
        time.sleep(0.01)
    outs = [p.stdout.read().decode() for p in procs]
    assert [p.wait() for p in procs] == [0, 0], outs
    assert all("WRITER_OK" in o for o in outs), outs
    assert torn == 0
    entries = committed_entries(store_dir, "entry_")
    assert len(entries) == N_RACE_ENTRIES
    seqs = [read_entry(e)["seq"] for e in entries]
    assert seqs == sorted(seqs) == list(range(N_RACE_ENTRIES))
    assert not list(store_dir.glob("*.tmp"))


def test_spec_and_status_files_cross_read_with_jax(tmp_path):
    """The port's spec and status files read through the JAX package's
    RoleSpec.from_json / read_statuses, and the JAX package's through the
    port's: the same store layout and fields."""
    pytest.importorskip("jax")
    from agilerl_tpu.resilience import proc as JP

    sup = P.ProcessSupervisor(tmp_path / "port", lease_timeout=2.0, registry=MetricsRegistry())
    spec = _spec(tmp_path / "port", "idle", IDLE, kwargs={"max_ticks": 2}, replica=3)
    sup.spawn(spec)
    assert sup.wait(timeout=DEADLINE)
    text = (tmp_path / "port" / P.SPECS_DIR / "idle.000.json").read_text()
    jspec = JP.RoleSpec.from_json(text)
    assert jspec == JP.RoleSpec(**json.loads(text))
    assert (jspec.name, jspec.target, jspec.kwargs, jspec.replica) == (
        "idle", IDLE, {"max_ticks": 2}, 3)
    port_view = P.read_statuses(tmp_path / "port")
    assert JP.read_statuses(tmp_path / "port") == port_view
    assert port_view["idle"]["state"] == "done" and port_view["idle"]["ticks"] == 2

    # the other way round: a JAX spec and a JAX status file (written by the
    # JAX harness's own writer, no child needed)
    jroot = tmp_path / "jax"
    jspec = JP.RoleSpec(name="learner", target="agilerl_tpu.training.launch:learner_role",
                        root=str(jroot), member_id=1, kwargs={"max_epochs": 4},
                        incarnation=2, env={"A": "1"})
    assert P.RoleSpec.from_json(jspec.to_json()) == P.RoleSpec(**json.loads(jspec.to_json()))
    (jroot / JP.STATUS_DIR).mkdir(parents=True)
    JP._write_status(jroot, jspec, "preempted", ticks=7)
    got = P.read_statuses(jroot)["learner"]
    assert got == JP.read_statuses(jroot)["learner"]
    assert (got["state"], got["ticks"], got["incarnation"]) == ("preempted", 7, 2)
    # the exit codes and the layout are the JAX harness's
    assert (P.EXIT_DONE, P.EXIT_CRASH, P.EXIT_PREEMPTED, P.EXIT_ESCALATED) == (
        JP.EXIT_DONE, JP.EXIT_CRASH, JP.EXIT_PREEMPTED, JP.EXIT_ESCALATED)
    assert (P.SPECS_DIR, P.STATUS_DIR, P.LOGS_DIR, P.MEMBERSHIP_DIR, P.TELEMETRY_DIR) == (
        JP.SPECS_DIR, JP.STATUS_DIR, JP.LOGS_DIR, JP.MEMBERSHIP_DIR, JP.TELEMETRY_DIR)


def test_resolve_target_refuses_a_target_without_a_function():
    with pytest.raises(ValueError, match="module:function"):
        P.resolve_target("no_colon")
    assert P.resolve_target(IDLE).__name__ == "idle_role"


def test_host_helpers_all_gather_over_a_gloo_group(tmp_path):
    """gather_across_hosts / aggregate_metrics_across_hosts: in one process
    the value itself (as the JAX helpers give it), across two gloo ranks on
    this host an all-gather stacked on a leading process axis and its mean."""
    import socket

    import numpy as np

    from agilerl_tpu_torch.utils.utils import aggregate_metrics_across_hosts, gather_across_hosts

    pytest.importorskip("jax")
    from agilerl_tpu.utils import utils as JU

    for value in (3.5, np.arange(4, dtype=np.float32)):
        np.testing.assert_array_equal(gather_across_hosts(value), JU.gather_across_hosts(value))
    assert aggregate_metrics_across_hosts(2.5) == JU.aggregate_metrics_across_hosts(2.5) == 2.5
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, **_ENV)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"from {ROLES} import gather_worker; "
         f"gather_worker({r}, 2, {port}, {str(tmp_path / f'r{r}.json')!r})"],
        env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in (0, 1)]
    outs = [p.communicate(timeout=DEADLINE)[0].decode() for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    for r in (0, 1):
        got = json.loads((tmp_path / f"r{r}.json").read_text())
        assert got == {"gathered": [[0, 0], [1, 10]], "mean": 1.5}
