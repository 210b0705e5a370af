"""Parity of the port's resilience stores (agilerl_tpu_torch.resilience:
atomic.py, store.py, membership.py and max_fitness) with the JAX package's,
on the CPU: the same directory operations give the same fault-hook op
sequences, hashes, committed entries, GC choices, torn-entry skips and lease
events. Each test imports the JAX module it mirrors inside the test."""

import json
import os

import numpy as np
import pytest

from agilerl_tpu_torch import resilience as TR
from agilerl_tpu_torch.observability import MemorySink, MetricsRegistry


def _jax_resilience():
    pytest.importorskip("jax")
    from agilerl_tpu import resilience as JR
    from agilerl_tpu.observability import MemorySink as JSink, MetricsRegistry as JRegistry

    return JR, JSink, JRegistry


def _atomic_ops(R, root):
    """Atomic writes, pickles, a staged directory commit over an existing
    one, and the stale-tmp sweep, recording every fault-hook op."""
    ops = []
    prev = R.set_fault_hook(lambda op, path: ops.append((op, path.relative_to(root).as_posix())))
    try:
        sha = R.atomic_write_bytes(root / "a.bin", b"hello")
        psha, size = R.atomic_pickle(root / "b.pkl", {"x": [1, 2, 3]})
        for content in (b"one", b"two"):
            stage = root / "snap.tmp"
            stage.mkdir()
            R.staged_write_bytes(stage / "f.bin", content)
            R.staged_pickle(stage / "g.pkl", content)
            R.commit_dir(stage, root / "snap")
    finally:
        R.set_fault_hook(prev)
    (root / "crash.tmp").mkdir()
    removed = R.atomic.remove_stale_tmp_dirs(root)
    data = R.atomic.read_validated(root / "snap" / "f.bin", R.content_hash(b"two"))
    with pytest.raises(R.CorruptSnapshotError, match="hash mismatch"):
        R.atomic.read_validated(root / "a.bin", R.content_hash(b"other"))
    (root / "torn.pkl").write_bytes(b"\x80\x05garbage")
    with pytest.raises(R.CorruptSnapshotError, match="unpicklable"):
        R.atomic.load_validated_pickle(root / "torn.pkl")
    return dict(ops=ops, sha=sha, psha=psha, size=size, removed=removed, data=data,
                listing=sorted(p.name for p in root.iterdir()))


def test_atomic_writes_and_fault_hooks_match_jax(tmp_path):
    JR, _, _ = _jax_resilience()
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    t = _atomic_ops(TR, tmp_path / "t")
    j = _atomic_ops(JR, tmp_path / "j")
    assert t == j
    assert [op for op, _ in t["ops"]][:2] == ["write", "wrote"] and "commit" in dict(t["ops"])


def _store_ops(R, Sink, Registry, root):
    """CommitDirStore publish with last-K GC, a stray digitless dir, a torn
    payload, a torn manifest, a vanished entry; read everything back."""
    sink = Sink()
    reg = Registry(sink=sink)
    store = R.CommitDirStore(root, prefix="e_", keep_last=3, metrics=reg)
    (root / "e_stray").mkdir()
    (root / "e_00000099.123.tmp").mkdir()  # an in-flight staging dir
    paths = [store.publish(f"e_{i:08d}", {"i": i, "arr": np.arange(i)},
                           manifest_extra={"i": i}) for i in range(6)]
    names = [p.name for p in store.entries()]
    (paths[3] / "payload.pkl").write_bytes(b"truncated")
    (paths[4] / "manifest.json").write_text("{not json")
    loads = []
    for p in store.entries():
        v = store.load(p)
        loads.append(None if v is None else (v["i"], v["arr"].tolist()))
    vanished = store.load(root / "e_00000777")
    out = dict(
        names=names, loads=loads, vanished=vanished,
        manifest=R.read_manifest(paths[5]) | {"payload_sha": None},
        seqs=[R.store.entry_seq(n) for n in ("epoch_00000007", "batch_003_00000012", "junk")],
        gc=R.gc_entries(root, "e_", keep_last=1),
        after=[p.name for p in R.committed_entries(root, "e_")],
        torn=reg.counter("resilience/torn_entries_total").value,
        warnings=sorted(e["key"] for e in sink.events if e["kind"] == "warning"),
    )
    store.consume(paths[5])
    out["consumed"] = [p.name for p in store.entries()]
    return out


def test_commit_dir_store_publish_gc_and_torn_skips_match_jax(tmp_path):
    JR, JSink, JRegistry = _jax_resilience()
    with pytest.warns(RuntimeWarning):
        t = _store_ops(TR, MemorySink, MetricsRegistry, tmp_path / "t")
    with pytest.warns(RuntimeWarning):
        j = _store_ops(JR, JSink, JRegistry, tmp_path / "j")
    assert t == j
    assert t["names"] == [f"e_{i:08d}" for i in (3, 4, 5)] + ["e_stray"]
    assert t["loads"] == [None, None, (5, [0, 1, 2, 3, 4]), None]
    assert t["torn"] == 3 and t["vanished"] is None
    assert t["after"] == ["e_00000005", "e_stray"]


class FakeClock:
    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _lease_ops(R, Sink, Registry, root):
    """Beats, a lease aging out, a tombstone, a rejoin with a new
    incarnation, a crashed local writer caught by the pid probe, a torn
    lease, and the join barrier's deadline, on a fake clock."""
    clock = FakeClock()
    sink = Sink()
    hb = R.HeartbeatStore(root, lease_timeout=5.0, registry=Registry(sink=sink), clock=clock)
    events = []

    def poll():
        ev = hb.poll()
        events.append(None if ev is None else
                      (ev.alive, ev.lost, ev.joined, ev.leader, dict(ev.meta)))

    for h in range(3):
        hb.beat(h, meta={"role": "decode" if h else "prefill", "replica": h})
    hb.expect([0, 1, 2])
    poll()
    clock.t += 4.0
    hb.beat(0, meta={"role": "prefill", "replica": 0})
    hb.beat(2, meta={"role": "decode", "replica": 2})
    clock.t += 2.0  # host 1 is 6 s old: expired
    poll()
    hb.mark_dead(2)
    poll()
    hb.beat(1, incarnation=1, meta={"role": "decode", "replica": 1})
    poll()
    hb.beat(3, pid=2 ** 22 + 12345)  # a crashed writer on this node
    (root / "host_0009.json").write_text("{torn")
    poll()
    roles = hb.roles()
    with pytest.raises(R.MembershipChange, match="timed out"):
        hb.wait_for(5, timeout=0.0, interval=0.0)
    counters = {k: v for k, v in hb.registry.snapshot().items()}
    membership = [{k: v for k, v in e.items() if k not in ("seq", "ts")}
                  for e in sink.events if e["kind"] == "membership"]
    return dict(events=events, roles=roles, leader=hb.leader(), counters=counters,
                membership=membership, leases=sorted(hb.leases()))


def test_heartbeat_leases_with_a_fake_clock_match_jax(tmp_path):
    JR, JSink, JRegistry = _jax_resilience()
    assert not TR.pid_alive(2 ** 22 + 12345) and TR.pid_alive(os.getpid())
    t = _lease_ops(TR, MemorySink, MetricsRegistry, tmp_path / "t")
    j = _lease_ops(JR, JSink, JRegistry, tmp_path / "j")
    assert json.dumps(t, sort_keys=True, default=str) == json.dumps(j, sort_keys=True, default=str)
    assert t["events"][0] is None and t["events"][1][1] == (1,)
    assert t["roles"] == {0: "prefill", 1: "decode"}


@pytest.mark.parametrize("values", [[0.1, 0.9, 0.5], [], [float("nan"), float("inf")],
                                    np.asarray([3.0, float("nan"), -1.0])])
def test_max_fitness_matches_jax(values):
    JR, _, _ = _jax_resilience()
    assert TR.max_fitness(values) == JR.max_fitness(values)
