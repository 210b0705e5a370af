"""The port's several-host helpers (``parallel/multihost.py``) on gloo ranks
on the CPU. The JAX package's ``tests/test_parallel/test_multihost.py`` is
marked slow; here two real processes join through ``init_multihost``, agree
on rank 0's seed, cross barriers and make identical tournament decisions
(``tests/torch_dist_cases.multihost_worker``), a timed barrier that a rank
enters late raises ``MembershipChange`` on the other (over
``tests/torch_dist_harness.RankPool``, which survives it), and a process
with no cluster stays single-process."""

import multiprocessing as mp
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from agilerl_tpu_torch.observability.registry import MetricsRegistry
from agilerl_tpu_torch.parallel import multihost
from agilerl_tpu_torch.resilience.membership import MembershipChange
from tests.torch_dist_harness import RankPool, free_port
from tests.torch_dist_cases import multihost_worker

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


def test_two_processes_agree_on_seed_barriers_and_tournament():
    """Two processes join one group: rank 0's proposal (1234) beats rank
    1's (999), both cross the barriers, both make the same tournament
    decisions (those of the port's ``TournamentSelection`` on the same seed
    in this process, whose numpy stream is the JAX package's), and the
    metric mean over hosts reporting 1.0 and 3.0 is 2.0."""
    from agilerl_tpu_torch.hpo.tournament import TournamentSelection

    ctx = mp.get_context("spawn")
    port = free_port()
    pipes = [ctx.Pipe() for _ in range(2)]
    procs = [ctx.Process(target=multihost_worker, args=(pid, 2, port, pipes[pid][1]), daemon=True)
             for pid in range(2)]
    for p in procs:
        p.start()
    try:
        outs = []
        for parent, _ in pipes:
            assert parent.poll(180), "a rank did not answer within 180 s"
            status, value = parent.recv()
            assert status == "ok", value
            outs.append(value)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert outs[0] == outs[1]
    assert outs[0]["world"] == 2 and outs[0]["seed"] == 1234 and outs[0]["agg"] == 2.0

    class Agent:
        def __init__(self, index, f):
            self.index, self.fitness = index, [f]

        def clone(self, index=None):
            return Agent(self.index if index is None else index, self.fitness[0])

    pop = [Agent(i, f) for i, f in enumerate([3.0, 1.0, 4.0, 1.5])]
    elite, new_pop = TournamentSelection(2, True, 4, 1, np.random.default_rng(1234)).select(pop)
    assert outs[0]["elite"] == elite.index == 2
    assert outs[0]["pop"] == [a.index for a in new_pop]


def test_late_rank_times_out_the_barrier_and_the_pool_survives(pool):
    """Rank 1 enters the barrier 2 s late: rank 0's barrier under a 0.5 s
    watchdog raises ``MembershipChange`` after ~0.5 s and counts one
    collective timeout; the abandoned barrier completes when rank 1 arrives,
    and both ranks go on to a barrier and an all-reduce, then to the next
    case."""
    res = pool.run("late_barrier", wait_s=0.5, late_s=2.0)
    assert "timed out after 0.5s" in res[0]["raised"]
    assert 0.5 <= res[0]["after_s"] < 2.0
    assert res[0]["timeouts"] == 1
    assert [r["sum"] for r in res] == [2.0, 2.0]
    again = pool.run("late_barrier", wait_s=30.0, late_s=0.0)
    assert again[0]["raised"] is None and again[0]["timeouts"] == 0


def test_call_with_collective_timeout_counts_a_closed_connection():
    """gloo reports a peer whose process died as an immediate RuntimeError
    (connection closed): counted as a collective timeout and raised as
    ``MembershipChange``; any other error passes through untouched, and a
    call that finishes returns its value."""
    reg = MetricsRegistry()

    def closed():
        raise RuntimeError("[gloo/transport/tcp/pair.cc:553] Connection closed by peer "
                           "[127.0.0.1]:61124")

    for timeout in (None, 5.0):
        with pytest.raises(MembershipChange, match="fitness"):
            multihost.call_with_collective_timeout(closed, timeout, name="fitness",
                                                   registry=reg)
    assert reg.counter("resilience/collective_timeouts_total").value == 2
    with pytest.raises(ValueError, match="shape"):
        multihost.call_with_collective_timeout(
            lambda: (_ for _ in ()).throw(ValueError("shape")), 5.0, registry=reg)
    assert multihost.call_with_collective_timeout(lambda: 7, 5.0, registry=reg) == 7
    assert reg.counter("resilience/collective_timeouts_total").value == 2


def test_single_process_init_is_a_no_op_and_a_bad_coordinator_raises(monkeypatch):
    """No arguments and no launcher environment: nothing is joined, and
    the single-process helpers return at once (``broadcast_seed`` its own
    seed, ``barrier`` nothing). An explicit coordinator that cannot be
    joined raises instead of falling back to one process."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    multihost.init_multihost()
    assert not dist.is_initialized()
    assert multihost.broadcast_seed(17) == 17
    multihost.barrier("alone", timeout=0.1)
    with pytest.raises(ValueError, match="host:port"):
        multihost.init_multihost("127.0.0.1", 2, 1)
    with pytest.raises(ValueError, match="num_processes"):
        multihost.init_multihost("127.0.0.1:1234")
    # rank 1 of 2 dials a port where no coordinator listens
    with pytest.raises(RuntimeError):  # torch.distributed.DistNetworkError
        multihost.init_multihost(f"127.0.0.1:{free_port()}", 2, 1, timeout=2.0)
    assert not dist.is_initialized()
    assert os.environ.get("RANK") is None
