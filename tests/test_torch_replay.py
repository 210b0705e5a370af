"""Parity of the port's replay buffers (agilerl_tpu_torch.components) with
the JAX package's ``components/replay_buffer.py``, ``segment_tree.py`` and
``sampler.py`` on the CPU: the ring with wrap-around, the staged flush
against per-step adds, n-step folds (chunked and per-step) on transitions
with boundaries, the paired rings' alignment, PER sampling on the JAX
package's draws and its priority update, the segment trees, the sampler
and state_dict round trips."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.components import replay_buffer as JRB  # noqa: E402
from agilerl_tpu.components import segment_tree as JST  # noqa: E402
from agilerl_tpu.components.sampler import Sampler as JSampler  # noqa: E402
from agilerl_tpu_torch.components import replay_buffer as RB  # noqa: E402
from agilerl_tpu_torch.components import segment_tree as ST  # noqa: E402
from agilerl_tpu_torch.components.sampler import Sampler  # noqa: E402

torch.set_num_threads(1)


def _transitions(n_steps, num_envs=3, obs_dim=4, seed=0, boundary=True):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        tr = {"obs": rng.normal(size=(num_envs, obs_dim)).astype(np.float32),
              "action": rng.integers(0, 2, size=(num_envs,)),
              "reward": rng.normal(size=(num_envs,)).astype(np.float32),
              "next_obs": rng.normal(size=(num_envs, obs_dim)).astype(np.float32),
              "done": (rng.random(num_envs) < 0.2).astype(np.float32)}
        if boundary:
            tr["_boundary"] = np.maximum(tr["done"],
                                         (rng.random(num_envs) < 0.15).astype(np.float32))
        out.append(tr)
    return out


def _plain(steps):
    return [{k: v for k, v in tr.items() if k != "_boundary"} for tr in steps]


def _assert_storage_equal(tstate, jstate, exact=True):
    """The port's ring (storage dict of tensors) against the JAX one."""
    jstore = jax.tree_util.tree_map(np.asarray, jstate.storage)
    assert set(tstate.storage) == set(jstore)
    for k, want in jstore.items():
        got = tstate.storage[k].numpy()
        assert got.dtype == want.dtype, k
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=k)
    assert tstate.pos == int(jstate.pos) and tstate.size == int(jstate.size)


@pytest.mark.parametrize("mode", ["add", "stage"])
def test_wrap_around_add_matches_jax(mode):
    """37 steps x 3 envs (plus unbatched rows) through a 16-slot ring: the
    same storage, dtypes and cursors as the JAX ring, by add and by stage."""
    steps = _plain(_transitions(37))
    jbuf = JRB.ReplayBuffer(max_size=16, seed=1)
    tbuf = RB.ReplayBuffer(max_size=16, seed=1, device="cpu", flush_every=5)
    for i, tr in enumerate(steps):
        jbuf.add(tr, batched=True)
        getattr(tbuf, mode)(tr, batched=True)
        if i % 11 == 10:
            one = {k: v[0] for k, v in tr.items()}
            jbuf.add(one)
            getattr(tbuf, mode)(one)
    tbuf.flush()
    assert len(tbuf) == len(jbuf) == 16 and tbuf.is_full
    _assert_storage_equal(tbuf.state, jbuf.state)


def test_staged_flush_equals_per_step_adds():
    """Staged flushes (every 5 steps, plus explicit flushes, one chunk longer
    than the ring) equal per-step adds bit for bit, for the uniform and the
    PER ring."""
    steps = _plain(_transitions(37))
    for cls in (RB.ReplayBuffer, RB.PrioritizedReplayBuffer):
        eager = cls(16, device="cpu", seed=1)
        staged = cls(16, device="cpu", seed=1, flush_every=5)
        for i, tr in enumerate(steps):
            eager.add(tr, batched=True)
            staged.stage(tr, batched=True)
            if i % 13 == 12:
                staged.flush()
        staged.flush()
        a = eager.state if cls is RB.ReplayBuffer else eager.per_state.buffer
        b = staged.state if cls is RB.ReplayBuffer else staged.per_state.buffer
        assert len(eager) == len(staged) == 16 and (a.pos, a.size) == (b.pos, b.size)
        for k in a.storage:
            assert torch.equal(a.storage[k], b.storage[k]), k
    big = {k: np.concatenate([tr[k] for tr in steps[:8]]) for k in steps[0]}  # 24 rows
    ring = RB.ReplayBuffer(16, device="cpu")
    jring = JRB.ReplayBuffer(16)
    ring.add(big, batched=True)
    jring.add(big, batched=True)
    _assert_storage_equal(ring.state, jring.state)


@pytest.mark.parametrize("mode", ["add", "stage"])
def test_n_step_folds_match_jax(mode):
    """3-step folds over 29 steps x 3 envs with termination and truncation
    boundaries, across flush boundaries and ring wrap-around: the folded
    ring and the raw rows handed to the main ring equal the JAX package's
    (per-step ``add`` against its ``add``, chunked ``stage`` against its
    ``stage``), and the two port paths equal each other."""
    steps = _transitions(29, seed=3)
    jn = JRB.MultiStepReplayBuffer(32, n_step=3, gamma=0.9, flush_every=4)
    tn = RB.MultiStepReplayBuffer(32, n_step=3, gamma=0.9, device="cpu", flush_every=4)
    jraw, traw = [], []
    for i, tr in enumerate(steps):
        if mode == "add":
            jraw.append(jn.add(tr, batched=True))
            traw.append(tn.add(tr, batched=True))
        else:
            jn.stage(tr, batched=True)
            tn.stage(tr, batched=True)
            if i == 13:
                jn.reset_horizon()
                tn.reset_horizon()
    if mode == "stage":
        jraw, traw = [jn.take_raw()], [tn.take_raw()]
    jraw = [r for r in jraw if r is not None]
    traw = [r for r in traw if r is not None]
    assert len(jraw) == len(traw) > 0
    for j, t in zip(jraw, traw):
        for k in j:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    _assert_storage_equal(tn.state, jn.state)
    if mode == "stage":
        eager = RB.MultiStepReplayBuffer(32, n_step=3, gamma=0.9, device="cpu")
        for tr in steps[:14]:
            eager.add(tr, batched=True)
        eager.reset_horizon()
        for tr in steps[14:]:
            eager.add(tr, batched=True)
        for k in eager.state.storage:
            assert torch.equal(eager.state.storage[k], tn.state.storage[k]), k


def test_paired_rings_stay_index_aligned():
    """Staged n-step folds drained into a PER main ring: at every index the
    main ring holds the raw step that the n-step ring's fold starts from
    (same obs and action), across a wrap-around, as in the JAX package."""
    steps = _transitions(23, seed=5)
    main = RB.PrioritizedReplayBuffer(24, device="cpu", flush_every=3)
    nst = RB.MultiStepReplayBuffer(24, n_step=3, gamma=0.99, device="cpu", flush_every=3)
    jmain = JRB.PrioritizedReplayBuffer(24, flush_every=3)
    jnst = JRB.MultiStepReplayBuffer(24, n_step=3, gamma=0.99, flush_every=3)
    for tr in steps:
        nst.stage(tr, batched=True)
        jnst.stage(tr, batched=True)
    RB.drain_staging(main, nst)
    JRB.drain_staging(jmain, jnst)
    assert len(main) == len(nst) == len(jmain) == 24
    for k in ("obs", "action"):
        assert torch.equal(main.per_state.buffer.storage[k], nst.state.storage[k]), k
    _assert_storage_equal(main.per_state.buffer, jmain.per_state.buffer)
    _assert_storage_equal(nst.state, jnst.state)
    idx = torch.tensor([0, 5, 23, 5])
    a, b = main.sample_from_indices(idx), nst.sample_from_indices(idx)
    assert torch.equal(a["obs"], b["obs"])


def _per_pair(n_rows=40, cap=64, seed=0):
    """A JAX and a port PER buffer with the same rows and priorities."""
    rng = np.random.default_rng(seed)
    jbuf = JRB.PrioritizedReplayBuffer(cap, alpha=0.6)
    tbuf = RB.PrioritizedReplayBuffer(cap, alpha=0.6, device="cpu")
    for tr in _plain(_transitions(n_rows // 4, num_envs=4, seed=seed)):
        jbuf.add(tr, batched=True)
        tbuf.add(tr, batched=True)
    idx = rng.permutation(n_rows)[:24]
    pri = rng.uniform(0.0, 3.0, size=24).astype(np.float32)
    pri[:2] = 0.0  # floored at 1e-5
    jbuf.update_priorities(jnp.asarray(idx), jnp.asarray(pri))
    tbuf.update_priorities(idx, pri)
    return jbuf, tbuf


def test_per_update_matches_jax():
    """The alpha-powered, floored priorities and the running max priority
    equal the JAX package's; later rows are added at the new max."""
    jbuf, tbuf = _per_pair()
    np.testing.assert_allclose(tbuf.per_state.priorities.numpy(),
                               np.asarray(jbuf.per_state.priorities), rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(tbuf.per_state.max_priority),
                               float(jbuf.per_state.max_priority), rtol=1e-6)
    tr = {k: v[:2] for k, v in _plain(_transitions(1, num_envs=2, seed=9))[0].items()}
    jbuf.add(tr, batched=True)
    tbuf.add(tr, batched=True)
    np.testing.assert_allclose(tbuf.per_state.priorities.numpy(),
                               np.asarray(jbuf.per_state.priorities), rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_per_sample_on_jax_draws(seed):
    """On the uniforms the JAX package draws from its key, the port's
    ``_per_sample`` picks exactly the JAX indices, with the JAX importance
    weights (atol 1e-6) and the same rows."""
    jbuf, tbuf = _per_pair(seed=seed)
    key = jax.random.PRNGKey(seed)
    jbatch, jidx, jw = jbuf.sample(64, beta=0.4, key=key)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (64,))))
    batch, idx, w = RB._per_sample(tbuf.per_state, u, 0.4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=0)
    for k in jbatch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]), err_msg=k)
    # the port's own draws: indices of valid rows, weights in (0, 1]
    _, idx, w = tbuf.sample(32, beta=0.4, key=torch.Generator().manual_seed(seed))
    assert int(idx.max()) < len(tbuf) and float(w.max()) <= 1.0 + 1e-6 and float(w.min()) > 0


def test_segment_trees_and_sampler_match_jax():
    """Sum / min trees (sums, minima, prefix-sum descent) equal the JAX
    ones; the sampler returns the same paired structure, on the same
    indices for both rings."""
    rng = np.random.default_rng(0)
    vals = rng.uniform(0, 2, size=16)
    for tcls, jcls in ((ST.SumSegmentTree, JST.SumSegmentTree),
                       (ST.MinSegmentTree, JST.MinSegmentTree)):
        t, j = tcls(16), jcls(16)
        t[np.arange(16)] = vals
        j[np.arange(16)] = vals
        t[[3, 7]] = [0.5, 0.25]
        j[[3, 7]] = [0.5, 0.25]
        np.testing.assert_array_equal(t.tree, j.tree)
        for lo, hi in ((0, 16), (2, 9), (5, 6)):
            assert t.reduce(lo, hi) == j.reduce(lo, hi)
    s, js = ST.SumSegmentTree(16), JST.SumSegmentTree(16)
    s[np.arange(16)] = vals
    js[np.arange(16)] = vals
    for ub in rng.uniform(0, vals.sum(), size=20):
        assert s.retrieve(ub) == js.retrieve(ub)

    steps = _transitions(10, seed=2)
    main = RB.PrioritizedReplayBuffer(32, device="cpu")
    nst = RB.MultiStepReplayBuffer(32, n_step=3, device="cpu")
    jmain = JRB.PrioritizedReplayBuffer(32)
    jnst = JRB.MultiStepReplayBuffer(32, n_step=3)
    for tr in steps:
        nst.stage(tr, batched=True)
        jnst.stage(tr, batched=True)
    out = Sampler(memory=main, per=True, n_step_memory=nst).sample(8, beta=0.5)
    jout = JSampler(memory=jmain, per=True, n_step_memory=jnst).sample(8, beta=0.5)
    assert len(out) == len(jout) == 4 and len(main) == len(jmain) == 24
    assert torch.equal(out[0]["obs"], out[3]["obs"]) and out[2].shape == (8,)
    uni = Sampler(memory=RB.ReplayBuffer(32, device="cpu"), n_step_memory=nst)
    uni.memory.add(nst.sample_from_indices(torch.arange(24)), batched=True)
    batch, idx, w, nb = uni.sample(8, key=torch.Generator().manual_seed(0))
    assert torch.equal(batch["obs"], nb["obs"]) and torch.equal(w, torch.ones(8))


@pytest.mark.parametrize("kind", ["uniform", "n_step", "per"])
def test_state_dict_round_trip(kind):
    """A host-numpy capture restores the ring, the cursors, the n-step carry,
    the priorities and the sampling stream: the restored buffer samples and
    folds exactly as the original does."""
    steps = _transitions(14, seed=4)
    make = {"uniform": lambda: RB.ReplayBuffer(20, device="cpu", seed=3),
            "n_step": lambda: RB.MultiStepReplayBuffer(20, n_step=3, device="cpu", seed=3),
            "per": lambda: RB.PrioritizedReplayBuffer(20, device="cpu", seed=3)}[kind]
    a = make()
    for tr in steps[:10]:
        a.add(tr if kind == "n_step" else {k: v for k, v in tr.items() if k != "_boundary"},
              batched=True)
    if kind == "per":
        a.update_priorities(np.arange(6), np.linspace(0.1, 2.0, 6))
    sd = a.state_dict()
    assert all(isinstance(v, np.ndarray) for v in sd[
        "per_state" if kind == "per" else "state"]["storage"].values())
    b = make()
    b.load_state_dict(sd)
    if kind == "n_step":
        for tr in steps[10:]:
            ra, rb = a.add(tr, batched=True), b.add(tr, batched=True)
            assert all(torch.equal(ra[k], rb[k]) for k in ra)
    sa = a.sample(8) if kind != "per" else a.sample(8, beta=0.4)[0]
    sb = b.sample(8) if kind != "per" else b.sample(8, beta=0.4)[0]
    assert len(a) == len(b) and all(torch.equal(sa[k], sb[k]) for k in sa)
