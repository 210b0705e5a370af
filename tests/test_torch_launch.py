"""The port's multi-process pod launcher (agilerl_tpu_torch.training.launch)
with the GRPO flywheel on the CPU, at tests/test_train/test_launch.py's tiny
config (2 layers, d_model 32, char vocab): launch_flywheel at staleness 0
equals the port's in-process OnlineGRPOFlywheel bit for bit (losses read
back from the weight-epoch manifests, the final adapter); kill -9 of the
learner warm-restarts it from the carried store state and continues the
exact stream; kill -9 of one of two rollouts recovers while both actors feed
one learner; and, across packages, the port's launch_flywheel(greedy=True) on
a JAX agent's weights carried through an .npz against the JAX in-process
flywheel on the same weights and rows: completions token for token, the
loss stream at test_torch_flywheel.py's learn tolerance (rtol 1e-5).

The children import their factories from tests/torch_launch_roles.py (no
jax) and end with no jax loaded. Every wait is on a state or a file, with a
generous deadline; no test depends on host speed."""

import json
import os
import signal
import time
from pathlib import Path

import numpy as np

from agilerl_tpu_torch.llm.flywheel import (
    LearnerPod,
    OnlineGRPOFlywheel,
    RolloutPod,
    TrajectoryStore,
    WeightStore,
)
from agilerl_tpu_torch.observability import MetricsRegistry
from agilerl_tpu_torch.training.launch import (
    CURSORS_DIR,
    WEIGHTS_DIR,
    PodLauncher,
    launch_flywheel,
    read_loss_stream,
)
from agilerl_tpu_torch.utils.tree import tree_leaves
from tests import torch_launch_roles as R

REPO_ROOT = str(Path(__file__).resolve().parents[1])
_ENV = {"PYTHONPATH": REPO_ROOT}
MAKE_AGENT = "tests.torch_launch_roles:make_agent"
MAKE_ENV = "tests.torch_launch_roles:make_env"
ROLES = "agilerl_tpu_torch.training.launch"
DEADLINE = 240.0  # seconds: each child imports torch; under 6 test workers, slowly


def _inprocess_reference(root, max_epochs, seed=0):
    """The in-process driver built the way the process split decomposes it:
    SEPARATE rollout / learner agent clones (same seed), so each pod's random
    stream matches its process counterpart draw for draw."""
    reg = MetricsRegistry()
    ws = WeightStore(root / "w", keep_last=max_epochs + 1, metrics=reg)
    ts = TrajectoryStore(root / "t", metrics=reg)
    learner = LearnerPod(R.make_agent(seed), ws, ts, max_staleness_epochs=0, metrics=reg,
                         carry_state=True)
    rollout = RolloutPod(R.make_agent(seed), R.make_env(), ws, ts, metrics=reg)
    OnlineGRPOFlywheel(rollout, learner, metrics=reg).run(max_epochs)
    return learner, ws


def _weights(root):
    return WeightStore(Path(root) / WEIGHTS_DIR, metrics=MetricsRegistry())


def _assert_adapters_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _wait_for(cond, what, launcher=None, timeout=DEADLINE):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        if launcher is not None:
            launcher.poll()
        time.sleep(0.05)


def test_launch_flywheel_matches_inprocess_driver_at_staleness_0(tmp_path):
    max_epochs = 3
    ref_learner, ref_ws = _inprocess_reference(tmp_path / "ref", max_epochs)
    root = tmp_path / "launch"
    summary = launch_flywheel(root, MAKE_AGENT, MAKE_ENV, max_epochs=max_epochs,
                              num_rollouts=1, max_staleness_epochs=0,
                              agent_kwargs={"seed": 0}, lease_timeout=10.0, grace_s=60.0,
                              timeout=DEADLINE, env=_ENV)
    assert summary["exits"] == {"learner": 0, "rollout_0": 0}, summary["statuses"]
    assert summary["orphans"] == []
    assert all(not s["jax_loaded"] and s["loaded_at_guard"] == []
               for s in summary["statuses"].values())
    # the loss stream (read back from the weight-epoch manifests) and the
    # final adapter, bit for bit across the process split
    assert summary["losses"] == ref_learner.losses and len(summary["losses"]) == max_epochs
    got_epoch, got_lora = _weights(root).load_latest()
    ref_epoch, ref_lora = ref_ws.load_latest()
    assert got_epoch == ref_epoch == max_epochs
    _assert_adapters_equal(got_lora, ref_lora)
    # the roles' telemetry reached the launcher: both pods' counters merged
    counters = summary["telemetry"]["counters"]
    assert counters["flywheel/learn_steps_total"] == max_epochs


def test_kill9_learner_warm_restarts_and_continues_exact_stream(tmp_path):
    max_epochs = 4
    ref_learner, ref_ws = _inprocess_reference(tmp_path / "ref", max_epochs)
    root = tmp_path / "launch"
    launcher = PodLauncher(root, lease_timeout=10.0, grace_s=60.0, registry=MetricsRegistry())
    launcher.add_role(
        "learner", "tests.torch_launch_roles:paused_learner_role",
        kwargs={"make_agent": MAKE_AGENT, "agent_kwargs": {"seed": 0},
                "max_epochs": max_epochs, "max_staleness_epochs": 0,
                "keep_last": max_epochs + 1, "pause_at": 2},
        env=_ENV, poll_interval=0.01)
    launcher.add_role(
        "rollout_0", f"{ROLES}:rollout_role",
        kwargs={"make_agent": MAKE_AGENT, "agent_kwargs": {"seed": 0}, "make_env": MAKE_ENV,
                "actor_id": 0, "max_seqs": max_epochs, "max_staleness_epochs": 0,
                "lockstep": True, "keep_last": max_epochs + 1},
        env=_ENV, poll_interval=0.01)
    launcher.start(join_timeout=DEADLINE)
    ws = _weights(root)
    # the first incarnation pauses once it has published epoch 2
    _wait_for(lambda: (ws.latest_epoch() or 0) >= 2, "epoch 2", launcher)
    victim = launcher.supervisor.procs["learner"]
    assert victim.alive
    os.kill(victim.pid, signal.SIGKILL)
    restarted = []
    _wait_for(lambda: restarted.extend(
        e for e in launcher.poll() if e["role"] == "learner" and e["action"] == "restarted")
        or restarted, "the learner's respawn")
    assert launcher.supervisor.procs["learner"].spec.incarnation == 1
    summary = launcher.run(timeout=DEADLINE)
    assert summary["statuses"]["learner"]["state"] == "done", summary
    assert summary["statuses"]["learner"]["incarnation"] == 1
    assert summary["orphans"] == []
    # the respawn restored the carried state and continued the EXACT stream
    assert read_loss_stream(root) == ref_learner.losses
    got_epoch, got_lora = ws.load_latest()
    ref_epoch, ref_lora = ref_ws.load_latest()
    assert got_epoch == ref_epoch == max_epochs
    _assert_adapters_equal(got_lora, ref_lora)


def _cursor_seq(root, actor):
    path = Path(root) / CURSORS_DIR / f"actor_{actor:03d}.json"
    return json.loads(path.read_text())["seq"] if path.exists() else 0


def test_kill9_rollout_recovers_and_two_actors_feed_one_learner(tmp_path):
    """Actor 1 publishes only 3 batches and the learner needs 12: the run
    completes only if actor 0 keeps publishing after its kill -9 and
    respawn, continuing its seq line from its cursor."""
    max_epochs = 12
    root = tmp_path / "launch"
    launcher = PodLauncher(root, lease_timeout=10.0, grace_s=60.0, registry=MetricsRegistry())
    launcher.add_role(
        "learner", f"{ROLES}:learner_role",
        kwargs={"make_agent": MAKE_AGENT, "agent_kwargs": {"seed": 0},
                "max_epochs": max_epochs, "max_staleness_epochs": 2},
        env=_ENV, poll_interval=0.01)
    for i, seqs in enumerate((10_000, 3)):
        launcher.add_role(
            f"rollout_{i}", f"{ROLES}:rollout_role",
            kwargs={"make_agent": MAKE_AGENT, "agent_kwargs": {"seed": i},
                    "make_env": MAKE_ENV, "actor_id": i, "max_seqs": seqs,
                    "max_staleness_epochs": 2},
            replica=i, env=_ENV, poll_interval=0.01)
    launcher.start(join_timeout=DEADLINE)
    ws = _weights(root)
    _wait_for(lambda: (ws.latest_epoch() or 0) >= 1 and _cursor_seq(root, 0) >= 1,
              "progress before the kill", launcher)
    victim = launcher.supervisor.procs["rollout_0"]
    seq_at_kill = _cursor_seq(root, 0)
    os.kill(victim.pid, signal.SIGKILL)
    restarted = []
    _wait_for(lambda: restarted.extend(
        e for e in launcher.poll() if e["role"] == "rollout_0" and e["action"] == "restarted")
        or restarted, "rollout_0's respawn")
    # until the learner's process has exited (its status reads "done" a
    # moment before the interpreter is gone; a SIGTERM in that moment would
    # end it by the signal)
    summary = launcher.run(timeout=DEADLINE,
                           until=lambda: "learner" in launcher.supervisor.exits)
    assert summary["statuses"]["learner"]["state"] == "done", summary
    assert summary["orphans"] == [] and summary["escalated"] == []
    # learner and the small actor finished; the unbounded respawned actor was
    # drained by the launcher at the learner's completion
    assert summary["exits"]["learner"] == 0 and summary["exits"]["rollout_1"] == 0
    assert summary["exits"]["rollout_0"] == 3
    assert _cursor_seq(root, 0) > seq_at_kill and _cursor_seq(root, 1) > 0
    # both actors' batches were trained: the two seq lines overlap, so a
    # repeated seq in trained_seqs can only come from distinct actors
    state = ws.load_latest_payload()["learner_state"]
    assert len(state["trained_seqs"]) == max_epochs
    assert len(set(state["trained_seqs"])) < len(state["trained_seqs"])


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def test_greedy_launch_on_jax_weights_matches_the_jax_inprocess_flywheel(tmp_path):
    """The JAX agent's weights (base, actor and reference adapters) carried
    through an .npz into both port children; the port's greedy launch at
    staleness 0 against the JAX in-process flywheel on the same weights and
    rows: every rollout's completions token for token, the loss stream
    within rtol 1e-5 (f32 summation order, test_torch_flywheel.py's learn
    tolerance), and the final adapter within 5e-6."""
    import jax

    from agilerl_tpu.algorithms.grpo import GRPO as JGRPO
    from agilerl_tpu.llm import flywheel as JF, model as JM
    from agilerl_tpu.observability import MetricsRegistry as JRegistry
    from agilerl_tpu.utils.llm_utils import CharTokenizer as JTok, ReasoningGym as JGym

    max_epochs = 3
    jcfg = JM.GPTConfig(dtype=jax.numpy.float32, **R.MODEL)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    jagent = JGRPO(config=jcfg, seed=0, **R.AGENT)
    npz = tmp_path / "jax_agent.npz"
    np.savez(npz, **_flat(to_np(jagent.base_params), "base/"),
             **_flat(to_np(jagent.actor.params), "actor/"),
             **_flat(to_np(jagent.reference.params), "reference/"))

    jreg = JRegistry()
    jws = JF.WeightStore(tmp_path / "jw", keep_last=max_epochs + 1, metrics=jreg)
    jts = JF.TrajectoryStore(tmp_path / "jt", metrics=jreg)
    jlearner = JF.LearnerPod(jagent, jws, jts, max_staleness_epochs=0, metrics=jreg,
                             carry_state=True)
    jenv = R.make_env(record=tmp_path / "jax_steps", Gym=JGym, tok=JTok())
    jrollout = JF.RolloutPod(JGRPO(config=jcfg, seed=0, **R.AGENT), jenv, jws, jts,
                             metrics=jreg)
    JF.OnlineGRPOFlywheel(jrollout, jlearner, metrics=jreg).run(max_epochs, greedy=True)

    root = tmp_path / "launch"
    summary = launch_flywheel(root, MAKE_AGENT, MAKE_ENV, max_epochs=max_epochs,
                              agent_kwargs={"npz": str(npz)},
                              env_kwargs={"record": str(tmp_path / "port_steps")},
                              greedy=True, lease_timeout=10.0, grace_s=60.0,
                              timeout=DEADLINE, env=_ENV)
    assert summary["exits"] == {"learner": 0, "rollout_0": 0}, summary["statuses"]
    want = sorted((tmp_path / "jax_steps").glob("step_*.npy"))
    got = sorted((tmp_path / "port_steps").glob("step_*.npy"))
    assert len(got) == len(want) == max_epochs
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.load(g), np.load(w))
    np.testing.assert_allclose(summary["losses"], jlearner.losses, rtol=1e-5)
    _, got_lora = _weights(root).load_latest()
    _, want_lora = jws.load_latest()
    for g, w in zip(tree_leaves(got_lora), jax.tree_util.tree_leaves(want_lora)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=5e-6)
