"""Parity of the port's offline path (agilerl_tpu_torch: ``utils/minari_utils``,
``training/train_offline``) with the JAX package's on the CPU: the h5 and
Minari readers on the same files, ``collect_offline_dataset``'s stored
successors and termination flags, and one generation of ``train_offline``
with CQN against the JAX loop on one dataset and the same samples; then
the loop's checkpoints, resume and refusals."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
h5py = pytest.importorskip("h5py")
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.algorithms.cqn import CQN as JCQN  # noqa: E402
from agilerl_tpu.components.replay_buffer import ReplayBuffer as JReplayBuffer  # noqa: E402
from agilerl_tpu.envs import CartPole as JCartPole  # noqa: E402
from agilerl_tpu.envs.core import JaxVecEnv  # noqa: E402
from agilerl_tpu.training.train_offline import train_offline as j_train_offline  # noqa: E402
from agilerl_tpu.utils import minari_utils as JMU  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy  # noqa: E402
from agilerl_tpu_torch.algorithms.cqn import CQN  # noqa: E402
from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer  # noqa: E402
from agilerl_tpu_torch.envs.classic import CartPole  # noqa: E402
from agilerl_tpu_torch.envs.core import TorchVecEnv  # noqa: E402
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection  # noqa: E402
from agilerl_tpu_torch.training.train_offline import train_offline  # noqa: E402
from agilerl_tpu_torch.utils import minari_utils as MU  # noqa: E402
from agilerl_tpu_torch.utils.utils import create_population  # noqa: E402

torch.set_num_threads(1)

OBS = gspaces.Box(-np.inf, np.inf, (4,), np.float32)
ACT = gspaces.Discrete(2)
NET = {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)},
       "head_config": {"hidden_size": (16,)}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _dataset(steps=400, seed=0):
    return MU.collect_offline_dataset(CartPole(), steps=steps, seed=seed, num_envs=4,
                                      device="cpu")


def test_collect_offline_dataset_stores_true_successors():
    """Random CartPole rows on the device env, read back once as numpy:
    shapes and dtypes; each row's successor is the next vector step's obs
    of its env unless the episode ended there, and then it is the obs
    before the autoreset (a terminal one lies past CartPole's bounds);
    ``terminals`` flags termination only. With an agent and epsilon 0 the
    actions are its greedy actions."""
    ds = _dataset(steps=800)
    N = 4
    assert ds["observations"].shape == (800, 4) and ds["actions"].shape == (800,)
    assert ds["rewards"].dtype == np.float32 and ds["terminals"].dtype == np.float32
    obs, nxt, term = ds["observations"], ds["next_observations"], ds["terminals"]
    moved = ~np.all(nxt[:-N] == obs[N:], axis=1)
    out_of_bounds = (np.abs(nxt[:, 0]) > 2.4) | (np.abs(nxt[:, 2]) > 12 * 2 * np.pi / 360)
    assert term.sum() > 0 and np.array_equal(term.astype(bool), out_of_bounds)
    assert np.array_equal(moved, term[:-N].astype(bool))  # no truncation within 200 steps
    agent = CQN(OBS, ACT, net_config=NET, seed=0, device="cpu")
    ds = MU.collect_offline_dataset(CartPole(), agent=agent, steps=40, epsilon=0.0, seed=1,
                                    num_envs=4, device="cpu")
    greedy = agent.get_action(torch.from_numpy(ds["observations"]), training=False).numpy()
    np.testing.assert_array_equal(ds["actions"], greedy)


def test_h5_and_minari_readers_match_jax(tmp_path):
    """An h5 round trip (bit-equal), the successor rule of a file without
    next_observations, and a Minari-layout file read by both packages'
    readers (directly and through the dataset tree): the same arrays. A
    dataset id with no file raises; nothing is downloaded."""
    ds = _dataset()
    MU.save_h5_dataset(tmp_path / "d.h5", ds)
    back = MU.load_h5_dataset(tmp_path / "d.h5")
    jback = JMU.load_h5_dataset(tmp_path / "d.h5")
    for k in ds:
        np.testing.assert_array_equal(back[k], ds[k])
        np.testing.assert_array_equal(back[k], jback[k])
    MU.save_h5_dataset(tmp_path / "nonext.h5", {"observations": ds["observations"][:5]})
    np.testing.assert_array_equal(MU.load_h5_dataset(tmp_path / "nonext.h5")["next_observations"],
                                  JMU.load_h5_dataset(tmp_path / "nonext.h5")["next_observations"])

    rng = np.random.default_rng(0)
    path = tmp_path / "minari" / "cartpole-v0" / "data" / "main_data.hdf5"
    path.parent.mkdir(parents=True)
    with h5py.File(path, "w") as f:
        for ep, n in enumerate((5, 3, 7)):
            g = f.create_group(f"episode_{ep}")
            g["observations"] = rng.normal(size=(n + 1, 4)).astype(np.float32)
            g["actions"] = rng.integers(0, 2, n)
            g["rewards"] = np.ones(n)
            g["terminations"] = np.eye(n)[-1]
    got = MU.minari_to_agile_dataset("cartpole-v0", data_dir=tmp_path / "minari")
    want = JMU.minari_to_agile_dataset("cartpole-v0", data_dir=tmp_path / "minari")
    direct = MU.read_minari_h5(path)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        np.testing.assert_array_equal(direct[k], np.asarray(want[k]))
    memory = MU.minari_to_agile_buffer(str(path), ReplayBuffer(64, device="cpu"))
    assert len(memory) == 15
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        MU.minari_to_agile_dataset("not-a-dataset", data_dir=tmp_path)


class _JaxDrawnBuffer(ReplayBuffer):
    """A port buffer whose uniform draws replay a JAX buffer's (its key,
    split as the JAX ``sample`` splits it)."""

    def __init__(self, max_size, seed):
        super().__init__(max_size, device="cpu")
        self._jkey = jax.random.PRNGKey(seed)

    def sample(self, batch_size, key=None, draws=None):
        self._jkey, k = jax.random.split(self._jkey)
        idx = np.array(jax.random.randint(k, (batch_size,), 0, max(len(self), 1)))
        return super().sample(batch_size, draws=torch.from_numpy(idx))


def test_train_offline_matches_the_jax_loop():
    """One generation of two CQN agents (double DQN + the conservative
    penalty), 30 learns each on the same dataset and the same samples: every
    weight of both agents atol 1e-5, and the same steps and buffer fill."""
    ds = _dataset()
    args = dict(net_config=NET, lr=1e-3, gamma=0.99, tau=0.01, double=True, batch_size=32,
                learn_step=1)
    jpop = [JCQN(OBS, ACT, index=i, seed=i, **args) for i in range(2)]
    tpop = [CQN(OBS, ACT, index=i, seed=i, device="cpu", **args) for i in range(2)]
    for j, t in zip(jpop, tpop):
        load_params_from_numpy(t, {n: _np(getattr(j, n).params) for n in ("actor", "actor_target")})
    jmem, tmem = JReplayBuffer(1000, seed=7), _JaxDrawnBuffer(1000, seed=7)
    jpop, _ = j_train_offline(JaxVecEnv(JCartPole(), num_envs=2), "CartPole-v1", ds, "CQN",
                              jpop, jmem, max_steps=30, evo_steps=30, eval_steps=5,
                              verbose=False)
    tpop, tfit = train_offline(TorchVecEnv(CartPole(), num_envs=2, device="cpu"), "CartPole-v1",
                               ds, "CQN", tpop, tmem, max_steps=30, evo_steps=30, eval_steps=5,
                               verbose=False)
    assert len(tmem) == len(jmem) == 400 and np.isfinite(tfit).all()
    for j, t in zip(jpop, tpop):
        assert t.steps == j.steps == [30, 30]
        for name in ("actor", "actor_target"):
            want = _flat(_np(getattr(j, name).params))
            got = _flat(getattr(t, name).params)
            for p, w in want.items():
                np.testing.assert_allclose(got[p], w, atol=1e-5, rtol=0, err_msg=f"{name}{p}")


def test_train_offline_checkpoints_resume_and_refusals(tmp_path):
    """Two generations with tournament + mutation and a checkpoint each
    generation, save_elite, then resume from the checkpoint (the buffer
    keeps its rows: no second ingest); resilience= runs (a cadence snapshot
    that holds the buffer) and wb= runs (wandb does not import here: the
    loop logs to its sink only, as the JAX loop does)."""
    ds = _dataset(steps=200)
    env = TorchVecEnv(CartPole(), num_envs=2, device="cpu")
    hp = {"POP_SIZE": 2, "BATCH_SIZE": 16, "LEARN_STEP": 1, "DOUBLE": True}
    pop = create_population("CQN", env.observation_space, env.action_space, NET, hp, seed=0,
                            device="cpu")
    memory = ReplayBuffer(1000, device="cpu")
    ckpt = str(tmp_path / "ckpt" / "pop")
    pop, fit = train_offline(env, "CartPole-v1", ds, "CQN", pop, memory, max_steps=20,
                             evo_steps=10, eval_steps=5, checkpoint=10, checkpoint_path=ckpt,
                             save_elite=True, elite_path=str(tmp_path),
                             tournament=TournamentSelection(2, True, 2, 1),
                             mutation=Mutations(activation=0, rand_seed=0), verbose=False)
    assert np.shape(fit) == (2, 2) and len(memory) == 200
    assert (tmp_path / "CQN_elite.ckpt").exists()
    saved = sorted((tmp_path / "ckpt").iterdir())
    assert saved, "no checkpoint written"
    fresh = create_population("CQN", env.observation_space, env.action_space, NET, hp, seed=1,
                              device="cpu")
    fresh, _ = train_offline(env, "CartPole-v1", ds, "CQN", fresh, memory, max_steps=30,
                             evo_steps=10, eval_steps=5, resume=True, checkpoint_path=ckpt,
                             verbose=False)
    assert len(memory) == 200 and fresh[0].steps[-1] >= 30
    from agilerl_tpu_torch.resilience import Resilience

    for hook in (dict(resilience=Resilience(tmp_path / "snap", save_every=1,
                                            handle_signals=False)), dict(wb=True)):
        _, fits = train_offline(env, "CartPole-v1", ds, "CQN", pop, memory, max_steps=40,
                                evo_steps=10, eval_steps=5, verbose=False, **hook)
        assert np.shape(fits)[0] == 2 and np.isfinite(np.asarray(fits)).all()
        if "wb" in hook:
            continue
        snaps = hook["resilience"].manager.snapshots()
        assert snaps and {s.kind for s in snaps} == {"cadence"}
        assert hook["resilience"].manager.load()[1]["buffers"]["memory"]["size_host"] == 200
