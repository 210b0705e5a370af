"""Parity of the port's ``MakeEvolvable`` (agilerl_tpu_torch.wrappers
.make_evolvable) and the item-9 host helpers (``utils/algo_utils.py``, the
rest of ``utils/utils.py``) with the JAX package's on the CPU: the same
``torch.nn`` MLP and CNN reflected by both packages give outputs within
1e-5 of each other and of the module (f32), one architecture mutation keeps
the preserved slabs in both, and the helpers return what the JAX ones
return on the same arrays and spaces."""

import warnings

import numpy as np
import pytest
import torch
import torch.nn as nn

from agilerl_tpu_torch.modules.cnn import EvolvableCNN
from agilerl_tpu_torch.modules.mlp import EvolvableMLP
from agilerl_tpu_torch.utils import algo_utils as TA
from agilerl_tpu_torch.utils import utils as TU
from agilerl_tpu_torch.wrappers import MakeEvolvable

torch.set_num_threads(1)
jax = pytest.importorskip("jax")

ATOL = 1e-5


def _jax_make(net, x):
    from agilerl_tpu.wrappers import MakeEvolvable as JMake

    return JMake(network=net, input_tensor=x, key=jax.random.PRNGKey(0))


def _mlp():
    torch.manual_seed(0)
    net = nn.Sequential(nn.Linear(6, 24), nn.LayerNorm(24), nn.Tanh(), nn.Linear(24, 16),
                        nn.LayerNorm(16), nn.Tanh(), nn.Linear(16, 3), nn.Tanh())
    return net, torch.randn(5, 6)


def _cnn():
    torch.manual_seed(2)
    net = nn.Sequential(nn.Conv2d(3, 8, kernel_size=3, stride=2), nn.ReLU(),
                        nn.Conv2d(8, 16, kernel_size=3, stride=1), nn.ReLU(),
                        nn.Flatten(), nn.Linear(16 * 5 * 5, 4))
    return net, torch.randn(2, 3, 15, 15)


@pytest.mark.parametrize("kind", ["mlp", "cnn"])
def test_reflected_module_matches_the_module_and_the_jax_clone(kind):
    net, x = _mlp() if kind == "mlp" else _cnn()
    with torch.no_grad():
        want = net(x).numpy()
    module = MakeEvolvable(network=net, input_tensor=x, device="cpu")
    jmodule = _jax_make(net, x)
    assert isinstance(module, EvolvableMLP if kind == "mlp" else EvolvableCNN)
    assert type(module).__name__ == type(jmodule).__name__
    assert module.config.activation == jmodule.config.activation
    assert module.config.output_activation == jmodule.config.output_activation
    # the CNNs of both packages take NHWC
    xin = x if kind == "mlp" else x.permute(0, 2, 3, 1).contiguous()
    got = module(xin).detach().numpy()
    jgot = np.asarray(jmodule(xin.numpy()))
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, jgot, atol=ATOL)
    # the weights equal the JAX clone's
    flat = _flat_torch(module.params)
    jflat = _flat_jax(jmodule.params)
    assert sorted(flat) == sorted(jflat)
    for k in flat:
        np.testing.assert_allclose(flat[k], jflat[k], atol=0, rtol=0, err_msg=k)


def _flat_torch(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() for p, v in _flat_torch(t, f"{prefix}/{k}").items()}
    return {prefix: tree.detach().numpy()}


def _flat_jax(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items() for p, v in _flat_jax(t, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(tree)}


def test_an_architecture_mutation_keeps_the_preserved_slabs():
    """add_node on the first hidden layer (+16 nodes) in both packages: the
    reflected weights stay in the leading slab of every grown leaf, and the
    slabs of both packages are equal."""
    net, x = _mlp()
    module = MakeEvolvable(network=net, input_tensor=x, device="cpu")
    jmodule = _jax_make(net, x)
    before = _flat_torch(module.params)
    module.add_node(hidden_layer=0, numb_new_nodes=16)
    jmodule.add_node(hidden_layer=0, numb_new_nodes=16)
    assert module.config.hidden_size == jmodule.config.hidden_size == (40, 16)
    after, jafter = _flat_torch(module.params), _flat_jax(jmodule.params)
    for k, old in before.items():
        slab = tuple(slice(0, n) for n in old.shape)
        np.testing.assert_array_equal(after[k][slab], old, err_msg=k)
        np.testing.assert_array_equal(after[k][slab], jafter[k][slab], err_msg=k)
    assert module(x).shape == (5, 3)


def test_refusals_and_the_description_path_match_jax():
    from agilerl_tpu.wrappers import MakeEvolvable as JMake

    cases = [
        (nn.Sequential(nn.Linear(4, 8), nn.BatchNorm1d(8), nn.Linear(8, 2)),
         torch.randn(2, 4), "cannot reflect"),
        (nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 8), nn.Tanh(),
                       nn.Linear(8, 2)), torch.randn(2, 4), "single hidden activation"),
        (nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.LayerNorm(8), nn.Linear(8, 2)),
         torch.randn(2, 4), "directly after a Linear"),
        (nn.Sequential(nn.Conv2d(3, 4, 3, dilation=2), nn.ReLU(), nn.Flatten(),
                       nn.Linear(4 * 7 * 7, 2)), torch.randn(1, 3, 11, 11), "dilation"),
    ]
    for net, x, match in cases:
        with pytest.raises(ValueError, match=match):
            MakeEvolvable(network=net, input_tensor=x, device="cpu")
        with pytest.raises(ValueError, match=match):
            JMake(network=net, input_tensor=x, key=jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="input_tensor"):
        MakeEvolvable(network=nn.Linear(4, 2), device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        mlp = MakeEvolvable(num_inputs=4, num_outputs=2, hidden_layers=(8,), device="cpu")
        jmlp = JMake(num_inputs=4, num_outputs=2, hidden_layers=(8,),
                     key=jax.random.PRNGKey(0))
        cnn = MakeEvolvable(input_shape=(9, 9, 3), num_outputs=2, channels=(4,), device="cpu")
        jcnn = JMake(input_shape=(9, 9, 3), num_outputs=2, channels=(4,),
                     key=jax.random.PRNGKey(0))
    assert mlp.config.hidden_size == jmlp.config.hidden_size == (8,)
    assert cnn.config.channel_size == jcnn.config.channel_size
    assert cnn.config.kernel_size == jcnn.config.kernel_size


# --------------------------------------------------------------------------- #
# item 9's helpers
# --------------------------------------------------------------------------- #


def test_algo_utils_match_jax():
    from agilerl_tpu.utils import algo_utils as JA

    assert ([f.name for f in TA.GenerationConfig.__dataclass_fields__.values()]
            == [f.name for f in JA.GenerationConfig.__dataclass_fields__.values()])
    assert TA.GenerationConfig() .__dict__ == JA.GenerationConfig().__dict__
    nested = {"a": 1, "b": {"c": {"d": 2}}, "e": [{"f": 3}]}
    for key in ("a", "c", "d", "f", "z"):
        assert TA.key_in_nested_dict(nested, key) == JA.key_in_nested_dict(nested, key)
    chkpt = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "step": 7, "name": "x",
             "hist": [np.float32(1.5), np.array([1, 2], np.int64)],
             "t": torch.ones(2, dtype=torch.float64)}
    got = TA.chkpt_attribute_to_device(chkpt, device="cpu")
    want = JA.chkpt_attribute_to_device({k: v for k, v in chkpt.items() if k != "t"})
    assert got["step"] == want["step"] == 7 and got["name"] == want["name"] == "x"
    for g, w in ((got["w"], want["w"]), (got["hist"][0], want["hist"][0]),
                 (got["hist"][1], want["hist"][1])):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got["t"].dtype == torch.float64


def test_utils_helpers_match_jax():
    from gymnasium import spaces as gs

    from agilerl_tpu.utils import utils as JU
    from agilerl_tpu_torch.utils import spaces as TS

    names = ["DQN", "PPO", "Rainbow DQN", "RainbowDQN", "DDPG", "TD3", "CQN", "NeuralUCB",
             "NeuralTS", "MADDPG", "MATD3", "IPPO", "GRPO", "DPO"]
    assert ([TU.get_algo_class(n).__name__ for n in names]
            == [JU.get_algo_class(n).__name__ for n in names])
    for get in (TU.get_algo_class, JU.get_algo_class):
        with pytest.raises(KeyError, match="Unknown algorithm"):
            get("SAC")

    img = gs.Box(low=np.zeros((6, 5, 3), np.float32), high=np.full((6, 5, 3), 255.0, np.float32))
    for space in (img, gs.Dict({"im": img, "v": gs.Box(-1, 1, (4,))}),
                  gs.Tuple((img, gs.Discrete(3))), gs.Discrete(3)):
        got = TU.observation_space_channels_to_first(space)
        want = JU.observation_space_channels_to_first(space)
        assert repr(got) == repr(want)
    # the port's own spaces keep their classes
    own = TS.Dict({"im": TS.Box(np.zeros((6, 5, 3)), np.ones((6, 5, 3))), "d": TS.Discrete(2)})
    moved = TU.observation_space_channels_to_first(own)
    assert isinstance(moved, TS.Dict) and moved.spaces["im"].shape == (3, 6, 5)
    assert isinstance(moved.spaces["d"], TS.Discrete)

    rng = np.random.default_rng(0)
    rewards = rng.normal(size=(4, 12))
    terms = (rng.random((4, 12)) < 0.2).astype(np.float32)
    terms[2] = 0
    for inc in (False, True):
        for first in (False, True):
            assert (TU.calculate_vectorized_scores(rewards, terms, inc, first)
                    == JU.calculate_vectorized_scores(rewards, terms, inc, first))

    class Agent:
        def __init__(self, i):
            self.index, self.fitness = i, [float(i), float(i) + 1]

    fig, jfig = TU.plot_population_score([Agent(0), Agent(1)]), JU.plot_population_score(
        [Agent(0), Agent(1)])
    assert (fig is None) == (jfig is None)
    if fig is not None:
        assert len(fig.axes[0].lines) == len(jfig.axes[0].lines) == 2
    assert list(TU.default_progress_bar(3)) == list(JU.default_progress_bar(3)) == [0, 1, 2]

    envs = [TU.make_skill_vect_envs("CartPole-v1", lambda env: env, num_envs=1),
            JU.make_skill_vect_envs("CartPole-v1", lambda env: env, num_envs=1)]
    try:
        obs = [e.reset(seed=0)[0] for e in envs]
        np.testing.assert_array_equal(obs[0], obs[1])
    finally:
        for e in envs:
            e.close()
