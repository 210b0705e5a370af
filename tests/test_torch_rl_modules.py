"""Parity of the port's evolvable modules and networks
(agilerl_tpu_torch.modules.{base,mlp}, networks.{base,actors,value_networks})
with the JAX package's, on the CPU in f32: applies on carried weights, every
MLP and network mutation (the same configs and metadata from the same numpy
rng, preserved slabs bit-equal to the JAX package's, grown slabs by shape),
preserve_params on trees, and the weight loader."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.modules import base as JB  # noqa: E402
from agilerl_tpu.modules.mlp import EvolvableMLP as JMLP  # noqa: E402
from agilerl_tpu.networks.actors import StochasticActor as JActor  # noqa: E402
from agilerl_tpu.networks.value_networks import ValueNetwork as JValue  # noqa: E402
from agilerl_tpu_torch.llm.convert import f32_tree_from_numpy  # noqa: E402
from agilerl_tpu_torch.modules import base as TB  # noqa: E402
from agilerl_tpu_torch.modules.mlp import EvolvableMLP as TMLP  # noqa: E402
from agilerl_tpu_torch.modules.mlp import MLPConfig as TMLPConfig  # noqa: E402
from agilerl_tpu_torch.networks.actors import StochasticActor as TActor  # noqa: E402
from agilerl_tpu_torch.networks.base import NetworkConfig, params_from_numpy  # noqa: E402
from agilerl_tpu_torch.networks.value_networks import ValueNetwork as TValue  # noqa: E402
from agilerl_tpu_torch.utils import spaces as S  # noqa: E402

torch.set_num_threads(1)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _cfg(config):
    """A config as a plain dict (the packages' dataclasses are different types)."""
    return dataclasses.asdict(config)


def _assert_preserved(old, jnew, tnew):
    """Same paths and shapes; every slab that overlaps the old leaf equals
    the old weights bit for bit in both packages; a leaf of unchanged shape
    equals the old one whole."""
    old, jnew, tnew = _flat(old), _flat(jnew), _flat(tnew)
    assert jnew.keys() == tnew.keys()
    for path in jnew:
        assert jnew[path].shape == tnew[path].shape, path
        if path not in old or old[path].ndim != jnew[path].ndim:
            continue
        sl = tuple(slice(0, min(o, n)) for o, n in zip(old[path].shape, jnew[path].shape))
        np.testing.assert_array_equal(tnew[path][sl], old[path][sl], err_msg=str(path))
        np.testing.assert_array_equal(tnew[path][sl], jnew[path][sl], err_msg=str(path))


MLP_CASES = {
    "plain": dict(layer_norm=False),
    "layer_norm": dict(layer_norm=True),
    "output_layernorm": dict(layer_norm=True, output_layernorm=True, output_activation="Tanh"),
    "noisy": dict(noisy=True, layer_norm=False, activation="GELU"),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_apply_on_carried_weights(case):
    kw = dict(num_inputs=5, num_outputs=3, hidden_size=(16, 12), **MLP_CASES[case])
    jm = JMLP(key=jax.random.PRNGKey(1), **kw)
    tm = TMLP(config=TMLPConfig(**_cfg(jm.config)), device="cpu")
    tm.params = f32_tree_from_numpy(_np(jm.params), "cpu")
    x = np.random.default_rng(0).normal(size=(7, 5)).astype(np.float32)
    want = np.asarray(JMLP.apply(jm.config, jm.params, x))  # noisy: noise off
    got = TMLP.apply(tm.config, tm.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the port's own init has the JAX package's tree, shapes and constants
    fresh = TMLP(key=torch.Generator().manual_seed(0), device="cpu", **kw)
    jf, tf = _flat(_np(jm.params)), _flat(fresh.params)
    assert {p: v.shape for p, v in jf.items()} == {p: v.shape for p, v in tf.items()}
    for p in jf:
        if "norm" in "".join(map(str, p)) or "sigma" in p[-1]:
            np.testing.assert_array_equal(tf[p], jf[p], err_msg=str(p))


@pytest.mark.parametrize("method", ["add_layer", "remove_layer", "add_node", "remove_node"])
def test_mlp_mutations_match_jax(method):
    kw = dict(num_inputs=6, num_outputs=4, hidden_size=(80, 72), min_mlp_nodes=16,
              max_hidden_layers=3, min_hidden_layers=1)
    jm = JMLP(key=jax.random.PRNGKey(2), **kw)
    tm = TMLP(device="cpu", **kw)
    tm.params = f32_tree_from_numpy(_np(jm.params), "cpu")
    old = _np(jm.params)
    for step in range(2):
        jinfo = getattr(jm, method)(rng=np.random.default_rng(10 + step))
        tinfo = getattr(tm, method)(rng=np.random.default_rng(10 + step))
        assert tinfo == jinfo and _cfg(tm.config) == _cfg(jm.config)
        assert tm.last_mutation_attr == jm.last_mutation_attr == method
        _assert_preserved(old, _np(jm.params), tm.params)
        tm.params = f32_tree_from_numpy(_np(jm.params), "cpu")  # carry the grown slabs
        old = _np(jm.params)
    assert sorted(TMLP.get_mutation_methods()) == sorted(JMLP.get_mutation_methods())
    assert TMLP.layer_mutation_methods() == JMLP.layer_mutation_methods()


def test_preserve_params_on_trees():
    rng = np.random.default_rng(3)
    old = {"a": {"kernel": rng.normal(size=(4, 6)).astype(np.float32),
                 "bias": rng.normal(size=(6,)).astype(np.float32)},
           "b": [rng.normal(size=(3,)).astype(np.float32)],
           "gone": rng.normal(size=(2,)).astype(np.float32),
           "rank": rng.normal(size=(2, 2)).astype(np.float32)}
    new = {"a": {"kernel": rng.normal(size=(5, 3)).astype(np.float32),
                 "bias": rng.normal(size=(6,)).astype(np.float32)},
           "b": [rng.normal(size=(5,)).astype(np.float32)],
           "rank": rng.normal(size=(4,)).astype(np.float32),
           "fresh": rng.normal(size=(2,)).astype(np.float32)}
    want = _np(JB.preserve_params(jax.tree_util.tree_map(jnp.asarray, old),
                                  jax.tree_util.tree_map(jnp.asarray, new)))
    tt = lambda t: jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), t)  # noqa: E731
    got = TB.preserve_params(tt(old), tt(new))
    assert got["a"]["bias"] is not None and got.keys() == want.keys()
    for path, w in _flat({k: v for k, v in want.items() if k != "b"}).items():
        node = got
        for p in path:
            node = node[p]
        np.testing.assert_array_equal(node.numpy(), w, err_msg=str(path))
    np.testing.assert_array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))


def _nets(kind, action_space):
    obs_space = gspaces.Box(-1.0, 1.0, (5,), np.float32)
    kw = dict(latent_dim=16, encoder_config={"hidden_size": (32,), "min_mlp_nodes": 16},
              head_config={"hidden_size": (24,), "min_mlp_nodes": 16})
    if kind == "actor":
        jn = JActor(obs_space, action_space, key=jax.random.PRNGKey(4), **kw)
        tn = TActor(obs_space, action_space, device="cpu", **kw)
    else:
        jn = JValue(obs_space, key=jax.random.PRNGKey(4), **kw)
        tn = TValue(obs_space, device="cpu", **kw)
    assert _cfg(tn.config) == _cfg(jn.config)
    tn.params = params_from_numpy(_np(jn.params), tn.config, "cpu", extra=tn.extra_template())
    return obs_space, jn, tn


@pytest.mark.parametrize("kind,action", [("actor", "discrete"), ("actor", "box"),
                                         ("critic", None)])
def test_network_apply_and_every_mutation_match_jax(kind, action):
    action_space = {"discrete": gspaces.Discrete(3),
                    "box": gspaces.Box(-1.0, 1.0, (2,), np.float32), None: None}[action]
    _, jn, tn = _nets(kind, action_space)
    x = np.random.default_rng(5).normal(size=(6, 5)).astype(np.float32)
    np.testing.assert_allclose(tn(torch.from_numpy(x)).numpy() if kind == "critic"
                               else tn.logits(torch.from_numpy(x)).numpy(),
                               np.asarray(jn(x) if kind == "critic" else jn.logits(x)),
                               rtol=0, atol=1e-5)
    assert tn.mutation_methods() == jn.mutation_methods()
    for name in jn.mutation_methods():
        assert tn.mutation_method_kind(name) == jn.mutation_method_kind(name)
        for kind_ in ("layer", "node", None):
            assert tn.resolve_mutation_method(name, kind_) == jn.resolve_mutation_method(name, kind_)
    for seed in range(4):
        assert (tn.sample_mutation_method(0.5, np.random.default_rng(seed))
                == jn.sample_mutation_method(0.5, np.random.default_rng(seed)))
    # every method on the discrete actor; the latent and one encoder and one
    # head method on the others
    names = (jn.mutation_methods() if action == "discrete" else
             ["add_latent_node", "remove_latent_node", "encoder.add_node", "head.add_layer"])
    for i, name in enumerate(names):
        old = _np(jn.params)
        jinfo = jn.apply_mutation(name, rng=np.random.default_rng(i))
        tinfo = tn.apply_mutation(name, rng=np.random.default_rng(i))
        assert tinfo == jinfo and _cfg(tn.config) == _cfg(jn.config), name
        _assert_preserved(old, _np(jn.params), tn.params)
        tn.params = params_from_numpy(_np(jn.params), tn.config, "cpu",
                                      extra=tn.extra_template())
    tn.change_activation("GELU")
    jn.change_activation("GELU")
    assert _cfg(tn.config) == _cfg(jn.config)
    np.testing.assert_allclose(tn(torch.from_numpy(x)).numpy() if kind == "critic"
                               else tn.logits(torch.from_numpy(x)).numpy(),
                               np.asarray(jn(x) if kind == "critic" else jn.logits(x)),
                               rtol=0, atol=1e-5)


def test_params_from_numpy_checks_paths_and_shapes():
    _, jn, tn = _nets("actor", gspaces.Box(-1.0, 1.0, (2,), np.float32))
    tree = _np(jn.params)
    bad = dict(tree, head=dict(tree["head"], output={"kernel": tree["head"]["output"]["kernel"]}))
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(bad, tn.config, "cpu", extra=tn.extra_template())
    bad = dict(tree, dist={"log_std": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, tn.config, "cpu", extra=tn.extra_template())
    with pytest.raises(ValueError, match="unknown"):
        params_from_numpy(tree, tn.config, "cpu")  # the actor's "dist" group is not in config
    assert isinstance(tn.config, NetworkConfig)


def test_clone_is_independent_and_unported_encoders_raise():
    _, _, tn = _nets("critic", None)
    c = tn.clone()
    c.apply_mutation("head.add_node", rng=np.random.default_rng(0))
    assert c.config != tn.config
    assert tn.params["head"]["layer_0"]["kernel"].shape[1] == 24
    # the other encoders are ported (Queue 1's slice 5b): each space builds its own
    for space, kw, kind in ((gspaces.Box(0.0, 1.0, (8, 8, 3), np.float32), {}, "cnn"),
                            (gspaces.Dict({"a": gspaces.Discrete(2)}), {}, "multi_input"),
                            (gspaces.Box(-1.0, 1.0, (3,), np.float32), {"recurrent": True},
                             "lstm"),
                            (S.Box(-1.0, 1.0, (3,), np.float32), {"simba": True}, "simba")):
        assert TValue(space, device="cpu", **kw).config.encoder_kind == kind


def test_own_spaces_match_gymnasium_helpers():
    from agilerl_tpu.utils import spaces as JS

    pairs = [(gspaces.Box(-1.0, 1.0, (2, 3), np.float32), S.Box(-1.0, 1.0, (2, 3), np.float32)),
             (gspaces.Box(0.0, 1.0, (1, 4, 4), np.float32), S.Box(0.0, 1.0, (1, 4, 4), np.float32)),
             (gspaces.Discrete(4), S.Discrete(4)),
             (gspaces.MultiDiscrete([2, 3]), S.MultiDiscrete([2, 3])),
             (gspaces.MultiBinary(3), S.MultiBinary(3))]
    gen = torch.Generator().manual_seed(0)
    for gs, ts in pairs:
        assert S.space_kind(gs) == S.space_kind(ts)
        assert JS.is_image_space(gs) == S.is_image_space(ts) == S.is_image_space(gs)
        assert JS.is_vector_space(gs) == S.is_vector_space(ts)
        if not JS.is_image_space(gs):
            assert JS.obs_dim(gs) == S.obs_dim(ts) == S.obs_dim(gs)
            assert JS.action_dim(gs) == S.action_dim(ts)
        obs = np.stack([np.asarray(gs.sample()) for _ in range(3)])
        want = np.asarray(JS.preprocess_observation(gs, obs))
        for space in (gs, ts):
            np.testing.assert_array_equal(S.preprocess_observation(space, obs).numpy(), want)
        sample = ts.sample(gen)
        assert gs.contains(np.asarray(sample, dtype=gs.dtype)), (ts, sample)
    d = S.Dict({"z": S.Discrete(2), "a": S.Box(0.0, 1.0, (2,), np.float32)})
    assert list(d.spaces) == list(gspaces.Dict({"z": gspaces.Discrete(2),
                                                "a": gspaces.Box(0.0, 1.0, (2,))}).spaces)


def test_yaml_config_loader_matches_jax():
    pytest.importorskip("yaml")
    from pathlib import Path

    from agilerl_tpu.modules import configs as JCF
    from agilerl_tpu_torch.modules import configs as TCF

    path = Path(__file__).resolve().parents[1] / "configs" / "training" / "ppo.yaml"
    assert TCF.load_yaml_config(path) == JCF.load_yaml_config(path)
    assert TCF.MlpNetConfig is TMLPConfig


def test_deterministic_actor_rescales_as_jax():
    from agilerl_tpu.networks.actors import DeterministicActor as JDet
    from agilerl_tpu_torch.networks.actors import DeterministicActor as TDet

    obs_space = gspaces.Box(-1.0, 1.0, (3,), np.float32)
    act_space = gspaces.Box(np.array([-2.0, 0.0], np.float32), np.array([2.0, 1.0], np.float32))
    kw = dict(latent_dim=8, encoder_config={"hidden_size": (16,)})
    jn = JDet(obs_space, act_space, key=jax.random.PRNGKey(0), **kw)
    tn = TDet(obs_space, act_space, device="cpu", **kw)
    assert _cfg(tn.config) == _cfg(jn.config) and tn.config.head.output_activation == "Tanh"
    tn.params = params_from_numpy(_np(jn.params), tn.config, "cpu")
    x = np.random.default_rng(1).normal(size=(9, 3)).astype(np.float32)
    got = tn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jn(x)), rtol=0, atol=1e-5)
    assert (got[:, 0] >= -2).all() and (got[:, 0] <= 2).all() and (got[:, 1] >= 0).all()
