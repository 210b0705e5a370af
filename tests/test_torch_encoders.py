"""Parity of the port's other encoders (agilerl_tpu_torch.modules.{cnn,
resnet, simba, lstm, multi_input, custom_components, dummy}) with the JAX
package's, on the CPU in f32: applies on carried weights (rtol 1e-5), every
mutation (the same configs and metadata from the same numpy rng, preserved
slabs bit-equal to the JAX package's, grown slabs by shape), the networks
built on each encoder through ``params_from_numpy``, and the protocols."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.modules import cnn as JCNN  # noqa: E402
from agilerl_tpu.modules import custom_components as JCC  # noqa: E402
from agilerl_tpu.modules import lstm as JLSTM  # noqa: E402
from agilerl_tpu.modules import multi_input as JMI  # noqa: E402
from agilerl_tpu.modules import resnet as JRES  # noqa: E402
from agilerl_tpu.modules import simba as JSIM  # noqa: E402
from agilerl_tpu.networks.value_networks import ValueNetwork as JValue  # noqa: E402
from agilerl_tpu_torch import protocols as P  # noqa: E402
from agilerl_tpu_torch.llm.convert import f32_tree_from_numpy  # noqa: E402
from agilerl_tpu_torch.modules import cnn as TCNN  # noqa: E402
from agilerl_tpu_torch.modules import custom_components as TCC  # noqa: E402
from agilerl_tpu_torch.modules import lstm as TLSTM  # noqa: E402
from agilerl_tpu_torch.modules import multi_input as TMI  # noqa: E402
from agilerl_tpu_torch.modules import resnet as TRES  # noqa: E402
from agilerl_tpu_torch.modules import simba as TSIM  # noqa: E402
from agilerl_tpu_torch.modules.configs import load_net_config  # noqa: E402
from agilerl_tpu_torch.modules.dummy import DummyEvolvable  # noqa: E402
from agilerl_tpu_torch.networks.base import params_from_numpy  # noqa: E402
from agilerl_tpu_torch.networks.value_networks import ValueNetwork as TValue  # noqa: E402

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
    return dataclasses.asdict(config)


def _japply(module, params, x, **kw):
    """A JAX module's apply under one jit (its config static)."""
    return jax.jit(lambda p, x: type(module).apply(module.config, p, x, **kw))(params, x)


def _assert_preserved(old, jnew, tnew):
    old, jnew, tnew = _flat(old), _flat(jnew), _flat(tnew)
    assert jnew.keys() == tnew.keys()
    for path in jnew:
        assert jnew[path].shape == tnew[path].shape, path
        if path not in old or old[path].ndim != jnew[path].ndim:
            continue
        sl = tuple(slice(0, min(o, n)) for o, n in zip(old[path].shape, jnew[path].shape))
        np.testing.assert_array_equal(tnew[path][sl], old[path][sl], err_msg=str(path))
        np.testing.assert_array_equal(tnew[path][sl], jnew[path][sl], err_msg=str(path))


IMG = np.random.default_rng(0).uniform(0, 1, (3, 12, 12, 3)).astype(np.float32)
IMG24 = np.random.default_rng(3).uniform(0, 1, (2, 24, 24, 3)).astype(np.float32)
VEC = np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32)

CASES = {
    "cnn": (JCNN.EvolvableCNN, TCNN.EvolvableCNN,
            dict(input_shape=(24, 24, 3), num_outputs=7, channel_size=(16, 24),
                 kernel_size=(3, 3), stride_size=(2, 1), min_channel_size=8), IMG24),
    "cnn_uint8": (JCNN.EvolvableCNN, TCNN.EvolvableCNN,
                  dict(input_shape=(12, 12, 3), num_outputs=5, channel_size=(16,),
                       kernel_size=(4,), stride_size=(2,), layer_norm=False,
                       activation="GELU", output_activation="Tanh"),
                  (IMG * 255).astype(np.uint8)),
    "resnet": (JRES.EvolvableResNet, TRES.EvolvableResNet,
               dict(input_shape=(12, 12, 3), num_outputs=6, channel_size=16, num_blocks=2,
                    min_channel_size=8), IMG),
    "simba": (JSIM.EvolvableSimBa, TSIM.EvolvableSimBa,
              dict(num_inputs=6, num_outputs=4, hidden_size=80, num_blocks=2, min_nodes=16),
              VEC),
    "lstm": (JLSTM.EvolvableLSTM, TLSTM.EvolvableLSTM,
             dict(num_inputs=6, num_outputs=4, hidden_size=40, num_layers=2), VEC),
}


def _pair(case, seed=0):
    jcls, tcls, kw, x = CASES[case]
    jm = jcls(key=jax.random.PRNGKey(seed), **kw)
    tm = tcls(config=tcls.Config(**_cfg(jm.config)), device="cpu")
    tm.params = f32_tree_from_numpy(_np(jm.params), "cpu")
    return jm, tm, x


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_apply_on_carried_weights(case):
    jm, tm, x = _pair(case)
    want = np.asarray(_japply(jm, jm.params, x))
    got = type(tm).apply(tm.config, tm.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # unbatched inputs give unbatched outputs (the images' squeeze)
    if case != "lstm":
        np.testing.assert_allclose(
            type(tm).apply(tm.config, tm.params, torch.from_numpy(x[0])).numpy(), got[0],
            rtol=1e-5, atol=1e-6)
    # the port's own init has the JAX package's tree and shapes
    fresh = type(tm)(config=tm.config, key=torch.Generator().manual_seed(0), device="cpu")
    assert ({p: v.shape for p, v in _flat(_np(jm.params)).items()}
            == {p: v.shape for p, v in _flat(fresh.params).items()})


def test_lstm_sequence_and_hidden_state_match_jax():
    jm, tm, _ = _pair("lstm")
    rng = np.random.default_rng(2)
    seq = rng.normal(size=(5, 3, 6)).astype(np.float32)
    hidden = {"h": rng.normal(size=(2, 3, 40)).astype(np.float32),
              "c": rng.normal(size=(2, 3, 40)).astype(np.float32)}
    for x, h in ((seq, hidden), (seq[0], hidden), (seq, None)):
        jout, jh = JLSTM.EvolvableLSTM.apply(jm.config, jm.params, x, hidden=h,
                                             return_hidden=True)
        tout, th = TLSTM.EvolvableLSTM.apply(
            tm.config, tm.params, torch.from_numpy(x),
            hidden=None if h is None else f32_tree_from_numpy(h, "cpu"), return_hidden=True)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
        for k in ("h", "c"):
            np.testing.assert_allclose(th[k].numpy(), np.asarray(jh[k]), rtol=1e-5, atol=1e-6)
    init = TLSTM.EvolvableLSTM.initial_hidden(tm.config, 3)
    assert init["h"].shape == (2, 3, 40) and not init["c"].any()


MUTATIONS = {
    "cnn": ["add_layer", "remove_layer", "add_channel", "remove_channel", "change_kernel"],
    "resnet": ["add_block", "remove_block", "add_channel", "remove_channel"],
    "simba": ["add_block", "remove_block", "add_node", "remove_node"],
    "lstm": ["add_layer", "remove_layer", "add_node", "remove_node"],
}


@pytest.mark.parametrize("case", sorted(MUTATIONS))
def test_every_mutation_matches_jax(case):
    jm, tm, x = _pair(case, seed=3)
    assert sorted(type(tm).get_mutation_methods()) == sorted(MUTATIONS[case])
    assert sorted(type(jm).get_mutation_methods()) == sorted(MUTATIONS[case])
    assert type(tm).layer_mutation_methods() == type(jm).layer_mutation_methods()
    for step, method in enumerate(MUTATIONS[case]):
        old = _np(jm.params)
        jinfo = getattr(jm, method)(rng=np.random.default_rng(10 + step))
        tinfo = getattr(tm, method)(rng=np.random.default_rng(10 + step))
        assert tinfo == jinfo and _cfg(tm.config) == _cfg(jm.config), method
        assert tm.last_mutation_attr == jm.last_mutation_attr == method
        _assert_preserved(old, _np(jm.params), tm.params)
        tm.params = f32_tree_from_numpy(_np(jm.params), "cpu")  # carry the grown slabs
    np.testing.assert_allclose(type(tm).apply(tm.config, tm.params, torch.from_numpy(x)).numpy(),
                               np.asarray(_japply(jm, jm.params, x)),
                               rtol=1e-5, atol=1e-6)


def _dict_space():
    return gspaces.Dict({"img": gspaces.Box(0.0, 1.0, (10, 10, 3), np.float32),
                         "tiny": gspaces.Box(0.0, 1.0, (3, 3, 2), np.float32),
                         "vec": gspaces.Box(-1.0, 1.0, (5,), np.float32),
                         "d": gspaces.Discrete(4)})


def _dict_obs(rng, n):
    return {"img": rng.uniform(0, 1, (n, 10, 10, 3)).astype(np.float32),
            "tiny": rng.uniform(0, 1, (n, 3, 3, 2)).astype(np.float32),
            "vec": rng.normal(size=(n, 5)).astype(np.float32),
            "d": np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]}


def test_multi_input_apply_and_mutations_match_jax():
    space = _dict_space()
    jm = JMI.EvolvableMultiInput(space, num_outputs=6, key=jax.random.PRNGKey(4), latent_dim=40)
    tm = TMI.EvolvableMultiInput(space, num_outputs=6, device="cpu", latent_dim=40)
    assert [(n, k, _cfg(c)) for n, k, c in tm.config.sub_configs] == \
        [(n, k, _cfg(c)) for n, k, c in jm.config.sub_configs]
    tm.params = f32_tree_from_numpy(_np(jm.params), "cpu")
    obs = _dict_obs(np.random.default_rng(5), 3)
    tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    np.testing.assert_allclose(TMI.EvolvableMultiInput.apply(tm.config, tm.params, tobs).numpy(),
                               np.asarray(_japply(jm, jm.params, obs)),
                               rtol=1e-5, atol=1e-6)
    methods = ["add_latent_node", "remove_latent_node", "add_sub_layer", "remove_sub_layer"]
    assert sorted(TMI.EvolvableMultiInput.get_mutation_methods()) == sorted(methods)
    for i, method in enumerate(methods):
        old = _np(jm.params)
        jinfo = getattr(jm, method)(rng=np.random.default_rng(20 + i))
        tinfo = getattr(tm, method)(rng=np.random.default_rng(20 + i))
        assert tinfo == jinfo, method
        assert [(n, k, _cfg(c)) for n, k, c in tm.config.sub_configs] == \
            [(n, k, _cfg(c)) for n, k, c in jm.config.sub_configs]
        assert tm.config.latent_dim == jm.config.latent_dim
        _assert_preserved(old, _np(jm.params), tm.params)
        tm.params = f32_tree_from_numpy(_np(jm.params), "cpu")
    np.testing.assert_allclose(TMI.EvolvableMultiInput.apply(tm.config, tm.params, tobs).numpy(),
                               np.asarray(_japply(jm, jm.params, obs)),
                               rtol=1e-5, atol=1e-6)


def test_custom_components_match_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 9)).astype(np.float32) * 3
    np.testing.assert_allclose(TCC.NewGELU(torch.from_numpy(x)).numpy(),
                               np.asarray(JCC.NewGELU(x)), rtol=1e-5, atol=1e-6)
    img = rng.normal(size=(2, 6, 6, 8)).astype(np.float32)
    jp = JCC.residual_block_init(jax.random.PRNGKey(0), 8)
    tp = TCC.residual_block_init(torch.Generator().manual_seed(0), 8)
    assert {p: v.shape for p, v in _flat(tp).items()} == \
        {p: v.shape for p, v in _flat(_np(jp)).items()}
    np.testing.assert_allclose(
        TCC.residual_block_apply(f32_tree_from_numpy(_np(jp), "cpu"), torch.from_numpy(img)).numpy(),
        np.asarray(JCC.residual_block_apply(jp, img)), rtol=1e-5, atol=1e-5)
    jp = JCC.simba_residual_block_init(jax.random.PRNGKey(1), 9, 3)
    tp = TCC.simba_residual_block_init(torch.Generator().manual_seed(0), 9, 3)
    assert {p: v.shape for p, v in _flat(tp).items()} == \
        {p: v.shape for p, v in _flat(_np(jp)).items()}
    np.testing.assert_allclose(
        TCC.simba_residual_block_apply(f32_tree_from_numpy(_np(jp), "cpu"),
                                       torch.from_numpy(x)).numpy(),
        np.asarray(JCC.simba_residual_block_apply(jp, x)), rtol=1e-5, atol=1e-6)


NET_CASES = {
    "cnn": (gspaces.Box(0.0, 1.0, (3, 16, 16), np.float32), {}),  # channels-first
    "resnet": (gspaces.Box(0.0, 1.0, (12, 12, 3), np.float32), {"resnet": True}),
    "simba": (gspaces.Box(-1.0, 1.0, (6,), np.float32),
              {"simba": True, "encoder_config": {"hidden_size": 64}}),
    "lstm": (gspaces.Box(-1.0, 1.0, (6,), np.float32),
             {"recurrent": True, "encoder_config": {"hidden_size": 24}}),
    "multi_input": (_dict_space(), {}),
}


@pytest.mark.parametrize("kind", sorted(NET_CASES))
def test_networks_on_each_encoder_match_jax(kind):
    """The network picks the JAX package's encoder and config for the space;
    a JAX network's weights carry through params_from_numpy; its apply and
    one encoder and one latent mutation agree."""
    space, kw = NET_CASES[kind]
    jn = JValue(space, key=jax.random.PRNGKey(7), latent_dim=16, **kw)
    tn = TValue(space, device="cpu", latent_dim=16, **kw)
    assert tn.config.encoder_kind == jn.config.encoder_kind == kind
    assert tn.mutation_methods() == jn.mutation_methods()
    tn.params = params_from_numpy(_np(jn.params), tn.config, "cpu")
    rng = np.random.default_rng(8)
    if kind == "multi_input":
        obs = _dict_obs(rng, 3)
        tobs = {k: torch.from_numpy(v) for k, v in obs.items()}
    else:
        obs = rng.uniform(0, 1, (3,) + space.shape).astype(np.float32)
        tobs = torch.from_numpy(obs)
    from agilerl_tpu.utils.spaces import preprocess_observation as jpre
    from agilerl_tpu_torch.utils.spaces import preprocess_observation as tpre

    if kind != "multi_input":
        obs, tobs = jpre(space, obs), tpre(space, tobs)
    np.testing.assert_allclose(tn(tobs).numpy(), np.asarray(jn(obs)), rtol=1e-5, atol=1e-6)
    for i, name in enumerate(["add_latent_node", tn.mutation_methods()[2]]):
        old = _np(jn.params)
        assert tn.apply_mutation(name, rng=np.random.default_rng(i)) == \
            jn.apply_mutation(name, rng=np.random.default_rng(i))
        _assert_preserved(old, _np(jn.params), tn.params)
        tn.params = params_from_numpy(_np(jn.params), tn.config, "cpu")
    np.testing.assert_allclose(tn(tobs).numpy(), np.asarray(jn(obs)), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="shape"):
        bad = _np(jn.params)
        bad["head"]["output"]["bias"] = np.zeros(3, np.float32)
        params_from_numpy(bad, tn.config, "cpu")


def test_dummy_configs_and_protocols():
    dummy = DummyEvolvable(lambda g: {"w": torch.ones(3, device=g.device)},
                           lambda p, x: x * p["w"], device="cpu")
    torch.testing.assert_close(dummy(torch.arange(3.0)), torch.arange(3.0))
    assert dummy.get_mutation_methods() == {}
    with pytest.raises(ValueError):
        dummy.sample_mutation_method()
    assert load_net_config({"LATENT_DIM": 8, "encoder_config": {"channel_size": [16, 32]},
                            "other": 1}) == {"latent_dim": 8,
                                             "encoder_config": {"channel_size": (16, 32)}}
    for case in sorted(CASES):
        _, tm, _ = _pair(case)
        assert isinstance(tm, P.EvolvableModuleProtocol), case
    tn = TValue(gspaces.Box(-1.0, 1.0, (6,), np.float32), device="cpu", simba=True)
    assert isinstance(tn, P.EvolvableNetworkProtocol)
