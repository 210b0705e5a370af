"""Parity of the port's offline language-RL stack with the JAX package's, on
the CPU in f32: the functional layers (agilerl_tpu_torch.modules.layers),
RL_Dataset, ILQL (one learn, the polyak target, hard_update, greedy, beam
and sampled generation, TopAdvantageNGrams) and BC_LM, on weights carried
from the JAX package."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.algorithms import ilql as JI  # noqa: E402
from agilerl_tpu.data import rl_data as JD  # noqa: E402
from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.modules import layers as JL  # noqa: E402
from agilerl_tpu_torch.algorithms import ilql as TI  # noqa: E402
from agilerl_tpu_torch.data import rl_data as TD  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.convert import f32_tree_from_numpy  # noqa: E402
from agilerl_tpu_torch.modules import layers as TL  # noqa: E402
from agilerl_tpu_torch.utils.llm_utils import CharTokenizer  # noqa: E402

torch.set_num_threads(1)

TOK = CharTokenizer()
KW = dict(vocab_size=TOK.vocab_size, n_layer=2, n_head=4, d_model=64, max_seq_len=32)
JCFG = JM.GPTConfig(dtype=jnp.float32, **KW)
TCFG = TM.GPTConfig(dtype=torch.float32, **KW)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ------------------------------- layers ------------------------------------ #


def _layer_case(name, rng):
    """(jax output, torch output) of one apply on the same weights/inputs."""
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    x = rng.normal(size=(3, 5, 8)).astype(np.float32)
    if name == "dense":
        p = _np(JL.dense_init(key, 8, 6))
        return JL.dense_apply(p, x), TL.dense_apply(f32_tree_from_numpy(p, "cpu"), _t(x))
    if name == "noisy_dense":
        p = _np(JL.noisy_dense_init(key, 8, 6))
        return (JL.noisy_dense_apply(p, x),
                TL.noisy_dense_apply(f32_tree_from_numpy(p, "cpu"), _t(x)))
    if name == "layer_norm":
        p = {"scale": rng.normal(size=8).astype(np.float32),
             "bias": rng.normal(size=8).astype(np.float32)}
        return JL.layer_norm_apply(p, x), TL.layer_norm_apply(f32_tree_from_numpy(p, "cpu"), _t(x))
    if name == "rms_norm":
        p = {"scale": rng.normal(size=8).astype(np.float32)}
        return JL.rms_norm_apply(p, x), TL.rms_norm_apply(f32_tree_from_numpy(p, "cpu"), _t(x))
    if name.startswith("conv2d"):
        _, stride, padding = name.split("_")
        img = rng.normal(size=(2, 9, 8, 3)).astype(np.float32)
        p = _np(JL.conv2d_init(key, 3, 2, 3, 4))
        return (JL.conv2d_apply(p, img, int(stride), padding),
                TL.conv2d_apply(f32_tree_from_numpy(p, "cpu"), _t(img), int(stride), padding))
    if name == "lstm_scan":
        p = _np(JL.lstm_cell_init(key, 8, 6))
        h0 = rng.normal(size=(5, 6)).astype(np.float32)
        c0 = rng.normal(size=(5, 6)).astype(np.float32)
        jo, (jh, jc) = JL.lstm_scan(p, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0))
        to, (th, tc) = TL.lstm_scan(f32_tree_from_numpy(p, "cpu"), _t(x), _t(h0), _t(c0))
        return (jnp.concatenate([jo.reshape(-1), jh.reshape(-1), jc.reshape(-1)]),
                torch.cat([to.reshape(-1), th.reshape(-1), tc.reshape(-1)]))
    if name == "embedding":
        p = _np(JL.embedding_init(key, 11, 4))
        ids = rng.integers(0, 11, (3, 7))
        return (JL.embedding_apply(p, jnp.asarray(ids)),
                TL.embedding_apply(f32_tree_from_numpy(p, "cpu"), _t(ids)))
    if name == "maybe_rescale_image":
        img = rng.integers(0, 256, (2, 4, 4, 3)).astype(np.uint8)
        return (jnp.concatenate([JL.maybe_rescale_image(jnp.asarray(img)).reshape(-1),
                                 JL.maybe_rescale_image(jnp.asarray(x)).reshape(-1)]),
                torch.cat([TL.maybe_rescale_image(_t(img)).reshape(-1),
                           TL.maybe_rescale_image(_t(x)).reshape(-1)]))
    act = name.split(":")[1]
    return JL.get_activation(act)(jnp.asarray(3 * x)), TL.get_activation(act)(_t(3 * x))


LAYER_CASES = (["dense", "noisy_dense", "layer_norm", "rms_norm", "conv2d_1_VALID",
                "conv2d_1_SAME", "conv2d_2_SAME", "conv2d_2_VALID", "lstm_scan", "embedding",
                "maybe_rescale_image"]
               + [f"activation:{a}" for a in sorted(JL.ACTIVATIONS)])


@pytest.mark.parametrize("name", LAYER_CASES)
def test_layer_apply_matches_jax(name):
    want, got = _layer_case(name, np.random.default_rng(LAYER_CASES.index(name)))
    assert tuple(got.shape) == tuple(np.shape(want)), name
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_layer_helpers_and_activation_names():
    assert sorted(TL.ACTIVATIONS) == sorted(JL.ACTIVATIONS)
    assert TL.get_activation(None)(torch.ones(2)).tolist() == [1.0, 1.0]
    with pytest.raises(ValueError, match="Unknown activation"):
        TL.get_activation("Swish")
    for args in ((32, 3, 1), (32, 3, 2, 1), (7, 7, 3)):
        assert TL.conv_out_size(*args) == JL.conv_out_size(*args)
    assert set(TL.layer_norm_init(4)) == set(JL.layer_norm_init(4))
    assert set(TL.rms_norm_init(4)) == set(JL.rms_norm_init(4))


def test_layer_inits_shape_dtype_and_distribution():
    """Inits draw from a torch.Generator, so they are checked by keys,
    shapes and dtypes against the JAX inits (traced, not run) and by the law
    the JAX package draws from: kaiming-uniform on +-sqrt(1 / fan_in), the
    noisy layer's mu on +-1 / sqrt(in) with constant sigmas, the embedding
    normal(0, 0.02); the empirical bound and std within 6 standard errors."""
    g = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    uniform = lambda fan_in: ("uniform", 1.0 / np.sqrt(fan_in))  # noqa: E731
    cases = [((TL.dense_init, JL.dense_init), (256, 128),
              {"kernel": uniform(256), "bias": uniform(256)}),
             ((TL.noisy_dense_init, JL.noisy_dense_init), (256, 128),
              {"kernel_mu": uniform(256), "bias_mu": uniform(256),
               "kernel_sigma": ("const", 0.5 / 16), "bias_sigma": ("const", 0.5 / np.sqrt(128))}),
             ((TL.conv2d_init, JL.conv2d_init), (3, 3, 16, 32),
              {"kernel": uniform(144), "bias": uniform(144)}),
             ((TL.lstm_cell_init, JL.lstm_cell_init), (64, 32),
              {"wi": uniform(64), "wh": uniform(32), "bi": uniform(64), "bh": uniform(32)}),
             ((TL.embedding_init, JL.embedding_init), (500, 64), {"embedding": ("normal", 0.02)})]
    for (tinit, jinit), args, laws in cases:
        tp = tinit(g, *args)
        jp = jax.eval_shape(lambda: jinit(key, *args))
        assert sorted(tp) == sorted(jp) == sorted(laws)
        for k, (kind, scale) in laws.items():
            assert tuple(tp[k].shape) == jp[k].shape and tp[k].dtype == torch.float32, k
            assert jp[k].dtype == jnp.float32
            x = tp[k].numpy().ravel()
            if kind == "const":
                np.testing.assert_allclose(x, scale, rtol=1e-6)
                continue
            std = scale / np.sqrt(3) if kind == "uniform" else scale
            se = 6 / np.sqrt(x.size)
            assert abs(x.mean()) <= se * std, k
            assert abs(x.std() - std) <= se * std, k
            if kind == "uniform":
                assert scale * (1 - 10 / x.size) <= np.abs(x).max() <= scale, k
    w = TL.orthogonal(g, (64, 32), scale=2.0)
    torch.testing.assert_close(w.t() @ w, 4.0 * torch.eye(32), rtol=0, atol=1e-4)
    assert jax.eval_shape(lambda: JL.orthogonal(key, (64, 32), 2.0)).shape == (64, 32)


def test_noisy_dense_with_a_generator_uses_factorised_noise():
    p = TL.noisy_dense_init(torch.Generator().manual_seed(1), 8, 5)
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(2))
    got = TL.noisy_dense_apply(p, x, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    e_in, e_out = (torch.randn(n, generator=g) for n in (8, 5))
    e_in, e_out = (e.sign() * e.abs().sqrt() for e in (e_in, e_out))
    want = x @ (p["kernel_mu"] + p["kernel_sigma"] * torch.outer(e_in, e_out)) \
        + p["bias_mu"] + p["bias_sigma"] * e_out
    torch.testing.assert_close(got, want)


# ------------------------------- data -------------------------------------- #


def _observations(mod, n=32, seed=0):
    rng = np.random.default_rng(seed)
    obs = []
    for _ in range(n):
        a = int(rng.integers(0, 5))
        good = rng.random() < 0.5
        answer = str(a + 1) if good else str(a)
        obs.append(mod.Language_Observation(
            sequence=[(f"{a}+1=", None), (answer, 1.0 if good else -1.0)],
            terminal=bool(rng.random() < 0.8)))
    return obs


class _Shaping:
    def get_token_reward(self, tokens):
        return [0.01 * t for t in tokens]


def _datasets(n=32, seed=0, max_len=8, shaped=False):
    kw = dict(max_len=max_len)
    return (JD.RL_Dataset(_observations(JD, n, seed), TOK,
                          token_reward=_Shaping() if shaped else None, **kw),
            TD.RL_Dataset(_observations(TD, n, seed), TOK,
                          token_reward=_Shaping() if shaped else None, **kw))


@pytest.mark.parametrize("shaped,max_len", [(False, 8), (True, 5)])
def test_rl_dataset_rows_and_sample_batch_match_jax(shaped, max_len):
    jds, tds = _datasets(shaped=shaped, max_len=max_len)
    assert len(tds) == len(jds)
    for jr, tr in zip(jds.rows, tds.rows):
        for k in jr:
            assert tr[k].dtype == jr[k].dtype
            np.testing.assert_array_equal(tr[k], jr[k])
    jb = jds.sample_batch(6, np.random.default_rng(3))
    tb = tds.sample_batch(6, np.random.default_rng(3))
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


# ------------------------------- ILQL -------------------------------------- #


def _ilql_pair(**kw):
    jagent = JI.ILQL(config=JCFG, lr=1e-3, seed=0, **kw)
    tagent = TI.ILQL(config=TCFG, lr=1e-3, seed=0, device="cpu", **kw)
    tagent.actor.params = f32_tree_from_numpy(_np(jagent.actor.params), "cpu")
    tagent.target_q.params = f32_tree_from_numpy(_np(jagent.target_q.params), "cpu")
    tagent.optimizer.init(tagent.actor.params)
    return jagent, tagent


def _leaf_pairs(ttree, jtree):
    """(path, torch leaf as numpy, jax leaf as numpy) over the JAX tree."""
    for path, want in jax.tree_util.tree_leaves_with_path(_np(jtree)):
        node = ttree
        for p in path:
            node = node[p.key]
        yield jax.tree_util.keystr(path), node.numpy(), want


def _assert_tree_close(ttree, jtree, atol):
    for path, got, want in _leaf_pairs(ttree, jtree):
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=path)


def _assert_adamw_step_close(tparams, jparams, topt, jopt, atol=5e-6):
    """The whole model after one AdamW step from identical weights. The
    gradients (AdamW's first moment, 0.1 g) agree to f32 summation order:
    within 1e-5 of each leaf's largest entry. The weights agree at ``atol``
    wherever |g| >= 1e-6. Below that the first step, lr * g / (|g| + 1e-8),
    turns those summation-order differences into step differences of up to
    lr (a 2e-8 gradient that differs by 4 % moves its weight 1.2e-5 further
    at lr 1e-3), so such entries are held through their gradient alone."""
    tmu, jmu = topt.inner_state[0].mu, jopt.inner_state[0].mu
    grads = {}
    for path, got, want in _leaf_pairs(tmu, jmu):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max() + 1e-12,
                                   err_msg=f"first moment {path}")
        grads[path] = np.abs(want) / 0.1
    for path, got, want in _leaf_pairs(tparams, jparams):
        ok = grads[path] >= 1e-6
        assert ok.mean() > 0.95, path  # the rule exempts few entries
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=atol, err_msg=path)


@pytest.mark.parametrize("double_q,dm_weight", [(True, 0.5), (False, 0.0)])
def test_ilql_learn_matches_jax(double_q, dm_weight):
    """One train step on carried weights: the total loss and its four terms
    (q, v, cql, pi) at rtol 1e-5, the updated params at atol 5e-6 (see
    _assert_adamw_step_close) and the polyak target at atol 5e-6; then
    learn() on the next batch returns the same loss."""
    jagent, tagent = _ilql_pair(double_q=double_q, dm_weight=dm_weight, dm_margin=0.1)
    jds, _ = _datasets()
    batch = jds.sample_batch(8, np.random.default_rng(0))
    jstep = jagent.jit_fn("train", jagent._loss_fn)
    jp, jtq, jopt, jtotal, jaux = jstep(jagent.actor.params, jagent.target_q.params,
                                        jagent.optimizer.opt_state,
                                        {k: jnp.asarray(v) for k, v in batch.items()},
                                        jax.random.PRNGKey(0))
    tstep = tagent.jit_fn("train", tagent._loss_fn)
    tp, ttq, topt, ttotal, taux = tstep(tagent.actor.params, tagent.target_q.params,
                                        tagent.optimizer.opt_state,
                                        TI._offline_batch(batch, torch.device("cpu")))
    np.testing.assert_allclose(ttotal.item(), float(jtotal), rtol=1e-5)
    for name, t, j in zip(("q", "v", "cql", "pi"), taux, jaux):
        np.testing.assert_allclose(t.item(), float(j), rtol=1e-5, err_msg=name)
    _assert_adamw_step_close(tp, jp, topt, jopt)
    _assert_tree_close(ttq, jtq, 5e-6)
    assert set(ttq) == ({"q_head", "q2_head"} if double_q else {"q_head"})
    batch2 = jds.sample_batch(8, np.random.default_rng(1))
    jagent.actor.params, jagent.target_q.params, jagent.optimizer.opt_state = jp, jtq, jopt
    tagent.actor.params, tagent.target_q.params, tagent.optimizer.opt_state = tp, ttq, topt
    np.testing.assert_allclose(tagent.learn(batch2), jagent.learn(batch2), rtol=1e-5)
    _assert_tree_close(tagent.target_q.params, jagent.target_q.params, 5e-6)


def test_ilql_hard_update_and_clone():
    _, tagent = _ilql_pair()
    jds, _ = _datasets()
    tagent.learn(jds.sample_batch(8, np.random.default_rng(0)))
    live = tagent.actor.params["q2_head"]["kernel"]
    assert not torch.equal(tagent.target_q.params["q2_head"]["kernel"], live)
    tagent.hard_update()
    for name in ("q_head", "q2_head"):
        for k in ("kernel", "bias"):
            got = tagent.target_q.params[name][k]
            assert torch.equal(got, tagent.actor.params[name][k])
            assert got.data_ptr() != tagent.actor.params[name][k].data_ptr()
    clone = tagent.clone(index=5)
    assert torch.equal(clone.target_q.params["q_head"]["kernel"],
                       tagent.target_q.params["q_head"]["kernel"])
    assert clone.actor.params["gpt"]["tok_emb"].dtype == torch.float32


def _prompts():
    seqs = [TOK.encode("3+1="), TOK.encode("12+4="), TOK.encode("7=")]
    P = max(map(len, seqs))
    toks = np.zeros((3, P), np.int32)
    mask = np.zeros((3, P), np.int32)
    for i, s in enumerate(seqs):  # right-padded, as generate() wants
        toks[i, :len(s)] = s
        mask[i, :len(s)] = 1
    return toks, mask


@pytest.mark.parametrize("mode,q_scale,eos_id", [("greedy", 1.0, None), ("greedy", 3.0, 5),
                                                 ("beam", 1.0, None), ("beam", 2.0, 5)])
def test_ilql_greedy_and_beam_generate_match_jax(mode, q_scale, eos_id):
    """Greedy and beam search over the Q/V-reweighted LM give the same tokens
    and masks (random carried weights; eos 5 stops some rows early)."""
    jagent, tagent = _ilql_pair()
    toks, mask = _prompts()
    kw = dict(max_new_tokens=4, mode=mode, q_scale=q_scale, beam_width=3, eos_id=eos_id)
    jt, jm = jagent.generate(toks, mask, **kw)
    tt, tm = tagent.generate(toks, mask, **kw)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    np.testing.assert_array_equal(tm, np.asarray(jm))
    assert tt.shape == (3, toks.shape[1] + 4)


def test_ilql_scores_and_sampling_match_jax_in_distribution():
    """get_action and sample mode draw from the same score vector as the JAX
    package (rtol 1e-5); the draws follow softmax(score)."""
    jagent, tagent = _ilql_pair()
    toks, mask = _prompts()
    want = np.asarray(jagent._score_fn()(jagent.actor.params, jnp.asarray(toks),
                                         jnp.asarray(mask), 1.5))
    got = tagent.jit_fn("scores", tagent._score_fn)(tagent.actor.params, _t(toks).long(),
                                                    _t(mask), 1.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # get_action samples from the last position's scores
    n = 4000
    rows = np.repeat(toks[:1], n, axis=0)
    draws = tagent.get_action(rows, np.ones_like(rows), q_scale=1.5,
                              key=torch.Generator().manual_seed(0))
    probs = torch.softmax(torch.tensor(want[0, -1]), dim=-1).numpy()
    freq = np.bincount(draws, minlength=probs.size) / n
    assert np.abs(freq - probs).max() < 0.03
    assert jagent.get_action(toks, mask).shape == tagent.get_action(toks, mask).shape == (3,)
    sampled, smask = tagent.generate(toks, mask, max_new_tokens=3, mode="sample",
                                     temperature=0.7, key=torch.Generator().manual_seed(1))
    assert sampled.shape == (3, toks.shape[1] + 3)
    assert (smask.sum(1) > mask.sum(1)).all()  # every row took its first token


def test_top_advantage_ngrams_match_jax():
    jagent, tagent = _ilql_pair()
    jds, _ = _datasets()
    batch = jds.sample_batch(8, np.random.default_rng(0))
    out = []
    for mod, agent in ((JI, jagent), (TI, tagent)):
        probe = mod.TopAdvantageNGrams(tokenizer=TOK, n_gram=2, print_k=5)
        probe.evaluate(agent, batch)
        out.append(probe)
    jp, tp = out
    assert tp._count == jp._count
    for gram, adv in jp._adv.items():
        np.testing.assert_allclose(tp._adv[gram], adv, rtol=1e-5, atol=1e-6)
    assert [t for t, _ in tp.top()] == [t for t, _ in jp.top()]
    np.testing.assert_allclose([a for _, a in tp.top()], [a for _, a in jp.top()], rtol=1e-5)


def test_ilql_evaluator_reward_rollout():
    _, tagent = _ilql_pair()

    class PromptEnv:
        def eval_prompts(self):
            yield _prompts()

        def reward(self, tokens, mask):
            return np.ones(tokens.shape[0], np.float32)

    ev = TI.ILQL_Evaluator(PromptEnv(), kind="greedy", max_new_tokens=2)
    assert ev.evaluate(tagent) == {"env_reward": 1.0, "episodes": 3.0}
    assert len(ev.dump()["results"]) == 1
    with pytest.raises(ValueError, match="kind"):
        TI.ILQL_Policy(tagent, kind="top_p")
    with pytest.raises(ValueError, match="mode"):
        tagent.generate(*_prompts(), mode="top_p")


# ------------------------------- BC_LM ------------------------------------- #


def test_bc_lm_learn_matches_jax():
    """One learn on carried weights: loss at rtol 1e-5 and the updated
    weights at atol 5e-6 (see _assert_adamw_step_close); then generate gives
    [B, N] completions."""
    jagent = JI.BC_LM(config=JCFG, lr=1e-3, seed=0)
    tagent = TI.BC_LM(config=TCFG, lr=1e-3, seed=0, device="cpu")
    tagent.actor.params = f32_tree_from_numpy(_np(jagent.actor.params), "cpu")
    tagent.optimizer.init(tagent.actor.params)
    jds, _ = _datasets(64)
    batch = jds.sample_batch(16, np.random.default_rng(0))
    np.testing.assert_allclose(tagent.learn(batch), jagent.learn(batch), rtol=1e-5)
    _assert_adamw_step_close(tagent.actor.params, jagent.actor.params,
                             tagent.optimizer.opt_state, jagent.optimizer.opt_state)
    comp, cmask = tagent.generate(np.ones((1, 4), np.int32), np.ones((1, 4), np.int32),
                                  max_new_tokens=4)
    assert tuple(comp.shape) == tuple(cmask.shape) == (1, 4)
