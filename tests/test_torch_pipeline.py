"""The port's GPipe pipeline (``parallel/pipeline.py``) and its stage body
(``llm/model.block_apply_dense``) against the JAX package
(``tests/test_parallel/test_pipeline.py``), on 4 gloo ranks on the CPU
(``tests/torch_dist_harness.py``; one pool for the module). The same
``init_params`` arrays go through the JAX ``pipeline_apply`` on its virtual
CPU mesh, the JAX plain model, the port's plain ``apply`` and the port's
pipeline on every (stages, microbatches) of the JAX test, at its
tolerances (logits 2e-4; gradients rtol 5e-4 / atol 1e-5 against
``jax.grad`` of the plain model). A pp axis smaller than the world is the
"pp" axis of a ("dp", "pp") mesh: the dp replicas run the same pipeline."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.parallel import pipeline as JP  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.convert import params_from_numpy  # noqa: E402
from agilerl_tpu_torch.parallel import pipeline as TP  # noqa: E402
from tests.torch_dist_harness import RankPool  # noqa: E402

torch.set_num_threads(1)

CFG_KW = dict(vocab_size=64, n_layer=4, n_head=2, d_model=32, max_seq_len=16)
JCFG = JM.GPTConfig(dtype=jnp.float32, **CFG_KW)
TCFG = TM.GPTConfig(dtype=torch.float32, **CFG_KW)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)  # test_pipeline.py:45-51
GRAD_TOL = dict(rtol=5e-4, atol=1e-5)  # test_pipeline.py:93-96


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def params():
    return jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(0), JCFG))


def _jmesh(n, names=("pp",)):
    return Mesh(np.asarray(jax.devices()[:n]).reshape(-1 if len(names) == 1 else (2, n // 2)),
                axis_names=names)


def _tokens(rows, mult):
    return (np.arange(rows * 8).reshape(rows, 8) * mult) % 64


def _jax_loss_fn(cfg, tokens, fn):
    targets = jnp.roll(tokens, -1, axis=1)

    def loss(p):
        lp = jax.nn.log_softmax(fn(p), -1)
        return -jnp.take_along_axis(lp, targets[..., None], -1).mean()

    return loss


def _assemble(res, key, pp, fsdp=1):
    """The whole [L, ...] gradient of a stacked block leaf from the ranks'
    slices (stages along dim 0, fsdp shards along dim 1)."""
    got = {(r["stage"], r["shard"]): r["grads"][key] for r in res}
    return np.concatenate([np.concatenate([got[(s, f)] for f in range(fsdp)], axis=1)
                           for s in range(pp)])


def _check_grads(res, jgrads, pp, fsdp=1):
    stacked = jax.tree_util.tree_map(np.asarray, JP.stack_blocks(jgrads, JCFG))
    for k, want in stacked.items():
        np.testing.assert_allclose(_assemble(res, k, pp, fsdp), want, err_msg=k, **GRAD_TOL)
    for r in res:  # the replicated leaves: the whole gradient on every rank
        for k in ("tok_emb", "ln_f"):
            np.testing.assert_allclose(r["grads"][k], np.asarray(jgrads[k]), err_msg=k,
                                       **GRAD_TOL)


# --------------------------------------------------------------------------- #
# The stage body
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_block_apply_dense_matches_jax_and_forward(qkv_bias):
    """One block against the JAX ``block_apply_dense`` (non-zero biases, a
    padding mask, GQA), and against the port's own ``forward`` on a
    one-layer model (the JAX test pins its two paths to each other)."""
    kw = dict(vocab_size=64, n_layer=1, n_head=4, n_kv_head=2, d_model=32, qkv_bias=qkv_bias)
    jcfg = JM.GPTConfig(dtype=jnp.float32, **kw)
    tcfg = TM.GPTConfig(dtype=torch.float32, **kw)
    p = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(1), jcfg))
    if qkv_bias:
        blk = p["blocks"]["0"]
        blk["bq"], blk["bk"], blk["bv"] = blk["bq"] + 0.3, blk["bk"] - 0.2, blk["bv"] + 0.1
    rng = np.random.default_rng(0)
    h = rng.normal(size=(2, 8, 32)).astype(np.float32)
    mask = np.array([[1] * 8, [1] * 5 + [0] * 3], np.int32)
    pos = np.maximum(np.cumsum(mask, -1) - 1, 0)
    want = JM.block_apply_dense(jcfg, jax.tree_util.tree_map(jnp.asarray, p["blocks"]["0"]),
                                jnp.asarray(h), jnp.asarray(mask), jnp.asarray(pos))
    tp = params_from_numpy(p, tcfg, device="cpu")
    got = TM.block_apply_dense(tcfg, tp["blocks"]["0"], torch.as_tensor(h),
                               torch.as_tensor(mask), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    tokens = torch.as_tensor(_tokens(2, 3))
    hidden, _ = TM.forward(tcfg, tp, tokens, attention_mask=torch.as_tensor(mask))
    h0 = torch.nn.functional.embedding(tokens, tp["tok_emb"])
    block = TM.block_apply_dense(tcfg, tp["blocks"]["0"], h0, torch.as_tensor(mask),
                                 torch.as_tensor(pos))
    np.testing.assert_array_equal(TM._rms(block, tp["ln_f"], tcfg.rms_eps).numpy(),
                                  hidden.numpy())


def test_stack_unstack_roundtrip(params):
    p = params_from_numpy(params, TCFG, device="cpu")
    stacked = TP.stack_blocks(p, TCFG)
    jstacked = JP.stack_blocks(params, JCFG)
    for k, v in stacked.items():
        assert v.shape[0] == TCFG.n_layer
        np.testing.assert_array_equal(v.numpy(), np.asarray(jstacked[k]))
    back = TP.unstack_blocks(stacked, TCFG)
    for i in range(TCFG.n_layer):
        for k, v in p["blocks"][str(i)].items():
            assert torch.equal(v, back[str(i)][k])


# --------------------------------------------------------------------------- #
# The pipeline on the ranks
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n_stages,n_micro", [(2, 2), (4, 2), (2, 4), (1, 4)])
def test_pipeline_matches_jax_and_plain_forward(pool, params, n_stages, n_micro):
    tokens = _tokens(4, 5)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, _ = JM.apply(JCFG, jp, jnp.asarray(tokens))
    jgot = JP.pipeline_apply(JCFG, jp, jnp.asarray(tokens), _jmesh(n_stages),
                             num_microbatches=n_micro)
    plain, _ = TM.apply(TCFG, params_from_numpy(params, TCFG, device="cpu"),
                        torch.as_tensor(tokens))
    res = pool.run("pipeline_run", cfg_kw=CFG_KW, params=params, tokens=tokens, pp=n_stages,
                   micro=n_micro)
    for r in res:
        np.testing.assert_allclose(r["logits"], np.asarray(jgot), **FWD_TOL)
        np.testing.assert_allclose(r["logits"], np.asarray(want), **FWD_TOL)
        np.testing.assert_allclose(r["logits"], plain.numpy(), **FWD_TOL)


def test_pipeline_respects_padding_mask(pool, params):
    tokens = _tokens(2, 3)
    mask = np.array([[1] * 8, [1] * 5 + [0] * 3], np.int32)
    want, _ = JM.apply(JCFG, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens),
                       attention_mask=jnp.asarray(mask))
    res = pool.run("pipeline_run", cfg_kw=CFG_KW, params=params, tokens=tokens, pp=2, micro=2,
                   mask=mask)
    want = np.asarray(want)
    for r in res:  # valid positions only
        np.testing.assert_allclose(r["logits"][0], want[0], **FWD_TOL)
        np.testing.assert_allclose(r["logits"][1, :5], want[1, :5], **FWD_TOL)


def test_pipeline_gradients_match_jax_plain(pool, params):
    """Autograd through the ring shifts, 4 stages x 2 microbatches: the
    loss and every gradient against ``jax.grad`` of the plain model; the
    stacked block gradients assembled from the stages' slices, the
    replicated leaves whole on every rank."""
    tokens = _tokens(4, 7)
    loss = _jax_loss_fn(JCFG, jnp.asarray(tokens),
                        lambda p: JM.apply(JCFG, p, jnp.asarray(tokens))[0])
    want_l, want_g = jax.value_and_grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    res = pool.run("pipeline_run", cfg_kw=CFG_KW, params=params, tokens=tokens, pp=4, micro=2,
                   grads=True)
    for r in res:
        np.testing.assert_allclose(r["loss"], float(want_l), rtol=1e-5)
    _check_grads(res, want_g, 4)


def test_pipeline_composed_with_fsdp_grad_parity(pool, params):
    """pp 2 x fsdp 2: each stage's weights also sharded on dim 1 and
    gathered per layer (reduce-scatter gradients), the 8 rows split over
    the fsdp ranks: logits against the JAX pp x fsdp pipeline, the loss and
    gradients against the JAX plain model."""
    tokens = _tokens(8, 7)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    mesh = _jmesh(4, ("pp", "fsdp"))
    with mesh:
        jgot = jax.jit(lambda p: JP.pipeline_apply(JCFG, p, jnp.asarray(tokens), mesh,
                                                   num_microbatches=2, fsdp_axis="fsdp"))(jp)
    loss = _jax_loss_fn(JCFG, jnp.asarray(tokens),
                        lambda p: JM.apply(JCFG, p, jnp.asarray(tokens))[0])
    want_l, want_g = jax.value_and_grad(loss)(jp)
    res = pool.run("pipeline_run", cfg_kw=CFG_KW, params=params, tokens=tokens, pp=2, micro=2,
                   fsdp=2, grads=True)
    for r in res:
        np.testing.assert_allclose(r["logits"], np.asarray(jgot), **FWD_TOL)
        np.testing.assert_allclose(r["loss"], float(want_l), rtol=1e-5)
    _check_grads(res, want_g, 2, fsdp=2)


def test_pipeline_train_step_with_sharded_stack(pool, params):
    """Two SGD steps on each rank's stage slice and the replicated rest: the
    loss descends, the same on every rank, as the JAX test's jitted step."""
    res = pool.run("pipeline_train", cfg_kw=CFG_KW, params=params, tokens=_tokens(4, 11), pp=4,
                   micro=2)
    for losses in res:
        assert np.isfinite(losses).all() and losses[1] < losses[0]
        assert losses == res[0]


# --------------------------------------------------------------------------- #
# The refusals
# --------------------------------------------------------------------------- #


class FakeMesh:
    """The names and sizes of a mesh (the checks read nothing else)."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, dim):
        return self._sizes[dim]

    def get_local_rank(self, axis):
        return 0

    def get_group(self, axis):
        return None


def test_pipeline_rejects_moe_and_indivisible_layouts():
    moe = dataclasses.replace(TCFG, n_experts=2)
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="MoE"):
        TP.pipeline_apply(moe, {}, tokens, FakeMesh(pp=2))
    with pytest.raises(ValueError, match="pipeline stages"):
        TP.pipeline_hidden_fn(TCFG, FakeMesh(pp=3), 2)
    with pytest.raises(ValueError, match="d_model"):
        TP.pipeline_hidden_fn(TCFG, FakeMesh(pp=2, fsdp=3), 2, fsdp_axis="fsdp")
    with pytest.raises(ValueError, match="must divide by fsdp size"):
        TP.pipeline_apply(TCFG, {}, torch.zeros((6, 4), dtype=torch.int64),
                          FakeMesh(pp=2, fsdp=2), num_microbatches=2, fsdp_axis="fsdp")
    with pytest.raises(ValueError, match="homogeneous"):
        p = params_from_numpy(jax.tree_util.tree_map(
            np.asarray, JM.init_params(jax.random.PRNGKey(0), JCFG)), TCFG, device="cpu")
        del p["blocks"]["1"]["ln1"]
        TP.stack_blocks(p, TCFG)
    # the JAX package refuses the same layouts
    with pytest.raises(AssertionError):
        JP.pipeline_apply(dataclasses.replace(JCFG, n_experts=2), {}, jnp.zeros((2, 4), jnp.int32),
                          _jmesh(2))
