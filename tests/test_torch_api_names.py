"""The public names the port took over last from the JAX package, each with
the JAX function's semantics: the recurrent collect alias, ``MutationError``,
the algorithms' distributed shims and ``GRPO.clean_up``, the optimizer's
state dict, ``path_entry_to_string``, ``sample_obs``, the ``typing``
aliases and ``ContinuousGenerator``'s admission knobs
(``tests/test_torch_surface.py`` holds that none is missing)."""

import pytest
import torch

jax = pytest.importorskip("jax")

from agilerl_tpu.parallel import tree_paths as JTP  # noqa: E402
from agilerl_tpu.utils import spaces as JS  # noqa: E402
from agilerl_tpu_torch import typing as TT  # noqa: E402
from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper  # noqa: E402
from agilerl_tpu_torch.algorithms.grpo import GRPO  # noqa: E402
from agilerl_tpu_torch.hpo.mutation import MutationError  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.serving import ContinuousGenerator  # noqa: E402
from agilerl_tpu_torch.parallel import tree_paths as TTP  # noqa: E402
from agilerl_tpu_torch.rollouts import on_policy as TR  # noqa: E402
from agilerl_tpu_torch.utils import spaces as TS  # noqa: E402

CFG = TM.GPTConfig(vocab_size=32, n_layer=1, n_head=2, n_kv_head=1, d_model=16, max_seq_len=32,
                   dtype=torch.float32)


def test_recurrent_collect_and_mutation_error_are_the_jax_names():
    from agilerl_tpu.rollouts import on_policy as JR

    assert JR.collect_rollouts_recurrent is JR.collect_rollouts
    assert TR.collect_rollouts_recurrent is TR.collect_rollouts
    assert issubclass(MutationError, RuntimeError)
    assert TT.KeyArray is torch.Generator and TT.ExperiencesType == TT.Dict[str, TT.Any]
    assert {"ArrayLike", "Params", "PyTree", "ObservationType", "GymSpaceType",
            "ApplyFn"} <= set(vars(TT))


def test_distributed_shims_clean_up_and_optimizer_state_dict():
    """``wrap_models`` / ``unwrap_models`` do nothing; ``recompile`` and
    ``clean_up`` drop the cached callables (built again at the next use);
    the optimizer's state dict is its state tree, and loading it back sets
    that tree."""
    agent = GRPO(config=CFG, seed=0, device="cpu", group_size=2, lora_rank=2)
    fn = agent.jit_fn("probe", lambda: object())
    assert agent.wrap_models() is None and agent.unwrap_models() is None
    assert agent.jit_fn("probe", lambda: object()) is fn
    agent.recompile()
    assert agent.jit_fn("probe", lambda: object()) is not fn
    agent._bucketed_gen = agent._continuous_gen = object()
    agent.clean_up()
    assert agent._jit_cache == {} and agent._bucketed_gen is None
    assert agent._continuous_gen is None

    opt = OptimizerWrapper("adam", lr=1e-2)
    params = {"w": torch.ones(3)}
    opt.init(params)
    state = opt.state_dict()
    assert state is opt.opt_state
    opt.update({"w": torch.ones(3)}, params)
    assert opt.state_dict() is not state
    opt.load_state_dict(state)
    assert opt.opt_state is state


def test_path_entry_to_string_and_sample_obs_match_jax():
    """A path entry renders as the JAX key-path entry does; ``sample_obs``
    gives the JAX function's batched shapes and dtypes on the port's spaces
    and on gymnasium's."""
    entries = (jax.tree_util.DictKey("wq"), jax.tree_util.SequenceKey(3),
               jax.tree_util.GetAttrKey("mu"))
    assert [TTP.path_entry_to_string(k) for k in ("wq", 3, "mu")] == [
        JTP.path_entry_to_string(k) for k in entries]

    gym = pytest.importorskip("gymnasium")
    box = dict(low=-1.0, high=1.0, shape=(3,))
    j_space = gym.spaces.Dict({"a": gym.spaces.Box(**box), "b": gym.spaces.Discrete(4)})
    want = JS.sample_obs(j_space, batch=5)
    for space in (TS.Dict({"a": TS.Box(**box), "b": TS.Discrete(4)}), j_space):
        got = TS.sample_obs(space, batch=5)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    got = TS.sample_obs(TS.Tuple([TS.Box(**box), TS.Discrete(2)]), batch=2)
    assert [x.shape for x in got] == [(2, 3), (2,)]


def test_continuous_generator_admission_knobs_set_the_policy():
    """The four admission knobs read and set ``ContinuousGenerator.admission``,
    as the JAX generator's properties do."""
    gen = ContinuousGenerator(CFG, max_new_tokens=2, prompt_buckets=(8,), slots=2,
                              block_size=4, max_queue=7, ttft_slo_s=0.5, device="cpu")
    assert (gen.max_queue, gen.ttft_slo_s) == (7, 0.5)
    gen.max_queue, gen.ttft_slo_s, gen.min_slo_samples, gen.free_block_watermark = 3, 2.0, 5, 0.25
    adm = gen.admission
    assert (adm.max_queue, adm.ttft_slo_s, adm.min_slo_samples,
            adm.free_block_watermark) == (3, 2.0, 5, 0.25)
    assert gen.min_slo_samples == 5 and gen.free_block_watermark == 0.25
