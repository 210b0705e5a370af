"""The port's runtime guards (``agilerl_tpu_torch/analysis/runtime.py``)
against the JAX package's: ``SyncGuard`` counts the same conversions as the
JAX guard on the same region (the cases of
``tests/test_analysis/test_runtime_guards.py``), ``CompileGuard(gen)`` reads
the same program counts as the JAX guard over the same bucket stream, the
global mode counts nvcc builds, and the failure modes raise alike. Also the
dogfood fix the port's linter found: ``ContinuousGenerator`` reads its
admission prefills back in one copy per field."""

import os

import numpy as np
import pytest
import torch

from agilerl_tpu_torch.analysis import (
    CompileGuard,
    CompileGuardError,
    SyncGuard,
    SyncGuardError,
)
from agilerl_tpu_torch.observability import MetricsRegistry

torch.set_num_threads(1)


def _jax():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from agilerl_tpu.analysis import runtime as JR

    return jax, jnp, JR


# -- SyncGuard: the same region through both guards ------------------------- #


def _region(case, xp, asarray, arange):
    """The body of one JAX guard test, written once for jnp and torch."""
    if case == "each_kind":
        x, v = asarray(1.5), arange(3)
        float(x)
        int(x)
        bool(x > 0)
        x.item()
        v.tolist()
    elif case == "stays_on_device":
        v = arange(8)
        w = v * 2 + 1
        _ = xp.sum(w)
    elif case == "numpy_values":
        float(np.float32(1.0))
        int(np.int64(3))
        _ = np.arange(4).tolist()
    elif case == "two_floats":
        x = asarray(3.0)
        float(x)
        int(x)


@pytest.mark.parametrize("case", ["each_kind", "stays_on_device", "numpy_values", "two_floats"])
def test_sync_guard_counts_like_the_jax_guard(case):
    jax, jnp, JR = _jax()
    with JR.SyncGuard() as want:
        _region(case, jnp, jnp.asarray, jnp.arange)
    with SyncGuard(device="cpu") as got:
        _region(case, torch, torch.tensor, torch.arange)
    assert got.syncs == want.syncs and got.by_kind == want.by_kind
    assert got.conversions == got.syncs and got.runtime_syncs is None and got.sites == {}


def test_sync_guard_budget_raises_and_names_kinds_like_the_jax_guard():
    jax, jnp, JR = _jax()
    with pytest.raises(JR.SyncGuardError, match="__float__"):
        with JR.SyncGuard(max_syncs=0, label="hot-loop"):
            float(jnp.asarray(2.0))
    with pytest.raises(SyncGuardError, match=r"\[hot-loop\].*__float__"):
        with SyncGuard(max_syncs=0, label="hot-loop", device="cpu"):
            float(torch.tensor(2.0))
    with SyncGuard(max_syncs=1, device="cpu") as sg:
        float(torch.tensor(2.0))
    assert sg.syncs == 1


def test_sync_guard_emits_host_syncs_total():
    reg = MetricsRegistry()
    x = torch.tensor(3.0)
    with SyncGuard(registry=reg, device="cpu"):
        float(x)
        int(x)
    assert reg.counter("analysis/host_syncs_total").value == 2


def test_sync_guard_restores_methods_and_counts_only_inside():
    x = torch.tensor(4.0)
    before = {n: torch.Tensor.__dict__.get(n) for n in ("__float__", "item", "__bool__")}
    impl_float = type(x).__float__
    with SyncGuard(device="cpu") as sg:
        float(x)
        assert "__float__" in torch.Tensor.__dict__
    assert sg.syncs == 1
    float(x)
    assert sg.syncs == 1
    assert type(x).__float__ is impl_float
    assert {n: torch.Tensor.__dict__.get(n) for n in before} == before


def test_sync_guard_nests_like_the_jax_guard():
    jax, jnp, JR = _jax()
    for G, mk, kw in ((JR.SyncGuard, jnp.asarray, {}), (SyncGuard, torch.tensor, {"device": "cpu"})):
        x = mk(5.0)
        with G(**kw) as outer:
            float(x)
            with G(**kw) as inner:
                float(x)
            float(x)
        assert (inner.syncs, outer.syncs) == (1, 3)


def test_sync_guard_body_exception_wins_and_restores():
    with pytest.raises(RuntimeError, match="body failed"):
        with SyncGuard(max_syncs=0, device="cpu"):
            float(torch.tensor(1.0))
            raise RuntimeError("body failed")
    assert "__float__" not in torch.Tensor.__dict__


def test_sync_guard_on_a_cuda_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyncGuard(device="cuda")
    assert SyncGuard().cuda is False


@pytest.mark.cuda
def test_sync_guard_counts_the_runtime_syncs_by_site_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a GPU")
    x = torch.arange(8, device="cuda", dtype=torch.float32)
    with SyncGuard(max_syncs=0) as quiet:
        y = (x * 2).sum()
    assert quiet.syncs == 0 and quiet.cuda
    with SyncGuard() as sg:
        float(y)
        x.cpu()
        x.nonzero()
    assert sg.syncs >= 3 and sg.by_kind == {"__float__": 1}
    assert sum(sg.sites.values()) == sg.runtime_syncs == sg.syncs
    assert torch.cuda.get_sync_debug_mode() == 0


# -- CompileGuard ------------------------------------------------------------ #


class _Counted:
    def __init__(self, n=0):
        self.compiled_programs = n


def test_compile_guard_explicit_and_sizer_modes():
    obj = _Counted(3)
    with CompileGuard(obj) as guard:
        pass
    assert guard.new_compilations == 0 and not guard.global_mode
    with pytest.raises(CompileGuardError, match=r"\[churn\]: 1 new compiled program"):
        with CompileGuard(obj, label="churn"):
            obj.compiled_programs += 1
    with CompileGuard(obj, max_new=1) as guard:
        obj.compiled_programs += 1
    assert guard.new_compilations == 1
    with CompileGuard(sizer=lambda: obj.compiled_programs) as guard:
        pass
    assert guard.new_compilations == 0


def test_compile_guard_failure_modes_match_the_jax_guard():
    jax, jnp, JR = _jax()
    for G, E in ((JR.CompileGuard, JR.CompileGuardError), (CompileGuard, CompileGuardError)):
        counts = iter([5, 2])
        with pytest.raises(E, match="shrank 5→2"):
            with G(sizer=lambda: next(counts)):
                pass
        counts = iter([3, -1])
        with pytest.raises(E, match="-1 sentinel at exit"):
            with G(sizer=lambda: next(counts)):
                pass
        with pytest.raises(ValueError, match="not both"):
            G(_Counted(), sizer=lambda: 0)
    obj = _Counted(1)
    with pytest.raises(RuntimeError, match="body failed"):
        with CompileGuard(obj):
            obj.compiled_programs += 1
            raise RuntimeError("body failed")


def test_compile_guard_emits_recompilations_total():
    reg = MetricsRegistry()
    obj = _Counted()
    with pytest.raises(CompileGuardError):
        with CompileGuard(obj, registry=reg):
            obj.compiled_programs += 1
    assert reg.counter("analysis/recompilations_total").value == 1


def test_object_without_accounting_falls_back_to_global_mode():
    with CompileGuard(object()) as guard:
        pass
    assert guard.global_mode and guard.new_compilations == 0


def test_global_mode_counts_nvcc_builds(tmp_path, monkeypatch):
    from agilerl_tpu_torch.ops import _build
    from agilerl_tpu_torch.parallel import compile_cache as CC
    from tests.torch_fake_nvcc import install_fake_nvcc, system_library

    if system_library() is None:
        pytest.skip("no system shared library for the stand-in nvcc")
    bin_dir = install_fake_nvcc(tmp_path / "nvcc")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setenv(CC.CACHE_ENV, str(tmp_path / "store"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_STORES", {})
    with pytest.raises(CompileGuardError, match="2 new compiled program"):
        with CompileGuard(object(), label="cold"):
            _build.build_all(["flash_attention_fwd", "fused_logprob_fwd"])
    _build._LIBS.clear()
    with CompileGuard() as guard:
        _build.build_all(["flash_attention_fwd", "fused_logprob_fwd"])
    assert guard.new_compilations == 0


# -- CompileGuard(gen) against the JAX guard over one bucket stream ----------- #

VOCAB = 96
KW = dict(vocab_size=VOCAB, n_layer=1, n_head=2, n_kv_head=1, d_model=16, max_seq_len=128)
BUCKETED = dict(max_new_tokens=6, pad_id=0, prompt_buckets=(16, 32, 48), row_buckets=(2, 4),
                decode_chunk=3, temperature=0.0)


def _ragged(rng, n, lo, hi):
    return [rng.integers(3, 95, size=rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]


def test_compile_guard_reads_the_jax_counts_over_one_bucket_stream():
    jax, jnp, JR = _jax()
    from agilerl_tpu.llm import model as JM
    from agilerl_tpu.llm import serving as JS
    from agilerl_tpu.observability import MetricsRegistry as JRegistry
    from agilerl_tpu_torch.llm import model as TM
    from agilerl_tpu_torch.llm import serving as TS
    from agilerl_tpu_torch.llm.convert import params_from_numpy

    jcfg = JM.GPTConfig(dtype=jnp.float32, **KW)
    tcfg = TM.GPTConfig(dtype=torch.float32, **KW)
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = params_from_numpy(params, tcfg, device="cpu")
    jgen = JS.BucketedGenerator(jcfg, metrics=JRegistry(), **BUCKETED)
    tgen = TS.BucketedGenerator(tcfg, metrics=MetricsRegistry(), device="cpu", **BUCKETED)
    rng = np.random.default_rng(0)
    warm = [_ragged(rng, 2, 4, 14), _ragged(rng, 3, 18, 30)]
    steady = [_ragged(rng, 2, 4, 14), _ragged(rng, 4, 20, 28), _ragged(rng, 1, 3, 9)]
    planted = _ragged(rng, 2, 36, 44)  # a prompt bucket the warm-up never used

    def one(batch, budget):
        reads = []
        for guard, run in ((JR.CompileGuard(sizer=lambda: jgen.compiled_programs, max_new=budget),
                            lambda: jgen.generate(batch, jax.random.PRNGKey(0), params,
                                                  greedy=True)),
                           (CompileGuard(tgen, max_new=budget),
                            lambda: tgen.generate(batch, None, tparams, greedy=True))):
            try:
                with guard:
                    run()
            except (JR.CompileGuardError, CompileGuardError) as e:
                reads.append(("raised", guard.new_compilations, type(e).__name__))
            else:
                reads.append(("ok", guard.new_compilations, None))
        return reads

    first = [one(b, budget=4) for b in warm]
    assert all(j[:2] == t[:2] and j[1] > 0 for j, t in first)
    for batch in steady:
        j, t = one(batch, budget=0)
        assert j == ("ok", 0, None) and t == ("ok", 0, None)
    j, t = one(planted, budget=0)
    assert j[:2] == t[:2] == ("raised", 2)  # its prefill and its decode chunk
    assert t[2] == "CompileGuardError"
    assert tgen.compiled_programs == jgen.compiled_programs


# -- the dogfood fix ---------------------------------------------------------- #


def _count_copies(monkeypatch):
    """Count every ``Tensor.cpu()`` and ``Tensor.numpy()`` call (``np.asarray``
    of a tensor goes through ``numpy()``): the device->host copies that
    ``SyncGuard``'s CPU catalogue of conversions does not see."""
    counts = {"cpu": 0, "numpy": 0}
    for name in counts:
        orig = getattr(torch.Tensor, name)

        def copy(self, *args, _orig=orig, _name=name, **kwargs):
            counts[_name] += 1
            return _orig(self, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, name, copy)
    return counts


@pytest.mark.parametrize("capture", [False, True])
def test_admission_reads_its_prefills_in_one_copy_per_field(capture, monkeypatch):
    """GX001 found one device->host read per admitted request and field
    (``int(tok0)``, ``bool(done0)``, ``key_next.cpu()``, ``float(lp0)``);
    the pass now copies each field once for every request it admitted, so
    a step's copies and conversions do not grow with the requests."""
    from agilerl_tpu_torch.llm import model as TM
    from agilerl_tpu_torch.llm import serving as TS

    cfg = TM.GPTConfig(dtype=torch.float32, **KW)
    params = TM.init_params(0, cfg, device="cpu")
    conversions, copies, outs = {}, {}, {}
    for k in (1, 4):
        gen = TS.ContinuousGenerator(cfg, slots=4, block_size=8, max_new_tokens=6,
                                     prompt_buckets=(16, 32), decode_chunk=3,
                                     capture_logprobs=capture, device="cpu",
                                     metrics=MetricsRegistry())
        rng = np.random.default_rng(0)
        tickets = [gen.submit(rng.integers(3, 95, size=10).astype(np.int32)) for _ in range(k)]
        with monkeypatch.context() as m:
            counts = _count_copies(m)
            with SyncGuard(device="cpu") as sg:
                gen.step(params, greedy=True)
        conversions[k], copies[k] = sg.syncs, dict(counts)
        gen.run_until_drained(params, greedy=True)
        outs[k] = [gen.result(t) for t in tickets]
    assert conversions[1] == conversions[4] == 0
    assert copies[1] == copies[4], copies
    assert copies[1]["cpu"] >= 3 + capture  # tok0, done0, key_next (and lp0)
    # the first request is served alike alone and beside three others
    for a, b in zip(outs[1][0], outs[4][0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
