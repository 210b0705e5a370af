"""The port's compile cache (``agilerl_tpu_torch/parallel/compile_cache.py``):
the store of the nvcc-built kernel libraries. A stand-in nvcc on ``PATH``
(``tests/torch_fake_nvcc.py``) builds on the CPU. Key skew (flags, nvcc
version, a header, the compute capability) misses; a torn or corrupt entry
is skipped, counted and never loaded; a library that fails to load is
rebuilt; GC keeps the newest entry; the env opt-in; ``_build`` goes through
the store; a process without nvcc loads what the store holds and builds
nothing; each build's ``compile_s`` is its own; the pure parts against the
JAX module; the eager consumers raise."""

import json
import os
import shutil

import pytest
import torch

from agilerl_tpu_torch.analysis import CompileGuard, CompileGuardError
from agilerl_tpu_torch.observability import MetricsRegistry
from agilerl_tpu_torch.ops import _build
from agilerl_tpu_torch.parallel import compile_cache as CC
from agilerl_tpu_torch.resilience.store import committed_entries, read_manifest
from tests.torch_fake_nvcc import calls, install_fake_nvcc, system_library

NAMES = ["flash_attention_fwd", "fused_logprob_fwd", "flash_attention_bwd", "fused_logprob_bwd"]

@pytest.fixture
def fake(tmp_path, monkeypatch):
    """A stand-in nvcc first on PATH, an empty default store under
    ``tmp_path`` (through the env opt-in) and fresh loaded-library tables."""
    if system_library() is None:
        pytest.skip("no system shared library for the stand-in nvcc to copy")
    bin_dir = install_fake_nvcc(tmp_path / "nvcc")
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    monkeypatch.setenv(CC.CACHE_ENV, str(tmp_path / "store"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_STORES", {})
    return tmp_path


def _counter(reg, name):
    return reg.counter(name).value


def _store(path, reg=None):
    return CC.ExecutableStore(path, metrics=reg if reg is not None else MetricsRegistry())


def _fingerprints(store):
    """Digests with at least one committed entry."""
    return [d.name[len("fp_"):] for d in sorted(store.directory.iterdir())
            if d.is_dir() and d.name.startswith("fp_") and committed_entries(d, "lib_")]


def _payload(store, digest):
    got = store.get_entry(digest)
    return None if got is None else got[1]


# --------------------------------------------------------------------------- #
# The key
# --------------------------------------------------------------------------- #


def test_changed_nvcc_flags_give_a_new_target_without_nvcc(monkeypatch):
    """``_target`` only hashes: no nvcc is needed, and another flag is
    another library."""
    monkeypatch.setattr(_build, "nvcc_version", lambda: None)
    _, before = _build._target("flash_attention_fwd")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    _, after = _build._target("flash_attention_fwd")
    assert before != after
    assert _build.library_path("flash_attention_fwd").name.endswith(after)


def test_changed_nvcc_version_gives_a_new_target(tmp_path, monkeypatch):
    if system_library() is None:
        pytest.skip("no system shared library for the stand-in nvcc to copy")
    keys = []
    for version in ("Cuda compilation tools, release 12.8", "Cuda compilation tools, release 12.9"):
        bin_dir = install_fake_nvcc(tmp_path / version.split()[-1], version)
        monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}/usr/bin:/bin")
        assert CC.nvcc_version() == version
        keys.append(_build._target("fused_logprob_bwd")[1])
    assert keys[0] != keys[1]


def test_key_skew_in_every_component_misses(tmp_path, monkeypatch):
    """The name, the source, every included header (through another
    header), the flags, nvcc, torch / CUDA versions and the capability are
    each a key; the checkout's own csrc path is not."""
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    kw = dict(nvcc="nvcc 12.9", versions={"torch": "2.11", "cuda": "12.8"}, capability=[9, 0])
    base = CC.fingerprint_digest(CC.fingerprint_parts("k", **kw))
    parts = CC.fingerprint_parts("k", **kw)
    assert parts["headers"].keys() == {"a.cuh", "b.cuh"}
    assert parts["nvcc_flags"].count("<csrc>") == 0  # the flags name the real csrc
    skews = [dict(kw, nvcc="nvcc 13.0"), dict(kw, versions={"torch": "2.12", "cuda": "12.8"}),
             dict(kw, versions={"torch": "2.11", "cuda": "13.0"}), dict(kw, capability=[8, 0]),
             dict(kw, flags=["-O2"])]
    digests = {CC.fingerprint_digest(CC.fingerprint_parts("k", **s)) for s in skews}
    assert base not in digests and len(digests) == len(skews)
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert CC.fingerprint_digest(CC.fingerprint_parts("k", **kw)) != base
    (tmp_path / "j.cu").write_text('#include "a.cuh"\nint x;\n')
    assert CC.fingerprint_parts("j", **kw)["name"] == "j"


def test_checkout_path_is_not_a_key(monkeypatch):
    csrc = str(_build.CSRC_DIR)
    assert CC.key_flags(_build.NVCC_FLAGS).count("<csrc>") == 1
    assert csrc not in CC.key_flags(_build.NVCC_FLAGS)


def test_kernel_loading_does_not_import_parallel():
    """The store lives under ``ops/`` beside the kernels that load through
    it: keying and loading a library pulls in no ``parallel`` module."""
    import subprocess
    import sys

    code = ("import sys\n"
            "from agilerl_tpu_torch.ops import _build, flash_attention_vjp, fused_loss\n"
            "_build.fingerprint_parts('flash_attention_fwd')\n"
            "print(sorted(m for m in sys.modules if m.startswith('agilerl_tpu_torch.parallel')))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(_build.PKG_DIR.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_digest_matches_the_jax_module():
    pytest.importorskip("jax")
    from agilerl_tpu.parallel import compile_cache as JCC

    parts = CC.fingerprint_parts("flash_attention_fwd", nvcc="v", versions={"torch": "t"},
                                 capability=None)
    assert CC.fingerprint_digest(parts) == JCC.fingerprint_digest(parts)
    assert CC.CACHE_ENV == JCC.CACHE_ENV


# --------------------------------------------------------------------------- #
# The store through _build
# --------------------------------------------------------------------------- #


def test_cold_build_then_warm_load_with_zero_builds(fake):
    store = _store(fake / "store")
    builds = CC.build_count()
    logs = _build.build_all(NAMES, store=store)
    assert CC.build_count() - builds == 4 == calls(fake / "nvcc")
    assert all("ptxas info" in logs[n] for n in NAMES)
    assert _counter(store.metrics, "compile_cache/misses_total") == 4
    assert store.metrics.histogram("compile_cache/compile_s", CC.CACHE_TIME_BUCKETS).count == 4
    assert len(_fingerprints(store)) == 4
    # a second process's view: a fresh store object and no loaded library
    _build._LIBS.clear()
    warm = _store(fake / "store")
    with CompileGuard(label="warm load") as guard:
        logs = _build.build_all(NAMES, store=warm)
    assert guard.new_compilations == 0 and calls(fake / "nvcc") == 4
    assert logs == {n: "" for n in NAMES}
    assert _counter(warm.metrics, "compile_cache/hits_total") == 4
    assert warm.metrics.histogram("compile_cache/load_s", CC.CACHE_TIME_BUCKETS).count == 4
    manifest = read_manifest(warm.entries(CC.fingerprint_digest(CC.fingerprint_parts(NAMES[0])))[-1])
    assert manifest["fingerprint"]["name"] == NAMES[0] and "library.so" in manifest["files"]


def test_a_process_without_nvcc_loads_the_store_and_never_builds(fake, monkeypatch):
    """Without nvcc the toolchain's part of the key is unknown: the newest
    stored library that matches every other part is loaded, and a library
    the store does not hold raises instead of building."""
    store = _store(fake / "store")
    _build.build_all(["fused_logprob_fwd"], store=store)
    built = CC.fingerprint_digest(CC.fingerprint_parts("fused_logprob_fwd"))

    def no_nvcc():
        raise RuntimeError("nvcc not found: stand-in")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    assert CC.nvcc_version() is None
    warm = _store(fake / "store")
    with CompileGuard(label="no nvcc"):
        lib, info = CC.load_or_compile("fused_logprob_fwd", store=warm)
    assert lib is not None and info["hit"] and info["fingerprint"] == built
    assert calls(fake / "nvcc") == 1
    with pytest.raises(RuntimeError, match="nvcc not found"):
        CC.load_or_compile("flash_attention_fwd", store=warm)
    # another flag is another key for a process without nvcc too
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        CC.load_or_compile("fused_logprob_fwd", store=_store(fake / "store"))
    assert CC.build_count() >= 1 and calls(fake / "nvcc") == 1


def test_compile_s_is_each_builds_own_wall_time(tmp_path, monkeypatch):
    """Builds of one batch run together and are waited on together; each
    one's ``compile_s`` ends when its own nvcc does, not when the builds
    listed before it have been reaped."""
    if system_library() is None:
        pytest.skip("no system shared library for the stand-in nvcc to copy")
    bin_dir = install_fake_nvcc(tmp_path / "nvcc", delays={"fused_logprob_bwd": 2.0})
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ.get('PATH', '')}")
    store = _store(tmp_path / "store")
    got = CC.load_or_compile_all(["fused_logprob_bwd", "fused_logprob_fwd"], store=store)
    slow, fast = got["fused_logprob_bwd"][1], got["fused_logprob_fwd"][1]
    assert slow["compile_s"] >= 2.0 and fast["compile_s"] < 1.5
    assert store.metrics.histogram("compile_cache/compile_s", CC.CACHE_TIME_BUCKETS).count == 2


def test_load_library_goes_through_the_default_store(fake):
    lib = _build.load_library("fused_logprob_fwd")
    assert _build.load_library("fused_logprob_fwd") is lib and calls(fake / "nvcc") == 1
    path = _build.library_path("fused_logprob_fwd")
    assert path.name == CC.LIBRARY_FILE and path.is_relative_to(fake / "store")
    _build._LIBS.clear()
    _build._STORES.clear()
    with CompileGuard():
        _build.load_library("fused_logprob_fwd")
    with pytest.raises(CompileGuardError, match="1 new compiled program"):
        with CompileGuard(label="a cold library"):
            _build.load_library("flash_attention_bwd")


def _plant_torn(store, digest, how):
    """A NEWER entry than the good one, copied from it and then damaged."""
    good = store.entries(digest)[-1]
    bad = good.with_name(good.name[:-8] + "00000009")
    shutil.copytree(good, bad)
    if how == "torn":
        lib = bad / CC.LIBRARY_FILE
        lib.write_bytes(lib.read_bytes()[:100])   # truncated mid-write
    elif how == "sha":
        lib = bad / CC.LIBRARY_FILE
        data = bytearray(lib.read_bytes())
        data[-1] ^= 0xFF                          # same size, other bytes
        lib.write_bytes(bytes(data))
    elif how == "manifest":
        (bad / "manifest.json").unlink()
    return good, bad


@pytest.mark.parametrize("how", ["torn", "sha", "manifest"])
def test_torn_entries_are_skipped_counted_and_never_loaded(fake, how):
    store = _store(fake / "store")
    _build.build_all(["fused_logprob_fwd"], store=store)
    digest = CC.fingerprint_digest(CC.fingerprint_parts("fused_logprob_fwd"))
    good, bad = _plant_torn(store, digest, how)
    warm = _store(fake / "store")
    with CompileGuard():
        lib, info = CC.load_or_compile("fused_logprob_fwd", store=warm)
    assert info["hit"] and info["path"] == str(good / CC.LIBRARY_FILE)
    assert _counter(warm.metrics, "compile_cache/torn_entries_total") == 1
    # with only the damaged entry left, a probe misses and loads nothing
    shutil.rmtree(good)
    probe = _store(fake / "store")
    assert probe.get_entry(digest) is None
    assert _counter(probe.metrics, "compile_cache/torn_entries_total") == 1
    # and a real call rebuilds and republishes (GC then drops the torn one)
    lib, info = CC.load_or_compile("fused_logprob_fwd", store=probe)
    assert info.get("published") and calls(fake / "nvcc") == 2
    assert [e.name for e in probe.entries(digest)] == [info["path"].split("/")[-2]]


def test_library_that_fails_to_load_is_rebuilt(fake):
    store = _store(fake / "store")
    digest = CC.fingerprint_digest(CC.fingerprint_parts("flash_attention_fwd"))
    # sha-valid, but not a shared library (an artifact of another host)
    store.publish(digest, {"name": "flash_attention_fwd", "nvcc_log": ""}, b"not an ELF file")
    builds = CC.build_count()
    lib, info = CC.load_or_compile("flash_attention_fwd", store=store)
    assert lib is not None and not info["hit"] and info["published"]
    assert CC.build_count() - builds == 1
    assert _counter(store.metrics, "compile_cache/deserialize_failures_total") == 1
    assert _counter(store.metrics, "compile_cache/torn_entries_total") == 0
    _, info = CC.load_or_compile("flash_attention_fwd", store=_store(fake / "store"))
    assert info["hit"]


def test_gc_keeps_the_newest_entry_per_fingerprint(tmp_path):
    store = _store(tmp_path / "store")
    for i in range(3):
        store.publish("a" * 64, {"i": i}, bytes([i]) * 8)
    store.publish("b" * 64, {"i": 9}, b"b")
    assert len(store.entries("a" * 64)) == 1 and _payload(store, "a" * 64) == {"i": 2}
    assert _payload(store, "b" * 64) == {"i": 9}
    assert sorted(_fingerprints(store)) == ["a" * 64, "b" * 64]


def test_gc_matches_the_jax_store(tmp_path):
    """The JAX store's GC on its own entries keeps the same newest entry
    (its executable load is not used here)."""
    pytest.importorskip("jax")
    from agilerl_tpu.observability import MetricsRegistry as JRegistry
    from agilerl_tpu.parallel import compile_cache as JCC

    ours = _store(tmp_path / "ours")
    theirs = JCC.ExecutableStore(tmp_path / "theirs", metrics=JRegistry())
    for i in range(3):
        ours.publish("d" * 64, {"i": i}, b"x")
        theirs.publish("d" * 64, {"i": i})
    assert _payload(ours, "d" * 64) == theirs.get_payload("d" * 64) == {"i": 2}
    assert _fingerprints(ours) == theirs.fingerprints() == ["d" * 64]


def test_env_opt_in_and_resolve_cache_match_the_jax_module(tmp_path, monkeypatch):
    pytest.importorskip("jax")
    from agilerl_tpu.parallel import compile_cache as JCC

    monkeypatch.delenv(CC.CACHE_ENV, raising=False)
    monkeypatch.setattr(_build, "_STORES", {})
    assert CC.resolve_cache(None) is None and JCC.resolve_cache(None) is None
    assert CC.default_store().directory == _build.BUILD_DIR
    monkeypatch.setenv(CC.CACHE_ENV, str(tmp_path / "env"))
    got, want = CC.resolve_cache(None), JCC.resolve_cache(None)
    assert got.directory == want.directory == tmp_path / "env"
    assert CC.resolve_cache(got) is got and CC.resolve_cache(None) is got
    assert CC.resolve_cache(str(tmp_path / "p")).directory == tmp_path / "p"
    assert CC.default_store() is got


def test_compile_cache_metric_and_span_names_match_the_jax_module(fake):
    from agilerl_tpu_torch.observability import MemorySink, Tracer, span_records

    sink = MemorySink()
    tracer = Tracer(sink=sink)
    store = CC.ExecutableStore(fake / "store", metrics=MetricsRegistry(), tracer=tracer)
    CC.load_or_compile("fused_logprob_bwd", store=store)
    CC.load_or_compile("fused_logprob_bwd", store=CC.ExecutableStore(
        fake / "store", metrics=store.metrics, tracer=tracer))
    names = [r["name"] for r in span_records(sink.events)]
    assert names == ["compile_cache.compile", "compile_cache.load"]
    dump = json.dumps(store.metrics.snapshot())
    for metric in ("compile_cache/hits_total", "compile_cache/misses_total",
                   "compile_cache/load_s", "compile_cache/compile_s"):
        assert metric in dump


def test_nvcc_failure_raises_and_publishes_nothing(fake, monkeypatch):
    monkeypatch.setattr(_build, "NVCC_FLAGS", ["--no-such-flag"])
    bin_dir = fake / "broken" / "bin"
    bin_dir.mkdir(parents=True)
    (bin_dir / "nvcc").write_text("#!/bin/sh\n[ \"$1\" = --version ] && echo broken && exit 0\n"
                                  "echo 'nvcc fatal: bad flag'; exit 1\n")
    (bin_dir / "nvcc").chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    store = _store(fake / "store")
    with pytest.raises(RuntimeError, match="nvcc failed for fused_logprob_fwd.cu"):
        _build.build_all(["fused_logprob_fwd"], store=store)
    assert _fingerprints(store) == []


# --------------------------------------------------------------------------- #
# The decision line: the XLA-executable consumers raise
# --------------------------------------------------------------------------- #


def test_eager_consumers_raise_not_implemented():
    from agilerl_tpu_torch.llm import model as TM
    from agilerl_tpu_torch.llm.serving import ContinuousGenerator
    from agilerl_tpu_torch.parallel.plan import compile_step_with_plan, make_grpo_plan

    with pytest.raises(NotImplementedError, match="eagerly"):
        CC.CachedFunction(lambda x: x, name="f", store=None)
    with pytest.raises(NotImplementedError, match="cache="):
        compile_step_with_plan(lambda x: x, make_grpo_plan(), (None,), cache="/tmp/x")
    cfg = TM.GPTConfig(vocab_size=17, n_layer=1, n_head=2, d_model=8, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="compile_cache"):
        ContinuousGenerator(cfg, device="cpu", compile_cache="/tmp/x")
