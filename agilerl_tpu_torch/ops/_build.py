"""Build ``agilerl_tpu_torch/csrc/*.cu`` with nvcc at first use, keep each
library in a store of compiled programs, and load it with ctypes.

Each source is one shared library with a plain C interface (no PyTorch
headers), so a build takes seconds. The store is the port's compile cache
(re-exported as :mod:`agilerl_tpu_torch.parallel.compile_cache`, the JAX
module's name), with the JAX module's contract:

- :class:`ExecutableStore` — an on-disk registry layered on the shared
  commit-dir protocol (:class:`~agilerl_tpu_torch.resilience.store.CommitDirStore`):
  every entry (the library file, a payload with nvcc's log, a manifest with
  the fingerprint) is atomically published, sha-validated on read (the
  library file included), torn entries are skipped and counted
  (``compile_cache/torn_entries_total``; never loaded), and publishing keeps
  only the newest entry of its fingerprint.
- :func:`fingerprint_parts` / :func:`fingerprint_digest` — the strict key:
  the kernel's name, the sha256 of its source and of every ``csrc/`` header
  it includes (``#include "name.cuh"``, followed through the headers),
  ``NVCC_FLAGS``, the output of ``nvcc --version``, the torch and CUDA
  versions, and the card's compute capability. Any mismatch is a MISS, so
  an edited source or header, another flag or another toolchain is rebuilt
  and a stale or torn library is never loaded.
- :func:`load_or_compile` / :func:`load_or_compile_all` — load the stored
  library or run nvcc, publish and load; ``load_or_compile_all`` (and
  :func:`build_all`) starts one nvcc per missing source, all at once. A
  stored library that fails to load is rebuilt and republished with a
  warn-once and ``compile_cache/deserialize_failures_total``. Every nvcc
  build raises :func:`build_count`, which ``CompileGuard()`` reads.
- A process without nvcc cannot read its toolchain's part of the key: it
  loads the newest stored library whose manifest matches every other part
  (built by whichever nvcc), and raises ``nvcc not found`` when there is
  none. It never builds.
- :func:`resolve_cache` — the ``cache=`` argument's normal form and the one
  reader of ``AGILERL_TPU_COMPILE_CACHE``; that store, else
  ``agilerl_tpu_torch/_build/`` (listed in ``.gitignore``), is the one the
  kernel wrappers load through (:func:`default_store`).

Hits and misses are visible in the registry (``compile_cache/{hits,
misses}_total``, ``compile_cache/{load_s,compile_s}`` histograms) and as
``compile_cache.load`` / ``compile_cache.compile`` trace spans, the JAX
module's names. ``compile_s`` is one build's own wall time, from its nvcc's
start to its end, while the other builds of its batch run beside it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import json
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import torch

from agilerl_tpu_torch.resilience.atomic import CorruptSnapshotError
from agilerl_tpu_torch.resilience.store import (
    CommitDirStore,
    committed_entries,
    entry_seq,
    read_manifest,
)

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC_DIR)]
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

#: environment opt-in: the store directory the kernel wrappers load through
#: (``BUILD_DIR`` otherwise)
CACHE_ENV = "AGILERL_TPU_COMPILE_CACHE"

#: wall-time buckets for the load/compile histograms — loads take
#: milliseconds, an nvcc build seconds to minutes
CACHE_TIME_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 5.0,
                      10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

#: the library file inside an entry, beside ``payload.pkl`` and the manifest
LIBRARY_FILE = "library.so"

_FP_PREFIX = "fp_"
_ENTRY_PREFIX = "lib_"
_CSRC_TOKEN = "<csrc>"

_LIBS: Dict[str, ctypes.CDLL] = {}
_STORES: Dict[str, "ExecutableStore"] = {}

_builds = 0
_builds_lock = threading.Lock()


def build_count() -> int:
    """nvcc builds this process has started through the store (what
    ``CompileGuard()``'s global mode counts)."""
    return _builds


def _count_build() -> None:
    global _builds
    with _builds_lock:
        _builds += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of agilerl_tpu_torch "
                       "are built from source at first use")


def local_includes(src: Path) -> List[Path]:
    """The headers of ``csrc/`` that ``src`` includes, directly or through
    another header, in the order first met."""
    found: List[Path] = []
    todo = [src]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            path = CSRC_DIR / inc
            if not path.exists():
                raise FileNotFoundError(f"{path} (included by {src.name})")
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


# --------------------------------------------------------------------------- #
# Fingerprint — the strict cache key
# --------------------------------------------------------------------------- #


def _sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


@functools.lru_cache(maxsize=None)
def _nvcc_version_of(path: str, mtime_ns: int, size: int) -> str:
    out = subprocess.run([path, "--version"], capture_output=True, text=True,
                         timeout=120)
    if out.returncode != 0:
        raise RuntimeError(f"{path} --version exited {out.returncode}: {out.stderr}")
    return out.stdout.strip()


def nvcc_version() -> Optional[str]:
    """``nvcc --version``'s output (read once per nvcc binary), or None when
    there is no nvcc."""
    try:
        path = _nvcc()
    except RuntimeError:
        return None
    st = os.stat(path)
    return _nvcc_version_of(path, st.st_mtime_ns, st.st_size)


def runtime_versions() -> Dict[str, Optional[str]]:
    """torch and CUDA versions — the libraries are loaded into this torch's
    CUDA runtime."""
    return {"torch": torch.__version__, "cuda": torch.version.cuda}


def device_capability() -> Optional[List[int]]:
    """The card's compute capability, or None without one."""
    if not torch.cuda.is_available():
        return None
    return list(torch.cuda.get_device_capability())


def key_flags(flags: Iterable[str]) -> List[str]:
    """nvcc's flags as keyed: the checkout's own ``csrc/`` include path is
    replaced by a token (its headers are keyed by content), so a store
    serves any checkout of the same sources."""
    csrc = str(CSRC_DIR)
    return [_CSRC_TOKEN if f == csrc else str(f) for f in flags]


_AUTO = object()


def fingerprint_parts(
    name: str,
    *,
    flags: Optional[Iterable[str]] = None,
    nvcc: Any = _AUTO,
    versions: Optional[Dict[str, Optional[str]]] = None,
    capability: Any = _AUTO,
) -> Dict[str, Any]:
    """The full fingerprint record of ``csrc/<name>.cu`` (also written into
    the entry's manifest, so provenance is readable without unpickling).
    Skew in ANY component changes the digest. The defaults read the live
    build: ``NVCC_FLAGS``, :func:`nvcc_version`, :func:`runtime_versions`,
    :func:`device_capability`."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    return {
        "name": str(name),
        "source_sha256": _sha256_bytes(src.read_bytes()),
        "headers": {inc.name: _sha256_bytes(inc.read_bytes())
                    for inc in local_includes(src)},
        "nvcc_flags": key_flags(NVCC_FLAGS if flags is None else flags),
        "nvcc_version": nvcc_version() if nvcc is _AUTO else nvcc,
        "versions": dict(versions if versions is not None else runtime_versions()),
        "capability": device_capability() if capability is _AUTO else capability,
    }


def fingerprint_digest(parts: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(parts, sort_keys=True, default=str).encode("utf-8")).hexdigest()


def _target(name: str) -> Tuple[Path, str]:
    """``(source, key)``: the library's store key. Only hashes: nothing is
    built or loaded."""
    return CSRC_DIR / f"{name}.cu", fingerprint_digest(fingerprint_parts(name))


# --------------------------------------------------------------------------- #
# The store
# --------------------------------------------------------------------------- #


class ExecutableStore:
    """On-disk library registry over the shared commit-dir protocol.

    Layout: one ``fp_<digest>/`` directory per fingerprint, holding
    ``lib_<pid>_<seq>`` commit-dir entries (``library.so``; ``payload.pkl``
    with nvcc's log; ``manifest.json`` with both files' sha256, the
    fingerprint parts and the build's provenance). Publishing GCs all but
    the newest entry of THAT fingerprint — entries of one fingerprint are
    interchangeable by construction, so newest wins; other fingerprints are
    never touched.

    Reads inherit the skip-torn contract of
    :class:`~agilerl_tpu_torch.resilience.store.CommitDirStore`: a torn or
    corrupt entry (a library whose bytes do not match the manifest
    included) is counted (``compile_cache/torn_entries_total``), warned
    once, and the walk falls back to the next-newest entry — a torn store
    can cost a rebuild, never a wrong library.
    """

    def __init__(self, directory: Union[str, Path], *, metrics=None, tracer=None):
        from agilerl_tpu_torch import observability

        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.metrics = (metrics if metrics is not None
                        else observability.get_registry())
        self._tracer = tracer
        self._stores: Dict[str, CommitDirStore] = {}

    @property
    def tracer(self):
        if self._tracer is not None:
            return self._tracer
        from agilerl_tpu_torch.observability import get_tracer

        return get_tracer()

    def fingerprint_dir(self, digest: str) -> Path:
        return self.directory / f"{_FP_PREFIX}{digest}"

    def _entry_store(self, digest: str) -> CommitDirStore:
        store = self._stores.get(digest)
        if store is None:
            store = CommitDirStore(
                self.fingerprint_dir(digest),
                prefix=_ENTRY_PREFIX,
                keep_last=1,
                torn_counter="compile_cache/torn_entries_total",
                torn_help="compile-cache entries skipped as torn/corrupt",
                warn_prefix="compile-cache-torn",
                metrics=self.metrics,
                tracer=self._tracer,
            )
            self._stores[digest] = store
        return store

    def entries(self, digest: str) -> List[Path]:
        """Committed entries of one fingerprint, oldest first."""
        return committed_entries(self.fingerprint_dir(digest), _ENTRY_PREFIX)

    def get_entry(self, digest: str) -> Optional[Tuple[Path, Dict[str, Any]]]:
        """Newest-first sha-validated walk of the fingerprint's entries;
        torn entries are skipped (counted + warned) and the walk falls back.
        ``(entry directory, payload)``, or None == MISS."""
        entries = self.entries(digest)
        if not entries:
            return None
        store = self._entry_store(digest)
        for entry in reversed(entries):
            payload = store.load(entry)
            if payload is not None:
                return entry, payload
        return None

    def publish(self, digest: str, payload: Dict[str, Any], library: bytes,
                manifest_extra: Optional[Dict[str, Any]] = None) -> Path:
        """Atomically publish one library under its fingerprint, then GC
        down to the newest entry of that fingerprint. The entry name carries
        the pid before the ordering integer, so two processes racing one
        fingerprint stage under different names."""
        store = self._entry_store(digest)
        seqs = [entry_seq(e.name) for e in store.entries()]
        seq = max([s for s in seqs if s is not None], default=-1) + 1
        return store.publish(f"{_ENTRY_PREFIX}{os.getpid()}_{seq:08d}", payload,
                             manifest_extra=manifest_extra,
                             files={LIBRARY_FILE: library})

    def digest_built_by_any_nvcc(self, parts: Dict[str, Any]) -> Optional[str]:
        """The fingerprint of the newest stored library whose manifest
        matches ``parts`` in every component but the nvcc version: what a
        process without nvcc may load."""
        best = None
        for fp_dir in self.directory.glob(f"{_FP_PREFIX}*"):
            entries = committed_entries(fp_dir, _ENTRY_PREFIX)
            if not entries:
                continue
            try:
                fp = read_manifest(entries[-1]).get("fingerprint")
            except CorruptSnapshotError:
                continue
            if isinstance(fp, dict) and dict(fp, nvcc_version=None) == parts:
                mtime = entries[-1].stat().st_mtime_ns
                if best is None or mtime > best[0]:
                    best = (mtime, fp_dir.name[len(_FP_PREFIX):])
        return None if best is None else best[1]


def _shared_store(directory: Union[str, Path]) -> ExecutableStore:
    key = str(Path(directory).resolve())
    store = _STORES.get(key)
    if store is None:
        store = _STORES[key] = ExecutableStore(directory)
    return store


def resolve_cache(cache: Any = None, *, metrics=None,
                  tracer=None) -> Optional[ExecutableStore]:
    """Normalise a ``cache=`` argument: an :class:`ExecutableStore` passes
    through, a str/Path builds a store bound to the consumer's registry,
    and ``None`` reads ``AGILERL_TPU_COMPILE_CACHE`` (that directory's
    process-wide store, or None when it is unset)."""
    if cache is None:
        env = os.environ.get(CACHE_ENV, "").strip()
        return _shared_store(env) if env else None
    if isinstance(cache, ExecutableStore):
        return cache
    return ExecutableStore(cache, metrics=metrics, tracer=tracer)


def default_store() -> ExecutableStore:
    """The store the kernel wrappers load through: the one
    ``AGILERL_TPU_COMPILE_CACHE`` names, else ``BUILD_DIR``'s."""
    return resolve_cache() or _shared_store(BUILD_DIR)


# --------------------------------------------------------------------------- #
# load-or-compile
# --------------------------------------------------------------------------- #


def _start(name: str, out: Path):
    """Start nvcc for one source, writing the library to ``out``."""
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out


def _finish(name: str, started) -> str:
    """Wait for one nvcc; its log (with ``-Xptxas -v``: registers, shared
    memory and spills per kernel). Raises when it failed."""
    proc, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        out.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    return log


def _load(store: ExecutableStore, name: str, digest: str, info: Dict[str, Any]):
    """The stored library of ``digest``, loaded; None on a miss or when the
    stored library fails to load (counted, warned once: it is rebuilt)."""
    got = store.get_entry(digest)
    if got is None:
        return None
    entry, _ = got
    t0 = time.perf_counter()
    try:
        lib = ctypes.CDLL(str(entry / LIBRARY_FILE))
    except OSError as e:
        store.metrics.counter(
            "compile_cache/deserialize_failures_total",
            help="stored libraries that failed to load (rebuilt and "
                 "republished)").inc()
        store.metrics.warn_once(
            f"compile-cache-deserialize-{digest[:16]}",
            f"compile cache entry {digest[:16]} for {name!r} failed to load "
            f"({type(e).__name__}: {e}); rebuilding and republishing")
        return None
    load_s = time.perf_counter() - t0
    store.metrics.counter("compile_cache/hits_total",
                          help="libraries loaded from the store").inc()
    store.metrics.histogram(
        "compile_cache/load_s", buckets=CACHE_TIME_BUCKETS,
        help="wall time to load a stored library").observe(load_s)
    tracer = store.tracer
    if tracer.enabled:
        tracer.start_span("compile_cache.load", attributes={
            "name": name, "fingerprint": digest, "load_s": load_s}).end()
    info.update(hit=True, load_s=load_s, path=str(entry / LIBRARY_FILE))
    return lib


def _publish_and_load(store: ExecutableStore, name: str, digest: str,
                      parts: Dict[str, Any], out: Path, log: str,
                      compile_s: float, info: Dict[str, Any]):
    """Publish a fresh build and load it from its committed entry (or, when
    the store cannot take it, from the build's own file)."""
    library = out.read_bytes()
    path = out
    try:
        entry = store.publish(digest, {"name": name, "nvcc_log": log}, library,
                              manifest_extra={"fingerprint": parts,
                                              "compile_seconds": round(compile_s, 3),
                                              "published_by": name})
    except OSError as e:
        # a full or revoked store costs the NEXT process a rebuild, never
        # this one its kernel
        store.metrics.warn_once(
            f"compile-cache-publish-{name}",
            f"could not publish the library of {name!r} ({type(e).__name__}: "
            f"{e}); entry not stored")
    else:
        info["published"] = True
        path = entry / LIBRARY_FILE
    lib = ctypes.CDLL(str(path))
    out.unlink(missing_ok=True)
    info["path"] = str(path)
    return lib


def load_or_compile_all(
    names: Iterable[str],
    *,
    store: Optional[ExecutableStore] = None,
) -> Dict[str, Tuple[Any, Dict[str, Any]]]:
    """``{name: (library, info)}`` for each ``csrc/<name>.cu``: LOADED from
    the store when it holds the fingerprint, else BUILT (one nvcc per
    missing source, all started together), published and loaded. ``info``
    records hit/miss, the digest, ``load_s`` or ``compile_s`` and nvcc's
    log."""
    store = store if store is not None else default_store()
    metrics = store.metrics
    out: Dict[str, Tuple[Any, Dict[str, Any]]] = {}
    misses = []
    for name in names:
        parts = fingerprint_parts(name)
        digest = fingerprint_digest(parts)
        if parts["nvcc_version"] is None:
            digest = store.digest_built_by_any_nvcc(parts) or digest
        info: Dict[str, Any] = {"name": name, "fingerprint": digest, "hit": False}
        lib = _load(store, name, digest, info)
        if lib is not None:
            out[name] = (lib, info)
        else:
            misses.append((name, parts, digest, info))
    if not misses:
        return out

    started: List[Tuple[Any, float]] = []
    try:
        for name, _, digest, _ in misses:
            tmp = store.directory / f".build_{name}_{digest[:16]}.{os.getpid()}.so"
            started.append((_start(name, tmp), time.perf_counter()))
            _count_build()
    except BaseException:
        for (proc, _), _ in started:
            proc.kill()
            proc.wait()
        raise

    def wait(i):
        # each build's own wall time: one thread waits on each nvcc
        (name, *_), (proc_out, t_start) = misses[i], started[i]
        try:
            return _finish(name, proc_out), time.perf_counter() - t_start
        except RuntimeError as e:
            return e, None

    with ThreadPoolExecutor(max_workers=len(started)) as pool:
        finished = list(pool.map(wait, range(len(started))))
    errors = []
    for (name, parts, digest, info), (proc_out, _), (log, compile_s) in zip(
            misses, started, finished):
        if isinstance(log, RuntimeError):
            errors.append(str(log))
            continue
        metrics.counter("compile_cache/misses_total",
                        help="libraries built fresh (no loadable store entry)").inc()
        metrics.histogram(
            "compile_cache/compile_s", buckets=CACHE_TIME_BUCKETS,
            help="wall time of one fresh nvcc build on the cache-miss path",
        ).observe(compile_s)
        tracer = store.tracer
        if tracer.enabled:
            tracer.start_span("compile_cache.compile", attributes={
                "name": name, "fingerprint": digest, "compile_s": compile_s}).end()
        info.update(compile_s=compile_s, nvcc_log=log)
        out[name] = (_publish_and_load(store, name, digest, parts, proc_out[1], log,
                                       compile_s, info), info)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load_or_compile(name: str, *, store: Optional[ExecutableStore] = None
                    ) -> Tuple[Any, Dict[str, Any]]:
    """Load the stored library of ``csrc/<name>.cu`` or build, publish and
    load it. Returns ``(ctypes.CDLL, info)``."""
    return load_or_compile_all([name], store=store)[name]


def build_all(names: Iterable[str], store: Optional[ExecutableStore] = None
              ) -> Dict[str, str]:
    """Load every named library from the store, building the missing ones
    in parallel (one nvcc each); returns nvcc's log per source ("" for a
    library loaded from the store)."""
    logs = {}
    for n, (lib, info) in load_or_compile_all(names, store=store).items():
        _LIBS[n] = lib
        logs[n] = info.get("nvcc_log", "")
    return logs


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is in the default store (the
    newest committed entry of its fingerprint), or will be published (its
    fingerprint's directory). Hashes only: nothing is built or loaded."""
    fp_dir = default_store().fingerprint_dir(_target(name)[1])
    entries = committed_entries(fp_dir, _ENTRY_PREFIX)
    return entries[-1] / LIBRARY_FILE if entries else fp_dir


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, from the store or built
    first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib, _ = load_or_compile(name)
        _LIBS[name] = lib
    return lib
