"""Build ``agilerl_tpu_torch/csrc/*.cu`` with nvcc at first use and load the
result with ctypes.

Each source is one shared library with a plain C interface (no PyTorch
headers), so a build takes seconds. The library lands in
``agilerl_tpu_torch/_build/`` (listed in ``.gitignore``) under a name that
carries a hash of its source and of the headers it includes from
``csrc/`` (``#include "name.cuh"``, followed through the headers), so an
edited source or header is rebuilt and a stale library is never loaded. ``build_all`` starts one nvcc per source, all at
once, and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(CSRC_DIR)]
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_LIBS: Dict[str, ctypes.CDLL] = {}


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


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(src)
    h = hashlib.sha256(src.read_bytes())
    for inc in local_includes(src):
        h.update(inc.name.encode())
        h.update(inc.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    src, out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return log


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Build every named source in parallel; returns nvcc's log per source
    (with ``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    names = list(names)
    started: List = []
    try:
        for n in names:
            started.append(_start(n))
    except BaseException:
        for s in started:
            if s is not None:
                s[0].kill()
                s[0].wait()
        raise
    logs = {}
    errors = []
    for n, s in zip(names, started):
        try:
            logs[n] = _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` is, or will be, built."""
    return _target(name)[1]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
