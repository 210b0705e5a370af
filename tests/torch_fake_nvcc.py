"""A stand-in ``nvcc`` for the CPU tests of the port's compile cache.

``install_fake_nvcc(directory, version, delays)`` writes an executable
``nvcc`` into ``directory/bin``: ``nvcc --version`` prints ``version``; a
build (``nvcc ... -o OUT SRC``) sleeps ``delays.get(SRC's stem, 0)``
seconds, copies a real shared library of the system (libm)
to ``OUT``, so ``ctypes.CDLL`` can load what the store publishes, prints a
line of ptxas-like log, and appends one line to ``directory/calls``. Put
``directory/bin`` first on ``PATH``. This module imports no jax.
"""

from __future__ import annotations

import stat
import sys
from pathlib import Path
from typing import Dict, Optional

_LIBM_CANDIDATES = ("/lib/x86_64-linux-gnu/libm.so.6", "/usr/lib/x86_64-linux-gnu/libm.so.6",
                    "/lib/aarch64-linux-gnu/libm.so.6", "/usr/lib/aarch64-linux-gnu/libm.so.6",
                    "/lib64/libm.so.6", "/usr/lib64/libm.so.6", "/lib/libm.so.6")

_SCRIPT = '''#!{python}
import os, shutil, sys, time
args = sys.argv[1:]
if args == ["--version"]:
    print({version!r})
    sys.exit(0)
out = args[args.index("-o") + 1]
time.sleep({delays!r}.get(os.path.basename(args[-1]).rsplit(".", 1)[0], 0))
with open({calls!r}, "a") as fh:
    fh.write(args[-1] + "\\n")
shutil.copyfile({lib!r}, out)
print("ptxas info    : Used 1 registers, 0 bytes spill stores")
'''


def system_library() -> Optional[str]:
    """A loadable shared library of the system, or None."""
    for cand in _LIBM_CANDIDATES:
        if Path(cand).exists():
            return cand
    return None


def install_fake_nvcc(directory: Path, version: str = "fake nvcc, release 12.9",
                      delays: Optional[Dict[str, float]] = None) -> Path:
    """Write the stand-in into ``directory/bin``; returns that directory."""
    lib = system_library()
    if lib is None:
        raise FileNotFoundError("no system libm to stand in for a built library")
    bin_dir = Path(directory) / "bin"
    bin_dir.mkdir(parents=True, exist_ok=True)
    script = bin_dir / "nvcc"
    script.write_text(_SCRIPT.format(python=sys.executable, version=version,
                                     calls=str(Path(directory) / "calls"), lib=lib,
                                     delays=dict(delays or {})))
    script.chmod(script.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP | stat.S_IXOTH)
    return bin_dir


def calls(directory: Path) -> int:
    """Builds the stand-in has run."""
    f = Path(directory) / "calls"
    return len(f.read_text().splitlines()) if f.exists() else 0
