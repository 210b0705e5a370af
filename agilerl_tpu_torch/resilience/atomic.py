"""Crash-consistent file primitives: the port of
``agilerl_tpu/resilience/atomic.py`` (whole), the commit protocol every store
writer goes through.

The protocol (write-ahead tmp + fsync + ``os.replace``) guarantees that a
reader never observes a half-written file or a half-written snapshot
directory: either the old committed state is visible or the new one is,
regardless of where a SIGKILL lands. Directory commits additionally fsync
the parent directory so the rename itself survives a power cut (POSIX
leaves the directory entry volatile otherwise).

Every durability-relevant operation also fires a **fault hook**
(:func:`set_fault_hook`): a fault-injection harness installs a callable here
and kills/corrupts the process at scheduled operation indices, so crash
consistency is exercised by CPU tests instead of asserted.
"""

from __future__ import annotations

import hashlib
import io
import os
import pickle
from pathlib import Path
from typing import Any, Callable, Optional, Tuple, Union

#: suffix for uncommitted snapshot directories (never read by restore paths)
TMP_DIR_SUFFIX = ".tmp"
#: suffix for uncommitted single files
TMP_FILE_SUFFIX = ".part"


class CorruptSnapshotError(RuntimeError):
    """A snapshot entry failed validation (missing, truncated, or its
    content hash does not match the manifest)."""


# --------------------------------------------------------------------------- #
# fault hook — the seam the FaultInjector attaches to
# --------------------------------------------------------------------------- #

_fault_hook: Optional[Callable[[str, Path], None]] = None


def set_fault_hook(
    hook: Optional[Callable[[str, Path], None]]
) -> Optional[Callable[[str, Path], None]]:
    """Install (or clear, with None) the process-wide fault hook. Returns the
    previous hook so callers can restore it."""
    global _fault_hook
    prev = _fault_hook
    _fault_hook = hook
    return prev


def _fire(op: str, path: Union[str, Path]) -> None:
    """Ops fired, in order, during a snapshot commit:

    - ``write``:  about to write a file (payload not yet on disk)
    - ``wrote``:  the file is durably in place (post-replace, post-fsync)
    - ``commit``: about to atomically publish a snapshot directory
    """
    if _fault_hook is not None:
        _fault_hook(op, Path(path))


# --------------------------------------------------------------------------- #
# durability primitives
# --------------------------------------------------------------------------- #


def fsync_file(path: Union[str, Path]) -> None:
    fd = os.open(str(path), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: Union[str, Path]) -> None:
    """fsync a directory so renames/creates inside it are durable. Silently
    skipped on platforms that refuse O_RDONLY on directories."""
    try:
        fd = os.open(str(path), os.O_RDONLY)
    except OSError:  # pragma: no cover - platform-specific
        return
    try:
        os.fsync(fd)
    except OSError:  # pragma: no cover - platform-specific
        pass
    finally:
        os.close(fd)


def content_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def atomic_write_bytes(path: Union[str, Path], data: bytes) -> str:
    """Write ``data`` to ``path`` atomically (tmp + fsync + ``os.replace``)
    and return its sha256 hex digest. A crash at any point leaves either the
    previous file or the new one — never a torn mix."""
    path = Path(path)
    _fire("write", path)
    tmp = path.with_name(path.name + TMP_FILE_SUFFIX)
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(path.parent)
    _fire("wrote", path)
    return content_hash(data)


def atomic_pickle(path: Union[str, Path], obj: Any) -> Tuple[str, int]:
    """Atomically pickle ``obj`` to ``path``; returns (sha256, byte size)."""
    buf = io.BytesIO()
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    data = buf.getvalue()
    return atomic_write_bytes(path, data), len(data)


def staged_write_bytes(path: Union[str, Path], data: bytes) -> str:
    """Plain write for a file inside a NOT-YET-COMMITTED staging directory
    (``*.tmp``): no reader can observe the directory until
    :func:`commit_dir` publishes it, and commit_dir fsyncs every file once
    before the rename — so the per-file tmp+fsync+replace dance of
    :func:`atomic_write_bytes` would only double the durability I/O on the
    snapshot hot path. Fires the same ``write``/``wrote`` fault hooks."""
    path = Path(path)
    _fire("write", path)
    with open(path, "wb") as fh:
        fh.write(data)
    _fire("wrote", path)
    return content_hash(data)


def staged_pickle(path: Union[str, Path], obj: Any) -> Tuple[str, int]:
    """Pickle ``obj`` into a staging directory (see :func:`staged_write_bytes`);
    returns (sha256, byte size)."""
    buf = io.BytesIO()
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    data = buf.getvalue()
    return staged_write_bytes(path, data), len(data)


def read_validated(path: Union[str, Path], sha256: Optional[str] = None) -> bytes:
    """Read a file, raising :class:`CorruptSnapshotError` when it is missing
    or its content hash mismatches the manifest's record (torn/truncated/
    bit-rotted entries are detected here, never silently loaded)."""
    path = Path(path)
    try:
        data = path.read_bytes()
    except OSError as e:
        raise CorruptSnapshotError(f"snapshot entry unreadable: {path}: {e}") from e
    if sha256 is not None and content_hash(data) != sha256:
        raise CorruptSnapshotError(
            f"snapshot entry corrupt (hash mismatch): {path}"
        )
    return data


def load_validated_pickle(path: Union[str, Path], sha256: Optional[str] = None) -> Any:
    data = read_validated(path, sha256)
    try:
        return pickle.loads(data)
    except Exception as e:  # torn pickles raise a zoo of error types
        raise CorruptSnapshotError(f"snapshot entry unpicklable: {path}: {e}") from e


def commit_dir(tmp_dir: Union[str, Path], final_dir: Union[str, Path]) -> None:
    """Atomically publish a fully-written staging directory: fsync every file
    inside, then ``os.replace`` the directory into its final name and fsync
    the parent. Readers scanning for committed snapshots never see
    ``*.tmp`` names, so a kill before the replace leaves only ignorable
    garbage, and a kill after leaves a complete snapshot.

    Prefer committing to a name that does not exist (``CheckpointManager``
    guarantees this by suffixing same-step resaves): directories cannot be
    atomically swapped portably, so overwriting an existing committed
    directory first moves it aside to a ``*.tmp`` name — a kill in the
    gap between the two renames loses THIS name (restore falls back to an
    older snapshot), which is the narrowest window POSIX rename allows."""
    tmp_dir, final_dir = Path(tmp_dir), Path(final_dir)
    for f in tmp_dir.rglob("*"):
        if f.is_file():
            fsync_file(f)
    fsync_dir(tmp_dir)
    _fire("commit", final_dir)
    old: Optional[Path] = None
    if final_dir.exists():
        old = final_dir.with_name(final_dir.name + ".old" + TMP_DIR_SUFFIX)
        if old.exists():
            import shutil

            shutil.rmtree(old)
        os.replace(final_dir, old)
    os.replace(tmp_dir, final_dir)
    fsync_dir(final_dir.parent)
    if old is not None:
        import shutil

        shutil.rmtree(old, ignore_errors=True)


def remove_stale_tmp_dirs(root: Union[str, Path]) -> int:
    """Delete leftover ``*.tmp`` staging directories from crashed saves.
    Returns how many were removed. Safe to call at manager startup: committed
    snapshots are never named ``*.tmp``."""
    root = Path(root)
    if not root.is_dir():
        return 0
    import shutil

    removed = 0
    for d in root.iterdir():
        if d.is_dir() and d.name.endswith(TMP_DIR_SUFFIX):
            shutil.rmtree(d, ignore_errors=True)
            removed += 1
    return removed
