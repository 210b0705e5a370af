"""Generic commit-dir + manifest entry store, the port of
``agilerl_tpu/resilience/store.py`` (whole): ONE home for the atomic
publish / sha-validate / skip-torn / last-K-GC discipline that the
prefill->decode KV transfers (``llm/fleet.KVTransferStore``), the
online-flywheel weight/trajectory stores (``llm/flywheel.py``) and the
telemetry plane (``observability/export.py``) share. The protocol is always:

1. **Publish** — stage the pickled payload plus a ``manifest.json`` that
   records its sha256 and byte size into a ``*.tmp`` directory, then
   :func:`~agilerl_tpu_torch.resilience.atomic.commit_dir` publishes the
   directory atomically. A reader either sees a complete, hash-valid entry
   or nothing.
2. **Read** — the manifest is parsed first (readable without unpickling
   the payload), then the payload is hash-validated through
   :func:`~agilerl_tpu_torch.resilience.atomic.load_validated_pickle`. Torn,
   truncated, or corrupt entries raise
   :class:`~agilerl_tpu_torch.resilience.atomic.CorruptSnapshotError` — they are
   NEVER loaded; callers skip (and usually count + warn) instead.
3. **GC** — entries are ordered by the integer suffix in their name, and
   all but the newest ``keep_last`` are deleted.

The module functions are the composable layer; the
:class:`CommitDirStore` class adds the metrics-wired skip-torn read that
the fleet/flywheel stores share verbatim.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

from agilerl_tpu_torch.resilience.atomic import (
    TMP_DIR_SUFFIX,
    CorruptSnapshotError,
    commit_dir,
    load_validated_pickle,
    staged_pickle,
    staged_write_bytes,
)

_TRAILING_INT = re.compile(r"(\d+)(?:\D*)$")


def entry_seq(name: str) -> Optional[int]:
    """The LAST integer run in an entry name (``epoch_00000007`` -> 7,
    ``batch_003_00000012`` -> 12) — name layouts must put the ordering
    integer last. Returns None when the name carries no digits."""
    m = _TRAILING_INT.search(name)
    return int(m.group(1)) if m else None


def publish_entry(
    directory: Union[str, Path],
    name: str,
    payload: Any,
    *,
    payload_name: str = "payload.pkl",
    sha_key: str = "payload_sha",
    manifest_extra: Optional[Dict[str, Any]] = None,
) -> Path:
    """Atomically publish one named entry under ``directory`` and return the
    committed path. The manifest records the payload pickle's sha256 (under
    ``sha_key``) and byte size plus ``manifest_extra`` verbatim, so readers
    can inspect provenance without unpickling."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / name
    # pid-scoped staging: two processes racing the SAME entry name must not
    # rmtree each other's in-flight staging dir. Both still commit to `final` — commit_dir's
    # rename makes the last writer win, wholesale, never interleaved. The
    # name keeps the ``.tmp`` suffix so committed_entries() and
    # remove_stale_tmp_dirs() continue to classify it as staging.
    tmp = directory / f"{name}.{os.getpid()}{TMP_DIR_SUFFIX}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    sha, size = staged_pickle(tmp / payload_name, payload)
    manifest: Dict[str, Any] = {sha_key: sha, "bytes": size}
    manifest.update(manifest_extra or {})
    staged_write_bytes(
        tmp / "manifest.json", json.dumps(manifest, indent=2).encode()
    )
    commit_dir(tmp, final)
    return final


def read_manifest(path: Union[str, Path]) -> Dict[str, Any]:
    """Parse an entry's manifest; raises :class:`CorruptSnapshotError` when
    it is missing or unparsable (a crash can't produce this under the
    commit protocol — only external corruption can)."""
    path = Path(path)
    try:
        manifest = json.loads((path / "manifest.json").read_text())
    except (OSError, ValueError) as e:
        raise CorruptSnapshotError(
            f"entry manifest unreadable: {path}: {e}"
        ) from e
    if not isinstance(manifest, dict):
        raise CorruptSnapshotError(f"entry manifest malformed: {path}")
    return manifest


def read_entry(
    path: Union[str, Path],
    *,
    payload_name: str = "payload.pkl",
    sha_key: str = "payload_sha",
) -> Any:
    """Hash-validated payload read. Raises :class:`CorruptSnapshotError`
    for anything less than a complete, manifest-matching payload — torn
    entries are never partially loaded."""
    path = Path(path)
    manifest = read_manifest(path)
    sha = manifest.get(sha_key)
    if not isinstance(sha, str):
        raise CorruptSnapshotError(
            f"entry manifest at {path} carries no {sha_key!r} hash"
        )
    return load_validated_pickle(path / payload_name, sha)


def committed_entries(
    directory: Union[str, Path], prefix: str = ""
) -> List[Path]:
    """Committed (non-``*.tmp``) entry directories under ``directory`` whose
    name starts with ``prefix``, ordered oldest-first by the integer suffix
    in the name (ties / no-integer names fall back to the name itself —
    zero-padded layouts order identically either way)."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    entries = [
        d for d in directory.iterdir()
        if d.is_dir() and d.name.startswith(prefix)
        and not d.name.endswith(TMP_DIR_SUFFIX)
    ]
    return sorted(
        entries, key=lambda d: (entry_seq(d.name) is None,
                                entry_seq(d.name) or 0, d.name)
    )


def gc_entries(
    directory: Union[str, Path], prefix: str = "",
    keep_last: Optional[int] = None,
) -> int:
    """Delete all but the newest ``keep_last`` committed entries (numeric
    order — lexicographic would misrank unpadded sequence numbers). Returns
    how many were removed. ``keep_last=None`` keeps everything."""
    if keep_last is None:
        return 0
    # rank ONLY parseable-seq entries: a digitless stray dir sorts NEWEST
    # in committed_entries (reader walks try it last), and counting it in
    # the keep window would displace a real entry; it also isn't ours to
    # delete
    entries = [e for e in committed_entries(directory, prefix)
               if entry_seq(e.name) is not None]
    removed = 0
    for old in entries[: max(len(entries) - int(keep_last), 0)]:
        shutil.rmtree(old, ignore_errors=True)
        removed += 1
    return removed


class CommitDirStore:
    """The metrics-wired store the fleet/flywheel tiers compose: atomic
    :meth:`publish`, skip-torn :meth:`load` (counter + warn-once, returns
    None — the caller recomputes or falls back, NEVER loads a torn entry),
    :meth:`entries`, :meth:`consume`, and last-K GC on publish."""

    def __init__(
        self,
        directory: Union[str, Path],
        *,
        payload_name: str = "payload.pkl",
        sha_key: str = "payload_sha",
        prefix: str = "",
        keep_last: Optional[int] = None,
        torn_counter: str = "resilience/torn_entries_total",
        torn_help: str = "store entries skipped as torn/corrupt",
        warn_prefix: str = "torn-entry",
        metrics=None,
        tracer=None,
    ):
        from agilerl_tpu_torch import observability

        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.payload_name = payload_name
        self.sha_key = sha_key
        self.prefix = prefix
        self.keep_last = keep_last
        self.torn_counter = torn_counter
        self.torn_help = torn_help
        self.warn_prefix = warn_prefix
        self.metrics = (metrics if metrics is not None
                        else observability.get_registry())
        #: like metrics: an explicit consumer tracer wins (multiple runs in
        #: one process each keep their spans in their own sink); None reads
        #: the process default lazily
        self._tracer = tracer

    @property
    def tracer(self):
        if self._tracer is not None:
            return self._tracer
        from agilerl_tpu_torch.observability import get_tracer

        return get_tracer()

    def publish(self, name: str, payload: Any,
                manifest_extra: Optional[Dict[str, Any]] = None) -> Path:
        path = publish_entry(
            self.directory, name, payload,
            payload_name=self.payload_name, sha_key=self.sha_key,
            manifest_extra=manifest_extra,
        )
        gc_entries(self.directory, self.prefix, self.keep_last)
        return path

    def load(self, path: Union[str, Path]) -> Optional[Any]:
        """Hash-validated read; returns None (after counting + warning) for
        a torn, truncated, or corrupt entry — the skip-torn contract."""
        path = Path(path)
        try:
            return read_entry(path, payload_name=self.payload_name,
                              sha_key=self.sha_key)
        except (OSError, ValueError, KeyError, CorruptSnapshotError) as e:
            if not path.exists():
                # concurrently GC'd between listing and load (another
                # process's keep-last pass) — a vanished entry is routine,
                # not corruption; the torn counter must stay an integrity
                # signal
                return None
            self.metrics.counter(self.torn_counter, help=self.torn_help).inc()
            self.metrics.warn_once(
                f"{self.warn_prefix}-{path.name}",
                f"skipping torn store entry {path.name}: {e}")
            tracer = self.tracer
            if tracer.enabled:
                # torn entry: anomaly — always sampled, error status, one
                # span per skip across EVERY store consumer (KV transfers,
                # weight/trajectory stores, telemetry snapshots)
                tracer.start_span(
                    "store.torn_entry", force=True,
                    attributes={"entry": path.name,
                                "counter": self.torn_counter},
                ).set_error(str(e)).end()
            return None

    def entries(self) -> List[Path]:
        return committed_entries(self.directory, self.prefix)

    def consume(self, path: Union[str, Path]) -> None:
        """Delete a read (or torn) entry directory."""
        shutil.rmtree(Path(path), ignore_errors=True)
