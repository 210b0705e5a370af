"""Host-side request router for a multi-replica serving fleet.

The router answers ONE question per request: *which replica should serve
this prompt?* Its inputs are the telemetry the serving tier already emits —
per-replica queue depth / slot occupancy (load) and the prompt's block-hash
chain (identity) — and its policy is the standard two-tier rule of
prefix-cache-aware serving (SGLang/vLLM cache-aware routing lineage):

1. **Prefix affinity** — a chain dispatched to a replica before routes back
   to the SAME replica: its :class:`~agilerl_tpu_torch.llm.serving
   .BlockAllocator` owns the cached prompt blocks, so the repeat is a
   full-chain hit that skips prefill entirely. Affinity keys on the chain's
   TAIL hash (which, being a hash chain, commits to the whole prompt):
   under left-padding, two different prompts can only share pad-block
   prefixes — a deepest-prefix walk would herd every short prompt onto one
   replica via the all-pad leading block while paying off on nothing, so
   partial-prefix affinity waits for the serving tier's partial-prefix
   resume (docs/serving.md sketches both together).
2. **Least-loaded fallback** — cold chains (and chains whose owner died or
   is shedding) go to the admittable replica with the smallest load,
   ties broken by lowest replica id (deterministic on every observer, the
   same tie rule membership uses for leader election).

The router is deliberately a pure host-side data structure: no device
state, no locks (the fleet drives it from its single scheduler thread), and
replica death is handled by :meth:`forget_replica` — the affinity map drops
every entry owned by the dead replica, so re-dispatched repeats re-route by
load and rebuild affinity on the survivor.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional, Sequence, Tuple

from agilerl_tpu_torch import observability


class FleetRouter:
    """Prefix-affinity + least-loaded dispatch over replica candidates.

    ``max_entries`` bounds the affinity map (LRU eviction): the map is a
    routing HINT, not a correctness structure — a dropped entry merely
    degrades a future repeat to the least-loaded path, where the replica's
    own prefix cache may still hit.
    """

    def __init__(self, metrics=None, max_entries: int = 65536):
        self.metrics = metrics if metrics is not None else observability.get_registry()
        self.max_entries = int(max_entries)
        #: block hash -> replica id that owns the cached block
        self._owner: "collections.OrderedDict[bytes, int]" = collections.OrderedDict()

    def route(
        self,
        hashes: Sequence[bytes],
        loads: Dict[int, float],
    ) -> Tuple[int, bool]:
        """Pick a replica for a prompt with block-hash chain ``hashes``
        among ``loads`` (replica id -> current load; the fleet passes only
        candidates that are alive and admittable). Returns
        ``(replica_id, affinity_hit)``.

        Affinity keys on the chain's TAIL hash — a hash chain's last link
        commits to the whole left-padded prompt, so a tail match IS a
        full-chain repeat (see the module docstring for why partial-prefix
        matching is deliberately absent)."""
        if not loads:
            raise ValueError("route() needs at least one candidate replica")
        hashes = list(hashes)
        rid = self._owner.get(hashes[-1]) if hashes else None
        if rid is not None and rid in loads:
            return rid, True
        rid = min(loads, key=lambda r: (loads[r], r))
        return rid, False

    def record(self, hashes: Sequence[bytes], replica_id: int) -> None:
        """Remember that ``replica_id`` now owns this chain (call after
        dispatch — hit or miss, the replica's allocator caches the chain
        either way). Only the tail hash is stored: it commits to the whole
        chain, and storing interior links would just bloat the map with
        entries :meth:`route` never consults."""
        hashes = list(hashes)
        if not hashes:
            return
        h = hashes[-1]
        self._owner.pop(h, None)  # re-append: LRU freshness
        self._owner[h] = int(replica_id)
        while len(self._owner) > self.max_entries:
            self._owner.popitem(last=False)

    def forget_replica(self, replica_id: int) -> int:
        """Drop every affinity entry owned by a dead replica; returns how
        many were dropped. Future repeats of its chains re-route by load."""
        rid = int(replica_id)
        stale = [h for h, r in self._owner.items() if r == rid]
        for h in stale:
            del self._owner[h]
        return len(stale)

    def owner_of(self, hashes: Sequence[bytes]) -> Optional[int]:
        """The replica owning the chain's TAIL hash (None when unknown) —
        the full-repeat affinity probe."""
        if not hashes:
            return None
        return self._owner.get(list(hashes)[-1])

    @property
    def entries(self) -> int:
        return len(self._owner)
