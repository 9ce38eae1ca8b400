"""Query-time id filtering (allow / deny lists) for every query mode.

Post-filtering breaks top-k semantics (a filtered-out candidate consumes
a result slot); real deployments need pre-filtering: multi-tenant
namespaces, soft deletes, access control, time-windowed corpora.

Formulation: every query core in this package already treats a slot as
dead when its id or tie key is negative (tombstones use exactly this
encoding), and both columns are *runtime operands* of the kernels. A
filter is therefore a per-slot aliveness rewrite::

    ids_f = where(member(allow, ids) & ~member(deny, ids), ids, -1)
    tie_f = where(...,                                      tie, -1)

computed on the store's device — membership is a binary-search probe
(``torch.searchsorted``) of the sorted allow/deny tables against the
store's id column, ``O((C + A) log A)`` work, no host dict — and cached
per store generation, so repeated queries through the same
:class:`IdFilter` reuse the filtered columns. Exactness: masked slots
contribute a dead key to the group-max kernels (B1, B2, B3 read ``tie`` as
an operand) and to refinement (same argument as tombstones), so filtered
top-k equals brute-force top-k over the admitted subset. The grouped fast
paths drop their prebuilt refine tables when filtering (the tables bake
in the UNfiltered tie/id columns) and gather per slot.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

import numpy as np
import torch

__all__ = ["IdFilter", "as_filter"]

# Sentinel that can never equal a live external id (ids are >= 0): stands
# in for an EMPTY allowlist, so the membership probe keeps a non-empty
# table (an empty allowlist admits nothing, which is valid).
_NEVER = np.array([-2], dtype=np.int32)


def _member(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``x in table`` for a sorted non-empty int32 table."""
    pos = torch.searchsorted(table, x).clamp(max=table.shape[0] - 1)
    return table[pos] == x


def _filtered_state(
    ids: torch.Tensor,
    tie: torch.Tensor,
    allow: torch.Tensor | None,
    deny: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, tie) -> filtered copies with inadmissible slots marked dead."""
    mask = ids >= 0
    if allow is not None:
        mask &= _member(allow, ids)
    if deny is not None:
        mask &= ~_member(deny, ids)
    return torch.where(mask, ids, -1), torch.where(mask, tie, -1)


def _normalize(ids, name: str) -> Optional[np.ndarray]:
    """-> sorted unique non-negative int32 array, or None when absent."""
    if ids is None:
        return None
    arr = np.unique(np.asarray(ids, dtype=np.int64).reshape(-1))
    if arr.size and (arr[0] < 0 or arr[-1] > np.iinfo(np.int32).max):
        raise ValueError(
            f"{name} must contain non-negative int32 ids; received values "
            f"in [{arr[0]}, {arr[-1] if arr.size else 0}]"
        )
    return arr.astype(np.int32)


class IdFilter:
    """Reusable query-time id filter: admit ``allow`` minus ``deny``.

    Construct once, pass as ``where=`` to any query method (an
    array-like of ids is accepted there as an allowlist shorthand) —
    the device membership state is computed lazily on first use against
    a store and recomputed automatically when the store mutates (the
    store's generation counter guards the cache), so a long-lived
    filter stays correct across appends, deletes and compactions.

    A filter instance is thread-safe and may be shared across stores:
    the per-store cache is keyed by weak references (a garbage-collected
    store releases its cached device tensors; a new store can never
    alias a dead one's entry) and guarded by the filter's own lock.

    Args:
        allowed_ids: ids admitted to results (None = admit all). An
            EMPTY allowlist is valid and admits nothing.
        disallowed_ids: ids excluded from results (applied after the
            allowlist: admitted = allow ∧ ¬deny).
    """

    # Bound on live-store cache entries: a filter rarely spans stores.
    _CACHE_MAX = 4

    def __init__(self, allowed_ids=None, disallowed_ids=None) -> None:
        if allowed_ids is None and disallowed_ids is None:
            raise ValueError(
                "IdFilter requires allowed_ids and/or disallowed_ids"
            )
        self.allowed = _normalize(allowed_ids, "allowed_ids")
        self.disallowed = _normalize(disallowed_ids, "disallowed_ids")
        # store (weak) -> (generation, ids_f, tie_f). Weak keys make the
        # cache immune to id()-reuse after GC and release dead stores'
        # device tensors; the lock makes one filter shareable across
        # stores/threads (each store serializes on its OWN lock, so the
        # store lock alone cannot protect this shared state).
        self._cache: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self._lock = threading.Lock()
        # device -> (allow table or None, deny table or None)
        self._tables: dict = {}

    # -- host-side membership ----------------------------------------------

    def admits(self, ids) -> np.ndarray:
        """Vectorized host membership test -> bool array."""
        arr = np.asarray(ids, dtype=np.int64).reshape(-1)
        mask = np.ones(arr.shape, dtype=bool)
        if self.allowed is not None:
            if self.allowed.size:
                pos = np.searchsorted(self.allowed, arr)
                pos_c = np.clip(pos, 0, self.allowed.size - 1)
                mask &= self.allowed[pos_c] == arr
            else:
                mask &= False
        if self.disallowed is not None and self.disallowed.size:
            pos = np.searchsorted(self.disallowed, arr)
            pos_c = np.clip(pos, 0, self.disallowed.size - 1)
            mask &= self.disallowed[pos_c] != arr
        return mask

    # -- device-side state (DeviceStore) -----------------------------------

    def _device_tables(self, device: torch.device):
        """Sorted allow / deny tables on ``device`` (call under the lock)."""
        if device not in self._tables:
            allow = deny = None
            if self.allowed is not None:
                allow = torch.from_numpy(
                    self.allowed if self.allowed.size else _NEVER
                ).to(device)
            if self.disallowed is not None and self.disallowed.size:
                deny = torch.from_numpy(self.disallowed).to(device)
            self._tables[device] = (allow, deny)
        return self._tables[device]

    def device_state(self, store) -> tuple:
        """Filtered ``(ids, tie)`` for ``store`` (call under its lock).

        A `ShardedDeviceStore` gets a list of each per shard, masked from
        the shard's own (shard-local) tie column on the shard's device.
        Cached per store generation: any mutation (append / overwrite /
        remove / compact / rehash / clear) bumps the generation and the
        next query recomputes the mask against the current id column.
        """
        gen = store._generation
        with self._lock:
            hit = self._cache.get(store)
            if hit is not None and hit[0] == gen:
                return hit[1], hit[2]
        store._ensure_ranks()  # the tie column must be fresh
        shards = getattr(store, "_shards", None)
        parts = []
        for part in [store] if shards is None else shards:
            with self._lock:
                allow_dev, deny_dev = self._device_tables(part._ids.device)
            parts.append(_filtered_state(part._ids, part._tie, allow_dev, deny_dev))
        if shards is None:
            ids_f, tie_f = parts[0]
        else:
            ids_f, tie_f = [p[0] for p in parts], [p[1] for p in parts]
        with self._lock:
            while len(self._cache) >= self._CACHE_MAX:
                ref = next(iter(self._cache.keyrefs()), None)
                victim = ref() if ref is not None else None
                if victim is None or self._cache.pop(victim, None) is None:
                    break
            self._cache[store] = (gen, ids_f, tie_f)
        return ids_f, tie_f

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        a = -1 if self.allowed is None else self.allowed.size
        d = -1 if self.disallowed is None else self.disallowed.size
        return f"IdFilter(allowed={'all' if a < 0 else a}, denied={max(d, 0)})"


def as_filter(where) -> Optional[IdFilter]:
    """Coerce a ``where=`` argument: IdFilter passes through, an
    array-like of ids is an allowlist shorthand, None means unfiltered."""
    if where is None or isinstance(where, IdFilter):
        return where
    return IdFilter(allowed_ids=where)
