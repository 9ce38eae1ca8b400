"""Hermetic in-memory bucket storage.

A dictionary-of-sets backend with the same observable semantics as the
reference's Redis bucket store (sets keyed by ``(band, signature)``,
upstream `lshrs/storage/redis.py`), usable without any server.
It doubles as the test fake (the reference's ``MockStorage`` analogue,
upstream `tests/conftest.py`) via the operation-recording fields
and ``fail_on_flush``.
"""

from __future__ import annotations

import threading
from collections.abc import Iterable, Sequence

from lshrs_tpu_torch.storage.base import BaseStorage, BucketOperation

__all__ = ["MemoryStorage"]


class MemoryStorage(BaseStorage):
    """Thread-safe dict-of-sets bucket store with operation recording."""

    def __init__(self, *, fail_on_flush: bool = False) -> None:
        # (band_id, signature_hex) -> set of vector indices
        self.data: dict[tuple[int, str], set[int]] = {}
        # Introspection hooks used by tests (mirrors MockStorage's fields).
        self.batches: list[list[BucketOperation]] = []
        self.all_operations: list[BucketOperation] = []
        self.batch_add_call_count: int = 0
        self.close_called: bool = False
        self.clear_called: bool = False
        self.removed_indices: list[list[int]] = []
        self._lock = threading.Lock()
        self._fail_on_flush = fail_on_flush

    @staticmethod
    def _key(band_id: int, hash_val: bytes) -> tuple[int, str]:
        sig = hash_val.hex() if isinstance(hash_val, (bytes, bytearray)) else str(hash_val)
        return (band_id, sig)

    def batch_add(self, operations: Sequence[BucketOperation]) -> None:
        if self._fail_on_flush:
            raise ConnectionError("Simulated storage failure")
        with self._lock:
            self.batch_add_call_count += 1
            ops = list(operations)
            self.batches.append(ops)
            self.all_operations.extend(ops)
            for band_id, hash_val, index in ops:
                self.data.setdefault(self._key(band_id, hash_val), set()).add(index)

    def add_to_bucket(self, band_id: int, hash_val: bytes, index: int) -> None:
        with self._lock:
            self.data.setdefault(self._key(band_id, hash_val), set()).add(index)

    def get_bucket(self, band_id: int, hash_val: bytes) -> set[int]:
        with self._lock:
            return set(self.data.get(self._key(band_id, hash_val), set()))

    def remove_indices(self, indices: Iterable[int]) -> None:
        with self._lock:
            removed = [int(i) for i in indices]
            self.removed_indices.append(removed)
            drop = set(removed)
            for bucket in self.data.values():
                bucket -= drop

    def clear(self) -> None:
        with self._lock:
            self.clear_called = True
            self.data.clear()

    def close(self) -> None:
        self.close_called = True

    # -- introspection helpers -------------------------------------------

    @property
    def total_operations(self) -> int:
        with self._lock:
            return len(self.all_operations)

    @property
    def unique_indices(self) -> set[int]:
        with self._lock:
            return {idx for _, _, idx in self.all_operations}
