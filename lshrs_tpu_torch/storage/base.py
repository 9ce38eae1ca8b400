"""Storage backend contract.

The orchestrator talks to storage at two levels:

1. **Bucket level** (reference-compatible): batches of
   ``BucketOperation = (band_id, signature_bytes, index)`` tuples and
   per-band bucket reads — the exact contract of the reference's
   `RedisStorage` (upstream `lshrs/storage/redis.py`).
   Any backend implementing this works with the orchestrator's host query
   path (per-band bucket lookups + dict collision counting).

2. **Signature-batch level** (device-native): whole ``(n, num_bands * W)``
   uint32 word batches with integer ids. Backends that set
   ``supports_signature_batches = True`` (the device store) receive
   ingestion in this form and serve fused device-side queries; the
   orchestrator never materialises byte strings on that path.
"""

from __future__ import annotations

import abc
from collections.abc import Iterable, Sequence

# (band_id, packed_signature_bytes, vector_index)
BucketOperation = tuple[int, bytes, int]

__all__ = ["BucketOperation", "BaseStorage"]


class BaseStorage(abc.ABC):
    """Abstract bucket-level storage backend."""

    #: True when the backend natively accepts packed signature-word batches
    #: and serves device-side queries (see `lshrs_tpu_torch.storage.device`).
    supports_signature_batches: bool = False

    @abc.abstractmethod
    def batch_add(self, operations: Sequence[BucketOperation]) -> None:
        """Apply a batch of bucket-insert operations atomically-ish."""

    @abc.abstractmethod
    def add_to_bucket(self, band_id: int, hash_val: bytes, index: int) -> None:
        """Insert one index into one band bucket."""

    @abc.abstractmethod
    def get_bucket(self, band_id: int, hash_val: bytes) -> set[int]:
        """Return the set of indices stored in one band bucket."""

    @abc.abstractmethod
    def remove_indices(self, indices: Iterable[int]) -> None:
        """Remove the given indices from every bucket."""

    @abc.abstractmethod
    def clear(self) -> None:
        """Drop all buckets."""

    def close(self) -> None:  # pragma: no cover - trivial default
        """Release backend resources (connections, device buffers)."""
