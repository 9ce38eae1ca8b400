"""Redis bucket storage backend (migration-parity).

Implements the same bucket contract over redis-py as the upstream `lshrs`
backend (`lshrs/storage/redis.py`): Redis sets keyed
``{prefix}:{band_id}:bucket:{signature_hex}``, pipelined batch inserts,
SCAN-based removal and clear, and a pooled connection with timeouts.

This backend exists so that users of the Redis index can switch without
changing their durability story; the device engine is
`lshrs_tpu_torch.storage.device.DeviceStore`. redis-py is an optional
dependency, imported on first construction. Keys are the reference
package's, byte for byte, so both packages read and write the same keys.
"""

from __future__ import annotations

from collections.abc import Iterable, Iterator, Sequence
from contextlib import contextmanager
from typing import Any, Optional

from lshrs_tpu_torch.storage.base import BaseStorage, BucketOperation

__all__ = ["RedisStorage", "BucketOperation"]


def _require_redis():
    try:
        import redis  # type: ignore[import-not-found]
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "redis-py is required for RedisStorage. Install it via `pip install redis`."
        ) from e
    return redis


class RedisStorage(BaseStorage):
    """Bucket store over Redis sets with pooled, pipelined access."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 6379,
        db: int = 0,
        password: Optional[str] = None,
        *,
        prefix: str = "lsh",
        decode_responses: bool = False,
        max_connections: int = 50,
    ) -> None:
        redis = _require_redis()
        self.prefix = prefix
        self._pool = redis.ConnectionPool(
            host=host,
            port=port,
            db=db,
            password=password,
            decode_responses=decode_responses,
            max_connections=max_connections,
            socket_connect_timeout=5,
            socket_timeout=5,
            retry_on_timeout=True,
        )
        self._client = redis.Redis(connection_pool=self._pool)

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        self._pool.disconnect()

    def __del__(self) -> None:  # pragma: no cover - GC timing dependent
        try:
            self.close()
        except Exception:
            pass

    @property
    def client(self):
        """The underlying redis-py client (escape hatch)."""
        return self._client

    # -- keys ---------------------------------------------------------------

    def bucket_key(self, band_id: int, hash_val: bytes) -> str:
        """Key for one band bucket: ``{prefix}:{band}:bucket:{hex}``."""
        sig = hash_val.hex() if isinstance(hash_val, (bytes, bytearray)) else str(hash_val)
        return f"{self.prefix}:{band_id}:bucket:{sig}"

    # -- bucket ops ----------------------------------------------------------

    def add_to_bucket(self, band_id: int, hash_val: bytes, index: int) -> None:
        self._client.sadd(self.bucket_key(band_id, hash_val), int(index))

    def get_bucket(self, band_id: int, hash_val: bytes) -> set[int]:
        members = self._client.smembers(self.bucket_key(band_id, hash_val))
        return {int(m) for m in members}

    def batch_add(self, operations: Sequence[BucketOperation]) -> None:
        """One pipelined round-trip of SADDs for a whole flush batch."""
        if not operations:
            return
        pipe = self._client.pipeline(transaction=False)
        for band_id, hash_val, index in operations:
            pipe.sadd(self.bucket_key(band_id, hash_val), int(index))
        pipe.execute()

    def remove_indices(self, indices: Iterable[int]) -> None:
        """Remove ids from every bucket (SCAN + pipelined SREM)."""
        to_remove = [int(i) for i in indices]
        if not to_remove:
            return
        pattern = f"{self.prefix}:*:bucket:*"
        pipe = self._client.pipeline(transaction=False)
        for key in self._client.scan_iter(match=pattern, count=1000):
            pipe.srem(key, *to_remove)
        pipe.execute()

    def clear(self) -> None:
        """Delete every key under this prefix."""
        keys = list(self._client.scan_iter(match=f"{self.prefix}:*", count=1000))
        if keys:
            self._client.delete(*keys)

    @contextmanager
    def pipeline(self) -> Iterator[Any]:
        """Context-managed pipeline that executes on clean exit."""
        pipe = self._client.pipeline(transaction=False)
        try:
            yield pipe
            pipe.execute()
        finally:
            pipe.reset()
