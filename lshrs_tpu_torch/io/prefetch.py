"""Background-thread prefetch for streaming loaders.

Overlaps host IO (Parquet page decode, Postgres fetches) with device
ingestion: a daemon thread pulls ``(indices, vectors)`` batches from the
underlying iterator into a bounded queue while the consumer hashes and
appends the previous batch on the device. Upstream `lshrs` streams
strictly serially (loader -> index -> loader); this pipeline keeps the
card busy during IO stalls.

When the consumer stops early, the producer stays blocked on its queue:
it is a daemon thread, so it never holds the interpreter open.

Exceptions raised by the source iterator are re-raised in the consumer at
the point of the failed batch, preserving the reference's error surface.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterable, Iterator
from typing import Any

__all__ = ["prefetch_batches"]

_SENTINEL = object()


def prefetch_batches(source: Iterable[Any], depth: int = 2) -> Iterator[Any]:
    """Iterate ``source`` with ``depth`` batches prefetched in a thread.

    Args:
        source: any iterable of batches.
        depth: maximum batches buffered ahead of the consumer (>= 1).
    """
    if depth <= 0:
        raise ValueError("depth must be greater than zero")
    q: queue.Queue = queue.Queue(maxsize=depth)

    def producer() -> None:
        try:
            for item in source:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            q.put((_SENTINEL, e))
            return
        q.put((_SENTINEL, None))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
            err = item[1]
            if err is not None:
                raise err
            return
        yield item
