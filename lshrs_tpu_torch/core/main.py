"""LSHRS orchestrator: hashing + device store + buffered ingestion + top-k.

The PyTorch port of `lshrs_tpu.core.main.LSHRS`, first slice: the device
backend's build and top-k serving path.

    ingest/index -> batch hash (one matmul + bitpack; or host sgemm +
                    dense wire with hash_mode="host")
                 -> store append (device tensors, in place)
    query        -> hash -> kernel B1 (collision) or B2 (Hamming) group
                    max -> exact top-k groups -> refine -> ids

Same public contract as the reference for this slice: validation
messages, ``(-collision_count, id)`` ordering, the ``engine="auto"``
switch to Hamming ranking at ``_AUTO_HAMMING_CAPACITY`` slots, and
buffer-restore-on-failed-flush semantics.

Not ported yet (each raises ``NotImplementedError``; ROADMAP Queue A):
top-p rerank and the resident payload, candidate enumeration
(``top_k=None``), id filters, multi-probe, MIPS, the non-gaussian hash
families, bucket backends, sharding, delete, persistence and retuning.
"""

from __future__ import annotations

import logging
from collections.abc import Callable, Sequence
from threading import Lock
from typing import Any, Optional

import numpy as np
import torch

from lshrs_tpu_torch.hash.hasher import LSHHasher
from lshrs_tpu_torch.storage.device import DeviceStore
from lshrs_tpu_torch.storage.filter import as_filter
from lshrs_tpu_torch.utils.br import get_optimal_config

logger = logging.getLogger(__name__)

VectorFetchFn = Callable[[Sequence[int]], np.ndarray]

__all__ = ["LSHRS", "VectorFetchFn"]


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A)")


class LSHRS:
    """Locality-sensitive-hashing index over dense float32 vectors.

    Signatures are banded random hyperplane projections, kept in a
    device-resident signature store (`lshrs_tpu_torch.storage.DeviceStore`)
    and queried with the hand-written group-max kernels.

    Args:
        dim: vector dimensionality (> 0).
        num_perm: total projection bits (``num_bands * rows_per_band``).
        num_bands / rows_per_band: banding scheme; auto-tuned from
            ``similarity_threshold`` when either is omitted.
        similarity_threshold: target similarity for auto-tuning.
        buffer_size: buffered operations (vector count x bands) that
            trigger an automatic flush.
        vector_fetch_fn: callable returning ``(n, dim)`` vectors for ids,
            used by ``index(ids)`` without vectors.
        seed: projection seed (the reference package's seeded draw).
        initial_capacity / chunk_size / group_size / dedupe: device store
            sizing and engine knobs, see `DeviceStore`.
        enable_hamming: maintain int8 bitplanes for Hamming ranking.
        hash_mode: ``"device"`` (one float32 matmul per batch on the
            device) or ``"host"`` (NumPy sgemm, ships the dense signature
            wire). One path per instance, so stored and query signatures
            agree bit for bit.
        engine: top-k ranking — ``"collision"`` (band-collision counting,
            reference parity), ``"hamming"`` (full-signature Hamming) or
            ``"auto"`` (default: collision below `_AUTO_HAMMING_CAPACITY`
            slots, Hamming from there on; pinned at first resolution).
        device: where the store and the device hash live (``"cuda"`` by
            default; ``"cpu"`` runs the kernels' plain PyTorch versions).

    ``backend``, ``store_vectors``, ``shards``, ``hash_family``,
    ``multiprobe`` and ``similarity`` are accepted only at their defaults.
    """

    # Capacity at which the auto engine switches top-k ranking from
    # band-collision counting to Hamming — the reference package's
    # threshold, kept identical so both resolve the same engine.
    _AUTO_HAMMING_CAPACITY = 1 << 19

    def __init__(
        self,
        *,
        dim: int,
        num_perm: int = 128,
        num_bands: Optional[int] = None,
        rows_per_band: Optional[int] = None,
        similarity_threshold: float = 0.5,
        buffer_size: int = 10_000,
        vector_fetch_fn: Optional[VectorFetchFn] = None,
        backend: str = "device",
        store_vectors: bool = False,
        seed: int = 42,
        initial_capacity: int = 1 << 14,
        chunk_size: int = 2048,
        shards: Optional[int] = None,
        enable_hamming: bool = False,
        group_size: int = 64,
        dedupe: bool = True,
        hash_mode: str = "device",
        hash_family: str = "gaussian",
        engine: str = "auto",
        multiprobe: int = 1,
        similarity: str = "cosine",
        device: str | torch.device = "cuda",
    ) -> None:
        if dim <= 0:
            raise ValueError("Vector dimensionality must be greater than zero")
        if num_perm <= 0:
            raise ValueError("num_perm must be greater than zero")
        if buffer_size <= 0:
            raise ValueError("buffer_size must be greater than zero")
        if hash_mode not in ("device", "host"):
            raise ValueError("hash_mode must be 'device' or 'host'")
        if engine not in ("auto", "collision", "hamming"):
            raise ValueError("engine must be 'auto', 'collision' or 'hamming'")
        if backend != "device":
            raise _not_ported(f"backend={backend!r} (bucket backends: I/O and Redis)")
        if store_vectors:
            raise _not_ported("store_vectors (top-p rerank)")
        if shards is not None and shards > 1:
            raise _not_ported("shards (sharding)")
        if multiprobe != 1:
            raise _not_ported("multiprobe")
        if similarity != "cosine":
            raise _not_ported(f"similarity={similarity!r} (MIPS)")
        if engine != "collision":
            # The auto/hamming engines rank on int8 bitplanes (kernel B2).
            enable_hamming = True

        if num_bands is None or rows_per_band is None:
            num_bands, rows_per_band = get_optimal_config(num_perm, similarity_threshold)
        if num_bands * rows_per_band != num_perm:
            raise ValueError(
                "num_bands * rows_per_band must equal num_perm "
                f"(received {num_bands} * {rows_per_band} != {num_perm})"
            )

        self._engine = engine
        self._engine_resolved: Optional[str] = None
        self._dim = dim
        self._buffer_size = buffer_size
        self._vector_fetch_fn = vector_fetch_fn
        self._hash_on_device = hash_mode == "device"
        self._hasher = LSHHasher(
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            dim=dim,
            seed=seed,
            hash_family=hash_family,
            device=device,
        )
        self._storage = DeviceStore(
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            dim=dim,
            initial_capacity=initial_capacity,
            chunk_size=chunk_size,
            enable_hamming=enable_hamming,
            group_size=group_size,
            dedupe=dedupe,
            device=device,
        )

        # Write buffer of (ids, words) batch records.
        self._buffer: list = []
        self._buffer_lock = Lock()
        self._counters = {"vectors_ingested": 0, "queries_served": 0, "flushes": 0}
        self._counter_lock = Lock()
        self._config: dict[str, Any] = {
            "num_perm": num_perm,
            "num_bands": num_bands,
            "rows_per_band": rows_per_band,
            "similarity_threshold": similarity_threshold,
            "device": str(self._storage.device),
        }

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------

    def ingest(self, index: int, vector: np.ndarray) -> None:
        """Hash one vector and buffer it; searchable after the next flush
        (explicit, at buffer capacity, or via ``index()``)."""
        if index < 0:
            raise ValueError("index must be non-negative")
        vec = self._prepare_vector(vector)
        record = (np.asarray([index], dtype=np.int64), self._hash_for_ingest(vec[None, :]))
        with self._buffer_lock:
            self._buffer.append(record)
        self._count("vectors_ingested")
        self._flush_buffer_if_needed()

    def index(self, indices: Sequence[int], vectors: Optional[np.ndarray] = None) -> None:
        """Index a batch of vectors and flush, making them searchable.

        ``vectors=None`` fetches the batch through ``vector_fetch_fn``.
        """
        if indices is None or len(indices) == 0:
            return
        self._commit_index_batch(self._prepare_index_batch(indices, vectors))

    def _validate_index_batch(self, indices, vectors):
        """Shared `index()` validation -> ``(idx_arr, float32 arr)``."""
        if vectors is None:
            if self._vector_fetch_fn is None:
                raise RuntimeError(
                    "vector_fetch_fn must be supplied for operations requiring reranking"
                )
            vectors = self._vector_fetch_fn(indices)
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self._dim:
            raise ValueError(
                f"Vectors must have shape (n, {self._dim}); received {arr.shape}"
            )
        if arr.shape[0] != len(indices):
            raise ValueError(
                "Number of vectors does not match number of indices "
                f"(received {arr.shape[0]} vectors for {len(indices)} indices)"
            )
        idx_arr = np.asarray(indices, dtype=np.int64).reshape(-1)
        if idx_arr.size and int(idx_arr.min()) < 0:
            raise ValueError("index must be non-negative")
        # Zero-row rejection: only rows whose first coordinate is ~0 can
        # be all-zero, so scan just those fully.
        cand = np.flatnonzero(np.abs(arr[:, 0]) <= 1e-8)
        if cand.size and np.any(np.all(np.abs(arr[cand]) <= 1e-8, axis=1)):
            raise ValueError(
                "Cannot index zero vector - norm undefined. Check embeddings for corruption."
            )
        return idx_arr, arr

    def _prepare_index_batch(self, indices, vectors):
        """`index()` stage 1: validate, and hash on the host in host mode.
        Device mode defers the hash to the store's fused build."""
        idx_arr, arr = self._validate_index_batch(indices, vectors)
        if self._hash_on_device:
            return (idx_arr, None, arr)
        return (idx_arr, self._hasher.hash_batch_dense_host(arr), None)

    def _commit_index_batch(self, record) -> None:
        """`index()` stage 2: store the batch (flushing buffered singles
        first, in order) and count it."""
        idx_arr, words, vecs = record
        if words is None:  # device hash + append
            self.flush()
            self._storage.add_vectors_batch(idx_arr, vecs, self._hasher.device_projection())
            self._count("vectors_ingested", idx_arr.size)
            self._count("flushes")
            return
        with self._buffer_lock:
            self._buffer.append((idx_arr, words))
        self._count("vectors_ingested", idx_arr.size)
        self.flush()

    def flush(self) -> None:
        """Write buffered batches to the store in one append.

        On failure the snapshot is restored to the front of the buffer
        (order-preserving) and the exception re-raised, so a retry flushes
        the same data.
        """
        with self._buffer_lock:
            if not self._buffer:
                return
            pending = list(self._buffer)
            self._buffer.clear()
        try:
            if len(pending) == 1:
                ids, words = pending[0]
            else:
                ids = np.concatenate([rec[0] for rec in pending])
                if isinstance(pending[0][1], torch.Tensor):
                    words = torch.cat([rec[1] for rec in pending])
                else:
                    words = np.concatenate([rec[1] for rec in pending])
            self._storage.add_signature_batch(ids, words)
            self._count("flushes")
        except Exception as e:
            logger.error(f"Failed to flush buffer to storage: {e}")
            with self._buffer_lock:
                self._buffer[0:0] = pending
            raise

    def _count(self, key: str, n: int = 1) -> None:
        with self._counter_lock:
            self._counters[key] += n

    def _buffered_ops(self) -> int:
        """Pending operation count (each vector counts num_bands ops)."""
        return sum(rec[0].size for rec in self._buffer) * self._config["num_bands"]

    def _flush_buffer_if_needed(self) -> None:
        with self._buffer_lock:
            should_flush = self._buffered_ops() >= self._buffer_size
        if should_flush:
            self.flush()

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _use_hamming_ranking(self) -> bool:
        """True when top-k queries rank by full-signature Hamming.

        ``engine="collision"`` never does; ``engine="hamming"`` always
        does; ``engine="auto"`` switches once the store's capacity reaches
        `_AUTO_HAMMING_CAPACITY`, and the switch is pinned at first
        resolution (``stats()["engine_resolved"]``): capacity only grows,
        and result ordering never changes back.
        """
        if not self._storage.enable_hamming:
            return False
        if self._engine == "hamming":
            return True
        if self._engine != "auto":
            return False
        if self._engine_resolved == "hamming":
            return True
        switched = self._storage._capacity >= self._AUTO_HAMMING_CAPACITY
        if switched:
            self._engine_resolved = "hamming"
            logger.info(
                "engine='auto': index capacity reached %d slots; top-k "
                "ranking switched from band-collision counting to "
                "full-signature Hamming (pinned for this index).",
                self._AUTO_HAMMING_CAPACITY,
            )
        return switched

    def query(
        self,
        vector: np.ndarray,
        *,
        top_k: Optional[int] = 10,
        top_p: Optional[float] = None,
        where=None,
    ) -> list[int]:
        """Ids of the ``top_k`` best candidates for one query vector.

        Collision ranking orders by ``(-count, id)`` and returns only
        colliding ids; Hamming ranking (``engine="auto"`` past the switch,
        or ``"hamming"``) orders by ``(hamming, id)``.
        """
        if top_p is not None:
            raise _not_ported("top_p (top-p rerank)")
        if top_k is None:
            raise _not_ported("top_k=None (candidate enumeration)")
        if top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        as_filter(where)
        query_vector = self._prepare_vector(vector)
        self._count("queries_served")
        qwords = self._hash_words(query_vector[None, :])
        if self._use_hamming_ranking():
            _, ids = self._storage.query_hamming(qwords, top_k)
            return [int(i) for i in ids[0] if i >= 0]
        counts, ids = self._storage.query_topk(qwords, top_k)
        return [int(i) for i, c in zip(ids[0], counts[0]) if c > 0]

    def query_batch(
        self, vectors: np.ndarray, *, top_k: int = 10, where=None
    ) -> list[list[int]]:
        """Batched top-k query: one hash matmul and one fused scan."""
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        as_filter(where)
        arr = self._validate_batch(vectors)
        self._count("queries_served", arr.shape[0])
        qwords = self._hash_words(arr)
        if self._use_hamming_ranking():
            _, ids = self._storage.query_hamming(qwords, top_k)
            return [[int(i) for i in row if i >= 0] for row in ids]
        counts, ids = self._storage.query_topk(qwords, top_k)
        return [
            [int(i) for i, c in zip(row_ids, row_counts) if c > 0]
            for row_ids, row_counts in zip(ids, counts)
        ]

    def get_top_k(self, vector: np.ndarray, topk: int = 10) -> list[int]:
        """Top ``topk`` candidate ids (see :meth:`query`)."""
        return self.query(vector, top_k=topk)

    def serving_fn(self, top_k: int = 10, *, mode: Optional[str] = None, where=None):
        """Serving closure over the *current* index.

        Each call hashes its batch through this instance's hash path and
        runs one store query. With ``hash_mode="host"`` the dense wire is
        what reaches the device. Mutating the index invalidates the
        closure (it raises ``RuntimeError``) — take a new one after
        ingesting.

        Args:
            top_k: result depth per query.
            mode: ``"collision"``, ``"hamming"`` (requires Hamming ranking
                to be available) or ``None`` (default): the instance's
                resolved ranking engine.

        Returns:
            callable ``(vectors (Q, dim)) -> (Q, top_k) int32 ndarray`` of
            ids, -1 padded.
        """
        if mode in ("asymmetric", "topp"):
            raise _not_ported(f"mode={mode!r}")
        if mode is None:
            mode = "hamming" if self._use_hamming_ranking() else "collision"
        if mode not in ("collision", "hamming"):
            raise ValueError("mode must be 'collision' or 'hamming'")
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        serve = self._storage.snapshot_query_fn(
            top_k,
            wire="words" if self._hash_on_device else "dense",
            mode=mode,
            where=where,
        )

        def run(vectors) -> np.ndarray:
            arr = self._validate_batch(vectors)
            out = serve(self._hash_for_ingest(arr)).cpu().numpy()
            # Count after the dispatch: stale-snapshot calls raise and must
            # not inflate queries_served.
            self._count("queries_served", arr.shape[0])
            return out

        return run

    # ------------------------------------------------------------------
    # maintenance / introspection
    # ------------------------------------------------------------------

    def clear(self) -> None:
        """Flush, then drop every indexed entry (projections are kept)."""
        self.flush()
        self._storage.clear()

    def stats(self) -> dict[str, Any]:
        """Configuration snapshot plus counters and store statistics."""
        with self._buffer_lock:
            buffered = self._buffered_ops()
        with self._counter_lock:
            counters = dict(self._counters)
        return {
            "dimension": self._dim,
            "num_perm": self._config["num_perm"],
            "num_bands": self._config["num_bands"],
            "rows_per_band": self._config["rows_per_band"],
            "buffer_size": self._buffer_size,
            "similarity_threshold": self._config["similarity_threshold"],
            "backend": "device",
            "device": self._config["device"],
            "engine": self._engine,
            "engine_resolved": self._engine_resolved,
            "ranking": "hamming" if self._use_hamming_ranking() else "collision",
            "buffered_operations": buffered,
            "counters": counters,
            "index": self._storage.stats(),
        }

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _hash_words(self, arr: np.ndarray):
        """Query hashing through this instance's single hash path: device
        int32 words, or host uint32 words in host mode."""
        if self._hash_on_device:
            return self._hasher.hash_batch_words(arr)
        return self._hasher.hash_batch_words_host(arr)

    def _hash_for_ingest(self, arr: np.ndarray):
        """Wire hashing: device words, or the dense host wire in host mode
        (half the bytes of the word layout at r <= 16)."""
        if self._hash_on_device:
            return self._hasher.hash_batch_words(arr)
        return self._hasher.hash_batch_dense_host(arr)

    def _validate_batch(self, vectors) -> np.ndarray:
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self._dim:
            raise ValueError(
                f"Vectors must have shape (n, {self._dim}); received {arr.shape}"
            )
        return arr

    def _prepare_vector(self, vector: np.ndarray) -> np.ndarray:
        arr = np.asarray(vector, dtype=np.float32).reshape(-1)
        if arr.shape[0] != self._dim:
            raise ValueError(
                f"Vector must have dimension {self._dim}; received {arr.shape[0]}"
            )
        if np.allclose(arr, 0.0, atol=1e-8):
            raise ValueError(
                "Cannot index zero vector - norm undefined. Check embeddings for corruption."
            )
        return arr
