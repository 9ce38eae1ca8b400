"""LSHRS orchestrator: hashing + device store + buffered ingestion + top-k.

The PyTorch port of `lshrs_tpu.core.main.LSHRS` for the device backend:
build, exact top-k serving, top-p cosine rerank, delete and compact, and
persistence.

    ingest/index -> batch hash (gaussian / learned: one matmul + bitpack;
                    structured / cross-polytope: FWHT rotations; on the
                    device, or on the host — sgemm or the native C FWHT —
                    shipping the dense wire with hash_mode="host")
                 -> store append (device tensors, in place; with
                    store_vectors the payload rows too)
    query        -> hash (with multiprobe=T: T probe signatures per
                    query for collision counting and top-p) -> kernel B1
                    (collision), B2 (Hamming on bitplanes) or B3 (Hamming
                    on packed words) group max -> exact top-k groups ->
                    refine -> ids; where= ranks only the admitted ids
    top-p        -> hash -> collision counts (full engine) or kernel B1's
                    candidate gather -> cosine rerank over the resident
                    payload -> (id, cosine); or, without a payload, the
                    enumerated candidates through vector_fetch_fn and a
                    host rerank
    delete       -> tombstones (id -1); compact rebuilds the dense prefix
    save/load    -> metadata.json + projections.npz (diagonals.npz for the
                    structured and cross-polytope families) + index.npz,
                    the reference package's format (checkpoints load
                    across the two packages)

Same public contract as the reference for these paths: validation
messages, ``(-collision_count, id)`` ordering, ``(cosine desc, id asc)``
rerank ordering, the ``engine="auto"`` switch to Hamming ranking at
``_AUTO_HAMMING_CAPACITY`` slots (pinned and persisted), and
buffer-restore-on-failed-flush semantics.

Not ported yet (each raises ``NotImplementedError``; ROADMAP Queue A):
MIPS, the asymmetric and cascade modes, the bucketed engine, bucket
backends, sharding and retuning (``rehash`` / ``retrain``).
"""

from __future__ import annotations

import json
import logging
import math
from collections.abc import Callable, Sequence
from pathlib import Path
from threading import Lock
from typing import Any, Optional, Union

import numpy as np
import torch

from lshrs_tpu_torch.hash.hasher import LSHHasher
from lshrs_tpu_torch.storage.device import DeviceStore
from lshrs_tpu_torch.storage.filter import as_filter
from lshrs_tpu_torch.utils.br import get_optimal_config
from lshrs_tpu_torch.utils.cp import get_optimal_cp_config
from lshrs_tpu_torch.utils.similarity import top_k_cosine

logger = logging.getLogger(__name__)

VectorFetchFn = Callable[[Sequence[int]], np.ndarray]

__all__ = ["LSHRS", "VectorFetchFn"]

CandidateScores = list[tuple[int, float]]

# The reference package's checkpoint format version (metadata.json).
_METADATA_VERSION = "0.1.0"
# The reference's bucket-backend connection block. The port serves the
# device backend only, but writes the block so that the reference package
# can read the port's checkpoints.
_REDIS_CONFIG_DEFAULTS = {
    "host": "localhost",
    "port": 6379,
    "db": 0,
    "password": "<REDACTED>",
    "prefix": "lsh",
    "decode_responses": False,
    "max_connections": 50,
}


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A)")


class LSHRS:
    """Locality-sensitive-hashing index over dense float32 vectors.

    Signatures are banded hash signatures (random hyperplanes, FWHT
    rotations or cross-polytope symbols, by ``hash_family``), kept in a
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
            used by ``index(ids)`` without vectors, and by top-p rerank
            unless ``store_vectors=True``.
        store_vectors: keep the vectors resident on the device (the
            payload), so top-p reranks there without a fetch round trip.
        payload_dtype / rerank_engine / rerank_candidates: the payload's
            precision (``"float32"``, ``"bfloat16"`` or ``"int8"``), the
            top-p formulation (``"full"``, ``"gather"`` or ``"auto"``) and
            the gather engine's per-query candidate budget; see
            `DeviceStore`.
        seed: projection seed (the reference package's seeded draw).
        initial_capacity / chunk_size / group_size / dedupe: device store
            sizing and engine knobs, see `DeviceStore`.
        enable_hamming: make full-signature Hamming ranking available.
        hamming_storage: ``"planes"`` (int8 bitplanes, kernel B2,
            ``num_perm`` bytes per slot) or ``"packed"`` (XOR + popcount
            over the stored words, kernel B3, zero extra bytes); ``None``
            (default) means ``"planes"``. An explicit ``"packed"`` is kept
            when the auto/hamming engine turns Hamming ranking on.
        hash_mode: ``"device"`` (hash on the device) or ``"host"`` (NumPy
            sgemm or the native C FWHT; ships the dense signature wire).
            One path per instance, so stored and query signatures agree
            bit for bit.
        hash_family: ``"gaussian"`` (seeded hyperplanes), ``"structured"``
            (FWHT rotations, bit-identical on host and device),
            ``"learned"`` (hyperplanes fitted with
            `lshrs_tpu_torch.hash.itq`, assigned through
            ``_hasher.projections``) or ``"crosspolytope"`` (one
            signed-argmax symbol per band; collision counting and top-p
            only, ``engine`` is forced to ``"collision"``); see `LSHHasher`.
        multiprobe: query-directed multi-probe depth T (default 1 = off,
            at most ``rows_per_band``, or ``2^(rows_per_band-1)`` for
            cross-polytope). Collision top-k, candidate enumeration and
            top-p count a band that matches ANY of the query's T probe
            signatures; Hamming ranking scores every slot already and
            uses probe 0.
        engine: top-k ranking — ``"collision"`` (band-collision counting,
            reference parity), ``"hamming"`` (full-signature Hamming) or
            ``"auto"`` (default: collision below `_AUTO_HAMMING_CAPACITY`
            slots, Hamming from there on; pinned at first resolution).
        device: where the store and the device hash live (``"cuda"`` by
            default; ``"cpu"`` runs the kernels' plain PyTorch versions).

    ``backend``, ``shards`` and ``similarity`` are accepted only at their
    defaults.
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
        hamming_storage: Optional[str] = None,
        hash_mode: str = "device",
        hash_family: str = "gaussian",
        payload_dtype: str = "float32",
        rerank_engine: str = "auto",
        rerank_candidates: int = 1024,
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
        if hash_family not in ("gaussian", "structured", "learned", "crosspolytope"):
            raise ValueError(
                "hash_family must be 'gaussian', 'structured', 'learned' "
                "or 'crosspolytope'"
            )
        if engine not in ("auto", "collision", "hamming"):
            raise ValueError("engine must be 'auto', 'collision' or 'hamming'")
        if hash_family == "crosspolytope":
            # Cross-polytope signatures are signed-argmax SYMBOLS, not sign
            # bits: Hamming distance over a symbol's binary encoding is
            # meaningless, so the bit-semantic engine is rejected rather
            # than silently mis-ranking. Collision counting + payload
            # rerank carry this family.
            if engine == "hamming":
                raise ValueError(
                    "engine='hamming' requires sign-bit signatures; the "
                    "cross-polytope family ranks by collision counting "
                    "(+ payload rerank)"
                )
            if enable_hamming:
                raise ValueError(
                    "enable_hamming is unavailable with "
                    "hash_family='crosspolytope': Hamming distance over "
                    "argmax symbols is not meaningful"
                )
            engine = "collision"
        if not isinstance(multiprobe, int) or multiprobe < 1:
            raise ValueError("multiprobe must be an integer >= 1")
        if backend != "device":
            raise _not_ported(f"backend={backend!r} (bucket backends: I/O and Redis)")
        if shards is not None and shards > 1:
            raise _not_ported("shards (sharding)")
        if similarity != "cosine":
            raise _not_ported(f"similarity={similarity!r} (MIPS)")
        # None means "planes"; an explicit "packed" (zero extra memory)
        # stays when the auto/hamming engine turns Hamming ranking on.
        if hamming_storage is None:
            hamming_storage = "planes"
        if hamming_storage not in ("planes", "packed"):
            raise ValueError("hamming_storage must be 'planes' or 'packed'")
        if engine != "collision":
            enable_hamming = True

        if num_bands is None or rows_per_band is None:
            if hash_family == "crosspolytope":
                # The sign-bit S-curve (p = s^r) does not describe
                # cross-polytope collisions; the CP tuner integrates a
                # Monte-Carlo collision curve instead.
                num_bands, rows_per_band = get_optimal_cp_config(
                    num_perm, similarity_threshold, dim
                )
            else:
                num_bands, rows_per_band = get_optimal_config(num_perm, similarity_threshold)
        if num_bands * rows_per_band != num_perm:
            raise ValueError(
                "num_bands * rows_per_band must equal num_perm "
                f"(received {num_bands} * {rows_per_band} != {num_perm})"
            )
        max_probes = (
            1 << (rows_per_band - 1) if hash_family == "crosspolytope" else rows_per_band
        )
        if multiprobe > max_probes:
            bound = "cp_dims" if hash_family == "crosspolytope" else "rows_per_band"
            raise ValueError(
                f"multiprobe must be <= {bound} "
                f"(= {max_probes}); received {multiprobe}"
            )
        self._multiprobe = multiprobe

        self._engine = engine
        self._dim = dim
        self._buffer_size = buffer_size
        self._vector_fetch_fn = vector_fetch_fn
        self._store_vectors = store_vectors
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
            hamming_storage=hamming_storage,
            group_size=group_size,
            dedupe=dedupe,
            store_vectors=store_vectors,
            payload_dtype=payload_dtype,
            rerank_engine=rerank_engine,
            rerank_candidates=rerank_candidates,
            device=device,
        )

        # Write buffer of (ids, words, vectors or None) batch records.
        self._buffer: list = []
        self._buffer_lock = Lock()
        self._counters = {
            "vectors_ingested": 0,
            "queries_served": 0,
            "flushes": 0,
            "deletes": 0,
        }
        self._counter_lock = Lock()
        # The reference's config blocks, key for key: they are what
        # save_to_disk writes and load_from_disk reads in both packages.
        self._config: dict[str, Any] = {
            "dim": dim,
            "num_perm": num_perm,
            "num_bands": num_bands,
            "rows_per_band": rows_per_band,
            "similarity_threshold": similarity_threshold,
            "buffer_size": buffer_size,
            "seed": seed,
            "similarity": similarity,
            "max_norm": None,
        }
        self._tpu_config: dict[str, Any] = {
            "backend": backend,
            "store_vectors": store_vectors,
            "initial_capacity": initial_capacity,
            "chunk_size": chunk_size,
            "shards": shards,
            "enable_hamming": enable_hamming,
            "group_size": group_size,
            "dedupe": dedupe,
            "query_mode": "scan",
            "bucket_cap": 128,
            "hash_mode": hash_mode,
            "hash_family": hash_family,
            "hamming_storage": hamming_storage,
            "hamming_cascade": 0,
            "hamming_cascade_refine": 2048,
            "payload_dtype": payload_dtype,
            "rerank_engine": rerank_engine,
            "rerank_candidates": rerank_candidates,
            "engine": engine,
            "multiprobe": multiprobe,
        }

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------

    def ingest(self, index: int, vector: np.ndarray) -> None:
        """Hash one vector and buffer it; searchable after the next flush
        (explicit, at buffer capacity, or via ``index()``)."""
        if index < 0:
            raise ValueError("index must be non-negative")
        vec = self._prepare_vector(vector)[None, :]
        record = (
            np.asarray([index], dtype=np.int64),
            self._hash_for_ingest(vec),
            vec if self._store_vectors else None,
        )
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
            vectors = self._require_vector_fetch_fn()(indices)
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
        return (
            idx_arr,
            self._hasher.hash_batch_dense_host(arr),
            arr if self._store_vectors else None,
        )

    def _commit_index_batch(self, record) -> None:
        """`index()` stage 2: store the batch (flushing buffered singles
        first, in order) and count it."""
        idx_arr, words, vecs = record
        if words is None:  # device hash + append
            self.flush()
            self._storage.add_vectors_batch(
                idx_arr, vecs, self._hasher.device_projection(),
                hash_family=self._hasher.hash_family,
            )
            self._count("vectors_ingested", idx_arr.size)
            self._count("flushes")
            return
        with self._buffer_lock:
            self._buffer.append(record)
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
                ids, words, vecs = pending[0]
            else:
                ids = np.concatenate([rec[0] for rec in pending])
                if isinstance(pending[0][1], torch.Tensor):
                    words = torch.cat([rec[1] for rec in pending])
                else:
                    words = np.concatenate([rec[1] for rec in pending])
                vecs = (
                    np.concatenate([rec[2] for rec in pending]) if self._store_vectors else None
                )
            self._storage.add_signature_batch(ids, words, vecs)
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
        resolution (``stats()["engine_resolved"]``) and persisted with the
        index: result ordering never changes back, across a save/load or
        pickle round trip too.
        """
        if not self._storage.enable_hamming:
            return False
        if self._engine == "hamming":
            return True
        if self._engine != "auto":
            return False
        if self._tpu_config.get("engine_resolved") == "hamming":
            return True
        switched = self._storage._capacity >= self._AUTO_HAMMING_CAPACITY
        if switched:
            self._tpu_config["engine_resolved"] = "hamming"
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
    ) -> Union[list[int], CandidateScores]:
        """Candidates for one query vector.

        Top-k mode (``top_p=None``): ids of the ``top_k`` best candidates.
        Collision ranking orders by ``(-count, id)`` and returns only
        colliding ids; Hamming ranking (``engine="auto"`` past the switch,
        or ``"hamming"``) orders by ``(hamming, id)``. ``top_k=None``
        returns every colliding candidate by ``(-count, id)``.

        Top-p mode: the colliding candidates reranked by cosine (resident
        payload, or ``vector_fetch_fn``), ordered by ``(cosine desc, id
        asc)``; returns the top ``max(1, ceil(n_candidates * top_p))`` as
        ``(id, cosine)`` tuples, capped by ``top_k`` when given.

        ``where``: optional `lshrs_tpu_torch.storage.IdFilter` (or an
        array-like allowlist of ids). Results rank ONLY the admitted
        subset — exact top-k / top-p over it, not post-filtering (a
        filtered-out candidate never consumes a result slot).
        """
        if top_k is not None and top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        if top_p is not None and not 0 < top_p <= 1:
            raise ValueError("top_p must be within the range (0, 1]")
        where = as_filter(where)
        query_vector = self._prepare_vector(vector)
        self._count("queries_served")
        if top_p is None and top_k is not None:
            if self._use_hamming_ranking():
                qwords = self._hash_words(query_vector[None, :])
                _, ids = self._storage.query_hamming(qwords, top_k, where=where)
                return [int(i) for i in ids[0] if i >= 0]
            qwords = self._hash_query_words(query_vector[None, :])
            counts, ids = self._storage.query_topk(qwords, top_k, where=where)
            return [int(i) for i, c in zip(ids[0], counts[0]) if c > 0]

        # Resident payload and no fetch callback: counts, cosines and the
        # cutoff on the device, only the (id, cosine) prefix reaches the host.
        if top_p is not None and self._store_vectors and self._vector_fetch_fn is None:
            return self._query_topp_device(query_vector, top_k, top_p, where=where)

        ordered = self._ordered_candidates(query_vector, where=where)
        if not ordered:
            return []
        if top_p is None:
            return [idx for idx, _ in ordered]
        candidate_indices = [idx for idx, _ in ordered]
        arr = self._fetch_candidates(candidate_indices)
        similarities = top_k_cosine(query_vector, arr, k=len(candidate_indices))
        ordered_scores = [(candidate_indices[pos], score) for pos, score in similarities]
        limit = max(1, math.ceil(len(ordered_scores) * top_p))
        if top_k is not None:
            limit = min(limit, top_k)
        return ordered_scores[:limit]

    # Prefix the single-query device rerank returns first (the reference's
    # bound); a top-p cutoff past it is reranked again at its own depth.
    _MAX_DEVICE_RERANK = 4096

    def _query_topp_device(
        self, query_vector: np.ndarray, top_k: Optional[int], top_p: float, where=None
    ) -> CandidateScores:
        """Top-p on the device store. A cutoff past the first prefix is
        reranked on the device again with the prefix the candidate count
        asks for: the payload never leaves the device (the reference
        reranks such cutoffs on the host)."""
        qwords = self._hash_query_words(query_vector[None, :])
        ids, sims, n = self._storage.query_topp(
            qwords, query_vector, self._MAX_DEVICE_RERANK, where=where
        )
        if n == 0:
            return []
        limit = max(1, math.ceil(n * top_p))
        if top_k is not None:
            limit = min(limit, top_k)
        if limit > len(ids):
            ids, sims, _ = self._storage.query_topp(qwords, query_vector, limit, where=where)
        return [(int(i), float(s)) for i, s in zip(ids[:limit], sims[:limit])]

    # First guess of the bounded candidate enumeration; it grows to the
    # next power of two of the device-counted candidate total.
    _CANDIDATE_ENUM_START = 4096

    def _ordered_candidates(
        self, query_vector: np.ndarray, where=None
    ) -> list[tuple[int, int]]:
        """Every colliding candidate as ``(id, count)``, by ``(-count, id)``.

        Bounded: the device counts the query's candidates (``query_nnz``,
        O(1) readback), then an exact collision top-M with M the next power
        of two of that count (at least `_CANDIDATE_ENUM_START`) returns
        them all; the ``(Q, C)`` count matrix never reaches the host. With
        ``multiprobe`` the candidates are the union over the probes (a
        band counts once, whichever probe it matches).
        """
        qwords = self._hash_query_words(query_vector[None, :])
        n = int(self._storage.query_nnz(qwords, where=where)[0])
        if n == 0:
            return []
        m = max(self._CANDIDATE_ENUM_START, 1 << (n - 1).bit_length())
        counts, ids = self._storage.query_topk(qwords, m, where=where)
        return [(int(i), int(c)) for i, c in zip(ids[0, :n], counts[0, :n])]

    def _fetch_candidates(self, candidate_indices: list[int]) -> np.ndarray:
        """Candidate vectors from the user callback (a resident payload is
        reranked on the device, never fetched)."""
        arr = np.asarray(self._require_vector_fetch_fn()(candidate_indices), dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self._dim:
            raise ValueError(
                f"Fetched vectors must have shape (n, {self._dim}); received {arr.shape}"
            )
        if arr.shape[0] != len(candidate_indices):
            raise ValueError(
                "vector_fetch_fn returned mismatched batch size "
                f"(expected {len(candidate_indices)}, received {arr.shape[0]})"
            )
        return arr

    def get_above_p(
        self, vector: np.ndarray, p: float = 0.95, *, where=None
    ) -> CandidateScores:
        """Cosine-reranked top ``ceil(p * n_candidates)`` scored results."""
        return list(self.query(vector, top_k=None, top_p=p, where=where))

    def get_above_p_batch(
        self,
        vectors: np.ndarray,
        p: float = 0.95,
        *,
        top_k: Optional[int] = None,
        max_candidates: int = 4096,
        wire_dtype: str = "float32",
        where=None,
    ) -> list[CandidateScores]:
        """Batched cosine-reranked top-p: one device rerank for the batch
        against the resident payload (``store_vectors=True``, no
        ``vector_fetch_fn``); otherwise a :meth:`query` per vector. Each
        query returns its top ``max(1, ceil(p * n_candidates))`` results,
        capped by ``top_k`` and ``max_candidates``.

        ``wire_dtype="bfloat16"`` ships the query vectors at half the bytes
        at ~1e-2 relative cosine error; ``"float32"`` is value-exact.
        """
        if not 0 < p <= 1:
            raise ValueError("top_p must be within the range (0, 1]")
        if top_k is not None and top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        if wire_dtype not in ("float32", "bfloat16"):
            raise ValueError("wire_dtype must be 'float32' or 'bfloat16'")
        arr = self._validate_batch(vectors)
        where = as_filter(where)
        if not self._store_vectors or self._vector_fetch_fn is not None:
            return [self.query(v, top_k=top_k, top_p=p, where=where) for v in arr]
        self._count("queries_served", arr.shape[0])
        # The cutoff is min(ceil(p * n), top_k): top_k bounds the prefix.
        max_out = min(max_candidates, top_k) if top_k is not None else max_candidates
        ids, sims, n = self._storage.query_topp_batch(
            self._hash_query_words(arr), arr, max_out, wire_dtype=wire_dtype, where=where
        )
        results: list[CandidateScores] = []
        for qi in range(arr.shape[0]):
            n_q = int(n[qi])
            if n_q == 0:
                results.append([])
                continue
            limit = max(1, math.ceil(n_q * p))
            if top_k is not None:
                limit = min(limit, top_k)
            limit = min(limit, ids.shape[1])
            results.append(
                [(int(i), float(s)) for i, s in zip(ids[qi, :limit], sims[qi, :limit]) if i >= 0]
            )
        return results

    def query_batch(
        self, vectors: np.ndarray, *, top_k: int = 10, where=None
    ) -> list[list[int]]:
        """Batched top-k query: one hash matmul and one fused scan."""
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        where = as_filter(where)
        arr = self._validate_batch(vectors)
        self._count("queries_served", arr.shape[0])
        if self._use_hamming_ranking():
            _, ids = self._storage.query_hamming(self._hash_words(arr), top_k, where=where)
            return [[int(i) for i in row if i >= 0] for row in ids]
        counts, ids = self._storage.query_topk(self._hash_query_words(arr), top_k, where=where)
        return [
            [int(i) for i, c in zip(row_ids, row_counts) if c > 0]
            for row_ids, row_counts in zip(ids, counts)
        ]

    def query_hamming(
        self, vector: np.ndarray, *, top_k: int = 10, where=None
    ) -> CandidateScores:
        """Rank by full-signature Hamming distance, whatever the engine.

        Requires ``enable_hamming=True`` (or an auto/hamming engine).
        Returns ``(id, estimated_cosine)`` tuples ordered by (hamming, id),
        where ``estimated_cosine = cos(pi * hamming / num_perm)``.
        """
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        query_vector = self._prepare_vector(vector)[None, :]
        self._count("queries_served")
        hamming, ids = self._storage.query_hamming(
            self._hash_words(query_vector), top_k, where=as_filter(where)
        )
        return self._hamming_scores(hamming, ids)[0]

    def query_hamming_batch(
        self, vectors: np.ndarray, *, top_k: int = 10, where=None
    ) -> list[CandidateScores]:
        """Batched :meth:`query_hamming` (one hash, one fused scan)."""
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        arr = self._validate_batch(vectors)
        self._count("queries_served", arr.shape[0])
        hamming, ids = self._storage.query_hamming(
            self._hash_words(arr), top_k, where=as_filter(where)
        )
        return self._hamming_scores(hamming, ids)

    def _hamming_scores(self, hamming: np.ndarray, ids: np.ndarray) -> list[CandidateScores]:
        num_perm = self._config["num_perm"]
        return [
            [
                (int(i), float(math.cos(math.pi * int(h) / num_perm)))
                for i, h in zip(row_ids, row_h)
                if i >= 0
            ]
            for row_ids, row_h in zip(ids, hamming)
        ]

    def get_top_k(self, vector: np.ndarray, topk: int = 10, *, where=None) -> list[int]:
        """Top ``topk`` candidate ids (see :meth:`query`)."""
        return self.query(vector, top_k=topk, where=where)

    def serving_fn(
        self,
        top_k: int = 10,
        *,
        mode: Optional[str] = None,
        wire_dtype: str = "float32",
        batch_hint: int = 1024,
        where=None,
    ):
        """Serving closure over the *current* index.

        Each call hashes its batch through this instance's hash path and
        runs one store query. With ``hash_mode="host"`` the dense wire is
        what reaches the device. Mutating the index invalidates the
        closure (it raises ``RuntimeError``) — take a new one after
        ingesting.

        Args:
            top_k: result depth per query.
            mode: ``"collision"``, ``"hamming"`` (requires Hamming ranking
                to be available), ``"topp"`` (cosine rerank against the
                resident payload; requires ``store_vectors=True``) or
                ``None`` (default): the instance's resolved ranking engine.
            wire_dtype: ``"topp"`` only — ``"bfloat16"`` rounds the query
                vectors to bf16 for the rerank (half the upload bytes in
                host hash mode; ~1e-2 relative cosine rounding);
                ``"float32"`` is value-exact.
            batch_hint: ``"topp"`` only — the batch size the closure will
                serve; the auto rerank engine sizes the full engine's
                ``(Q, capacity)`` temporaries from it.
            where: optional id filter baked into the snapshot: every batch
                ranks ONLY the admitted subset.

        With ``multiprobe=T`` the ``"collision"`` and ``"topp"`` closures
        hash T probe signatures per query (probe words on the device, or
        the dense probe wire from the host); ``"hamming"`` uses probe 0.

        Returns:
            ``"collision"`` / ``"hamming"``: callable ``(vectors (Q, dim))
            -> (Q, top_k) int32 ndarray`` of ids, -1 padded. ``"topp"``:
            callable returning ``(ids (Q, top_k) int32, cosines (Q, top_k)
            float32, n_candidates (Q,) int32)`` ndarrays.
        """
        if mode == "asymmetric":
            raise _not_ported(f"mode={mode!r}")
        if mode is None:
            mode = "hamming" if self._use_hamming_ranking() else "collision"
        if mode not in ("collision", "hamming", "topp"):
            raise ValueError("mode must be 'collision', 'hamming', 'asymmetric' or 'topp'")
        if mode == "hamming" and self._hasher.hash_family == "crosspolytope":
            raise ValueError(
                f"mode='{mode}' requires sign-bit signatures; the "
                "cross-polytope family serves mode='collision' or 'topp'"
            )
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        if wire_dtype not in ("float32", "bfloat16"):
            raise ValueError("wire_dtype must be 'float32' or 'bfloat16'")
        where = as_filter(where)
        if mode == "topp":
            return self._serving_topp(top_k, wire_dtype=wire_dtype, batch_hint=batch_hint,
                                      where=where)
        # Collision-mode serving honours the instance's multi-probe depth;
        # the probe wire grows a T axis (T times the bytes per query).
        probes = self._multiprobe if mode == "collision" else 1
        serve = self._storage.snapshot_query_fn(
            top_k,
            wire="words" if self._hash_on_device else "dense",
            mode=mode,
            probes=probes,
            where=where,
        )

        def run(vectors) -> np.ndarray:
            arr = self._validate_batch(vectors)
            out = serve(self._hash_wire(arr, probes)).cpu().numpy()
            # Count after the dispatch: stale-snapshot calls raise and must
            # not inflate queries_served.
            self._count("queries_served", arr.shape[0])
            return out

        return run

    def _serving_topp(self, top_k: int, *, wire_dtype: str, batch_hint: int, where):
        """``serving_fn(mode="topp")``: one upload of the batch. With the
        device hash, the float32 vectors go to the device once and both the
        hash and the rerank read that tensor (a bf16 wire is rounded there,
        half to even as on the host); with the host hash, the dense wire
        and the vectors (bf16 when asked: half the bytes) are uploaded."""
        probes = self._multiprobe
        serve = self._storage.snapshot_topp_fn(
            top_k,
            wire="words" if self._hash_on_device else "dense",
            probes=probes,
            batch_hint=batch_hint,
            where=where,
        )
        dev = self._storage.device

        def run_topp(vectors):
            arr = self._validate_batch(vectors)
            if self._hash_on_device:
                qv = torch.from_numpy(arr).to(dev)
                sig = self._hash_wire(qv, probes)
            else:
                sig = self._hash_wire(arr, probes)
                qv = torch.from_numpy(arr)
            if wire_dtype == "bfloat16":
                qv = qv.to(torch.bfloat16)
            ids, sims, n = serve(sig, qv)
            # Count after the dispatch: stale-snapshot calls raise and must
            # not inflate queries_served.
            self._count("queries_served", arr.shape[0])
            return ids.cpu().numpy(), sims.cpu().numpy(), n.cpu().numpy()

        return run_topp

    # ------------------------------------------------------------------
    # maintenance / introspection
    # ------------------------------------------------------------------

    def delete(self, indices: Union[int, Sequence[int]]) -> None:
        """Delete ids from the index (their slots are tombstoned until
        :meth:`compact`)."""
        to_remove = [indices] if isinstance(indices, int) else [int(i) for i in indices]
        self._count("deletes", len(to_remove))
        self._storage.remove_indices(to_remove)

    def compact(self) -> int:
        """Reclaim tombstoned slots; returns how many were reclaimed."""
        return self._storage.compact()

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
            "device": str(self._storage.device),
            "engine": self._engine,
            "engine_resolved": self._tpu_config.get("engine_resolved"),
            "similarity": self._config["similarity"],
            "hash_family": self._hasher.hash_family,
            "multiprobe": self._multiprobe,
            "ranking": "hamming" if self._use_hamming_ranking() else "collision",
            "buffered_operations": buffered,
            "counters": counters,
            "index": self._storage.stats(),
        }

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save_to_disk(self, path: Union[str, Path]) -> None:
        """Persist config, projections and the index to a directory.

        Writes the reference package's format: ``metadata.json`` (version
        ``"0.1.0"``, ``config`` / ``redis_config`` / ``tpu_config``),
        ``projections.npz`` (one ``(rows_per_band, dim)`` matrix per band;
        the structured and cross-polytope families write their +-1
        ``diagonals.npz`` instead) and, when the index holds live entries, ``index.npz``
        (`DeviceStore.state_arrays`). Either package loads it.
        """
        self.flush()
        output_dir = Path(path)
        output_dir.mkdir(parents=True, exist_ok=True)
        metadata = {
            "version": _METADATA_VERSION,
            "config": self._config,
            "redis_config": _REDIS_CONFIG_DEFAULTS,
            "tpu_config": self._tpu_config,
        }
        with open(output_dir / "metadata.json", "w") as f:
            json.dump(metadata, f, indent=2)
        if self._hasher.hash_family in ("structured", "crosspolytope"):
            np.savez_compressed(output_dir / "diagonals.npz", diagonals=self._hasher.diagonals)
        else:
            np.savez_compressed(output_dir / "projections.npz", *self._hasher.projections)
        if len(self._storage):
            np.savez_compressed(output_dir / "index.npz", **self._storage.state_arrays())

    @classmethod
    def load_from_disk(
        cls,
        path: Union[str, Path],
        *,
        vector_fetch_fn: Optional[VectorFetchFn] = None,
        device: str | torch.device = "cuda",
    ) -> "LSHRS":
        """Restore an index saved by :meth:`save_to_disk` of either package
        onto ``device``. A checkpoint asking for a capability the port
        lacks raises ``NotImplementedError``."""
        input_dir = Path(path)
        if not input_dir.exists():
            raise FileNotFoundError(f"Directory not found: {input_dir}")
        with open(input_dir / "metadata.json") as f:
            metadata = json.load(f)
        config = metadata["config"]
        tpu_config = metadata.get("tpu_config", {})
        instance = cls(
            **cls._restore_tpu_kwargs(config, tpu_config),
            vector_fetch_fn=vector_fetch_fn,
            device=device,
        )
        if instance._hasher.hash_family in ("structured", "crosspolytope"):
            with np.load(input_dir / "diagonals.npz") as data:
                instance._hasher.diagonals = data["diagonals"]
        else:
            with np.load(input_dir / "projections.npz") as data:
                instance._hasher.projections = [
                    data[f"arr_{i}"].astype(np.float32) for i in range(len(data.files))
                ]
        index_path = input_dir / "index.npz"
        if index_path.exists():
            with np.load(index_path) as data:
                instance._storage.load_state_arrays({k: data[k] for k in data.files})
        instance._restore_engine_resolved(tpu_config)
        return instance

    @staticmethod
    def _restore_tpu_kwargs(config: dict[str, Any], tpu_config: dict[str, Any]) -> dict[str, Any]:
        """Constructor kwargs reproducing a saved instance (the reference's
        defaults for absent keys). Capabilities the port lacks raise here
        or in the constructor, never silently dropped."""
        if tpu_config.get("query_mode", "scan") != "scan":
            raise _not_ported(f"query_mode={tpu_config['query_mode']!r} (the bucketed engine)")
        if tpu_config.get("hamming_cascade", 0):
            raise _not_ported("hamming_cascade (the refinement cascade)")
        return {
            "dim": config["dim"],
            "num_perm": config["num_perm"],
            "num_bands": config["num_bands"],
            "rows_per_band": config["rows_per_band"],
            "similarity_threshold": config["similarity_threshold"],
            "buffer_size": config["buffer_size"],
            "seed": config["seed"],
            "similarity": config.get("similarity", "cosine"),
            "backend": tpu_config.get("backend", "device"),
            "store_vectors": tpu_config.get("store_vectors", False),
            "initial_capacity": tpu_config.get("initial_capacity", 1 << 14),
            "chunk_size": tpu_config.get("chunk_size", 2048),
            "shards": tpu_config.get("shards"),
            "enable_hamming": tpu_config.get("enable_hamming", False),
            "group_size": tpu_config.get("group_size", 32),
            "dedupe": tpu_config.get("dedupe", True),
            "hash_mode": tpu_config.get("hash_mode", "device"),
            "hash_family": tpu_config.get("hash_family", "gaussian"),
            "hamming_storage": tpu_config.get("hamming_storage", "planes"),
            "payload_dtype": tpu_config.get("payload_dtype", "float32"),
            "rerank_engine": tpu_config.get("rerank_engine", "auto"),
            "rerank_candidates": tpu_config.get("rerank_candidates", 1024),
            # Saved instances predating the engine knob behaved as
            # "collision"; restore them unchanged.
            "engine": tpu_config.get("engine", "collision"),
            "multiprobe": tpu_config.get("multiprobe", 1),
        }

    def _restore_engine_resolved(self, tpu_config: dict[str, Any]) -> None:
        # A pinned auto-engine resolution survives the checkpoint: result
        # ordering never changes across a restore boundary.
        if tpu_config.get("engine_resolved"):
            self._tpu_config["engine_resolved"] = tpu_config["engine_resolved"]

    def __getstate__(self) -> dict[str, Any]:
        self.flush()
        state: dict[str, Any] = {
            "config": self._config.copy(),
            "redis_config": dict(_REDIS_CONFIG_DEFAULTS),
            "tpu_config": self._tpu_config.copy(),
            "device": str(self._storage.device),
        }
        if self._hasher.hash_family in ("structured", "crosspolytope"):
            state["diagonals"] = np.asarray(self._hasher.diagonals)
        else:
            state["projections"] = [
                np.asarray(m, dtype=np.float32) for m in self._hasher.projections
            ]
        if len(self._storage):
            state["index_state"] = self._storage.state_arrays()
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        tpu_config = state.get("tpu_config", {})
        restored = self.__class__(
            **self._restore_tpu_kwargs(state["config"], tpu_config),
            device=state.get("device", "cuda"),
        )
        self.__dict__ = restored.__dict__
        self._restore_engine_resolved(tpu_config)
        if "diagonals" in state:
            self._hasher.diagonals = state["diagonals"]
        else:
            self._hasher.projections = state["projections"]
        if "index_state" in state:
            self._storage.load_state_arrays(state["index_state"])

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------

    def _hash_words(self, arr: np.ndarray):
        """Query hashing through this instance's single hash path: device
        int32 words, or host uint32 words in host mode."""
        if self._hash_on_device:
            return self._hasher.hash_batch_words(arr)
        return self._hasher.hash_batch_words_host(arr)

    def _hash_query_words(self, arr: np.ndarray):
        """Collision-path QUERY hashing, with multi-probe expansion.

        With ``multiprobe=T > 1`` the result is ``(Q, T, BW)`` — probe 0
        is the plain signature (bit-identical to the ingest hash), probes
        ``t >= 1`` flip each band's ``t``-th lowest-margin bit (or step to
        the cross-polytope's ``t``-th ranked axis). The store counts bands
        matching ANY probe, expanding candidate sets at zero memory cost
        (only collision counting and top-p candidate enumeration consume
        probes; Hamming ranking scores all slots already).
        """
        if self._multiprobe > 1:
            if self._hash_on_device:
                return self._hasher.hash_batch_probe_words(arr, self._multiprobe)
            return self._hasher.hash_batch_probe_words_host(arr, self._multiprobe)
        return self._hash_words(arr)

    def _hash_wire(self, arr, n_probes: int):
        """Serving wire for a query batch: probe words (device hash) or
        the dense probe wire (host hash) when probing, the instance's
        ingest wire otherwise. ``arr`` is a NumPy batch, or with the
        device hash a tensor already on the device."""
        if n_probes > 1:
            if self._hash_on_device:
                return self._hasher.hash_batch_probe_words(arr, n_probes)
            return self._hasher.hash_batch_probe_dense_host(arr, n_probes)
        return self._hash_for_ingest(arr)

    def _hash_for_ingest(self, arr: np.ndarray):
        """Wire hashing: device words, or the dense host wire in host mode
        (half the bytes of the word layout at r <= 16)."""
        if self._hash_on_device:
            return self._hasher.hash_batch_words(arr)
        return self._hasher.hash_batch_dense_host(arr)

    def _require_vector_fetch_fn(self) -> VectorFetchFn:
        if self._vector_fetch_fn is None:
            raise RuntimeError(
                "vector_fetch_fn must be supplied for operations requiring reranking"
            )
        return self._vector_fetch_fn

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
