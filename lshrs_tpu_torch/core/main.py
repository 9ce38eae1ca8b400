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
                    (collision), B2 (Hamming on bitplanes, or on a prefix
                    of them: the refinement cascade) or B3 (Hamming on
                    packed words) group max -> top-k groups -> refine ->
                    ids; where= ranks only the admitted ids
    asymmetric   -> host projection coordinates, quantised to int8 (or
                    the int4 wire) -> kernel B2 with a shifted key -> exact
                    (dot, id) re-rank from the packed words
    top-p        -> hash -> collision counts (full engine) or kernel B1's
                    candidate gather -> cosine rerank over the resident
                    payload -> (id, cosine); or, without a payload, the
                    enumerated candidates through vector_fetch_fn and a
                    host rerank
    delete       -> tombstones (id -1); compact rebuilds the dense prefix
    rehash       -> a new banding, seed or hash family: every signature
                    rebuilt from the resident payload on the device
                    (retrain: an ITQ fit on sampled payload rows, then the
                    learned family); serving_fn(auto_refresh=True) serves
                    through it and through every other mutation
    save/load    -> metadata.json + projections.npz (diagonals.npz for the
                    structured and cross-polytope families) + index.npz,
                    the reference package's format (checkpoints load
                    across the two packages)
    bulk build   -> create_signatures: a loader (NumPy, Parquet, Postgres)
                    streams (ids, vectors) batches through a prefetch
                    thread; with two or more CPUs a worker validates (and
                    in host mode hashes) batch i+1 on the host while batch
                    i commits to the device store

Bucket backends (``backend="memory"`` or ``"redis"``, or a ``storage=``
without signature batches) keep the reference's host algorithm: the NumPy
hash, per-band bucket writes, and per-band bucket reads counted in a dict.
They allocate nothing on any device, and the device-only entry points
(Hamming and asymmetric ranking, serving closures, rehash, retrain,
compact) raise ``RuntimeError`` there.

``query_mode="bucket"`` answers collision top-k through sorted band keys
and a binary search (`lshrs_tpu_torch.ops.bucketed`). ``similarity="dot"``
is maximum-inner-product search: every stored vector gains the coordinate
``sqrt(max_norm^2 - |x|^2)`` and every query a 0, so the cosine machinery
ranks by inner product, and returned scores are scaled back to inner
products.

Same public contract as the reference for these paths: validation
messages, ``(-collision_count, id)`` ordering, ``(cosine desc, id asc)``
rerank ordering, the ``engine="auto"`` switch to Hamming ranking at
``_AUTO_HAMMING_CAPACITY`` slots (pinned and persisted), and
buffer-restore-on-failed-flush semantics. Past one kernel launch's int32
key ceiling (more than 2**22 slots at 256 bits) Hamming ranking runs
kernel B2 on the bitplanes, or B3 on the packed words, block by block and
merges the blocks exactly; the other stores the grouped engines cannot
take (asymmetric ranking past the ceiling, more than 64 bands, below the
group size) rank through the chunked fallbacks, as the reference's do.
"""

from __future__ import annotations

import json
import logging
import math
import os
from collections.abc import Callable, Iterable, Sequence
from pathlib import Path
from threading import Lock
from typing import Any, Optional, Union

import numpy as np
import torch

from lshrs_tpu_torch.hash.hasher import LSHHasher
from lshrs_tpu_torch.hash.itq import fit_itq_projection
from lshrs_tpu_torch.ops.asymmetric import QMAX4, pack_coords_int4_np, quantize_coords_np
from lshrs_tpu_torch.storage.base import BaseStorage
from lshrs_tpu_torch.storage.device import DeviceStore
from lshrs_tpu_torch.storage.filter import as_filter
from lshrs_tpu_torch.storage.memory import MemoryStorage
from lshrs_tpu_torch.utils.br import get_optimal_config
from lshrs_tpu_torch.utils.cp import get_optimal_cp_config
from lshrs_tpu_torch.utils.similarity import top_k_cosine
from lshrs_tpu_torch.utils.trace import span

logger = logging.getLogger(__name__)

VectorFetchFn = Callable[[Sequence[int]], np.ndarray]
Loader = Callable[..., Iterable[tuple[Sequence[int], np.ndarray]]]

__all__ = ["LSHRS", "VectorFetchFn", "lshrs"]

CandidateScores = list[tuple[int, float]]

# The reference package's checkpoint format version (metadata.json).
_METADATA_VERSION = "0.1.0"


class LSHRS:
    """Locality-sensitive-hashing index over dense float32 vectors.

    Signatures are banded hash signatures (random hyperplanes, FWHT
    rotations or cross-polytope symbols, by ``hash_family``), kept by
    default in a device-resident signature store
    (`lshrs_tpu_torch.storage.DeviceStore`) and queried with the
    hand-written group-max kernels; or in host buckets (``backend=
    "memory"`` or ``"redis"``) queried by the reference's host algorithm.

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
        storage: a preconfigured `BaseStorage`; overrides ``backend``. A
            store with signature batches (a `DeviceStore`) runs the device
            path, and the hasher and ``store_vectors`` follow it; any other
            is a bucket store (``stats()["backend"] == "custom"``).
        backend: ``"device"`` (default), ``"memory"`` (an in-process bucket
            dict) or ``"redis"`` (Redis sets, `RedisStorage`).
        redis_host / redis_port / redis_db / redis_password / redis_prefix /
            redis_max_connections / decode_responses: the Redis connection
            (used by ``backend="redis"``, recorded for every backend; the
            password is redacted in ``save_to_disk``).
        store_vectors: keep the vectors resident on the device (the
            payload), so top-p reranks there without a fetch round trip
            (device backend only).
        payload_dtype / rerank_engine / rerank_candidates: the payload's
            precision (``"float32"``, ``"bfloat16"`` or ``"int8"``), the
            top-p formulation (``"full"``, ``"gather"`` or ``"auto"``) and
            the gather engine's per-query candidate budget; see
            `DeviceStore`.
        device_budget_bytes: the most bytes the device store may hold on
            its card (``stats()["index"]["device_bytes"]``); a growth or a
            lazy table past it raises ``MemoryError``. ``None`` (default)
            is no limit; device backend only, unsharded, and not saved
            with a checkpoint (see `DeviceStore`).
        seed: projection seed (the reference package's seeded draw).
        initial_capacity / chunk_size / group_size / dedupe: device store
            sizing and engine knobs, see `DeviceStore`.
        enable_hamming: make full-signature Hamming ranking available.
        hamming_storage: ``"planes"`` (int8 bitplanes, kernel B2,
            ``num_perm`` bytes per slot) or ``"packed"`` (the stored words,
            expanded to +-1 on the card by kernel B3, zero extra bytes); ``None``
            (default) means ``"planes"``. An explicit ``"packed"`` is kept
            when the auto/hamming engine turns Hamming ranking on.
        hamming_cascade / hamming_cascade_refine: the two-pass refinement
            cascade (``DeviceStore``): Hamming ranking scans only the first
            ``hamming_cascade`` bits' planes with kernel B2 and re-ranks
            the top ``hamming_cascade_refine`` slots per query at full
            width. Approximate, at any capacity (past 2^22 slots at 256
            bits the exact engine ranks in blocks of 2^22). 0 (default) is
            off; needs Hamming ranking.
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
        query_mode / bucket_cap: ``"scan"`` (default) or ``"bucket"``
            (collision top-k through the sorted bucket index, truncating
            bucket runs at ``bucket_cap`` slots); see `DeviceStore`.
        similarity: ``"cosine"`` (default) or ``"dot"`` (maximum inner
            product search): stored vectors gain the coordinate
            ``sqrt(max_norm^2 - |x|^2)`` and queries a 0, the hasher and
            the store work at ``dim + 1``, candidates follow inner-product
            order and returned scores are inner products. Recall degrades
            when stored norms differ by orders of magnitude.
        max_norm: required with ``similarity="dot"``: the bound on stored
            vector norms; indexing a vector above it raises ``ValueError``.
        device: where the store and the device hash live (``"cuda"`` by
            default; ``"cpu"`` runs the kernels' plain PyTorch versions).
            A ``storage=`` store's own device wins; bucket backends ignore
            it.

    ``shards=N`` (N > 1) shards the slots over N devices of ``device``'s
    kind (`lshrs_tpu_torch.parallel.ShardedDeviceStore`): every CUDA card,
    or the CPU standing in for up to 8; for several shards on one card,
    pass ``storage=ShardedDeviceStore(mesh=make_mesh(devices=["cuda:0"] *
    4), ...)``.
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
        storage: Optional[Any] = None,
        backend: str = "device",
        store_vectors: bool = False,
        redis_host: str = "localhost",
        redis_port: int = 6379,
        redis_db: int = 0,
        redis_password: Optional[str] = None,
        redis_prefix: str = "lsh",
        redis_max_connections: int = 50,
        decode_responses: bool = False,
        seed: int = 42,
        initial_capacity: int = 1 << 14,
        chunk_size: int = 2048,
        shards: Optional[int] = None,
        enable_hamming: bool = False,
        group_size: int = 64,
        dedupe: bool = True,
        query_mode: str = "scan",
        bucket_cap: int = 128,
        hash_mode: str = "device",
        hash_family: str = "gaussian",
        hamming_storage: Optional[str] = None,
        hamming_cascade: int = 0,
        hamming_cascade_refine: int = 2048,
        payload_dtype: str = "float32",
        rerank_engine: str = "auto",
        rerank_candidates: int = 1024,
        device_budget_bytes: Optional[int] = None,
        engine: str = "auto",
        multiprobe: int = 1,
        similarity: str = "cosine",
        max_norm: Optional[float] = None,
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
        if similarity not in ("cosine", "dot"):
            raise ValueError("similarity must be 'cosine' or 'dot'")
        if similarity == "dot":
            if max_norm is None or not max_norm > 0:
                raise ValueError(
                    'similarity="dot" requires max_norm > 0: the MIPS '
                    "augmentation needs an upper bound on stored vector "
                    "norms (vectors above it are rejected at ingest)"
                )
            max_norm = float(max_norm)
        if query_mode not in ("scan", "bucket"):
            raise ValueError("query_mode must be 'scan' or 'bucket'")
        # None means "planes"; an explicit "packed" (zero extra memory)
        # stays when the auto/hamming engine turns Hamming ranking on.
        if hamming_storage is None:
            hamming_storage = "planes"
        if hamming_storage not in ("planes", "packed"):
            raise ValueError("hamming_storage must be 'planes' or 'packed'")
        if device_budget_bytes is not None and (backend != "device" or storage is not None):
            raise ValueError(
                "device_budget_bytes applies to the device backend's own store "
                "(give a store its budget with DeviceStore(device_budget_bytes=...))"
            )
        if hamming_cascade:
            if backend != "device" or storage is not None:
                raise ValueError("hamming_cascade applies to the device backend only")
            if engine == "collision" and not enable_hamming:
                raise ValueError(
                    "hamming_cascade requires Hamming ranking: construct "
                    "with enable_hamming=True or engine='auto'/'hamming'"
                )
        if engine != "collision" and backend == "device":
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
        self._similarity = similarity
        self._max_norm = max_norm
        # MIPS hashes and stores dim + 1 coordinates (see _augment_data).
        self._hash_dim = dim + 1 if similarity == "dot" else dim
        self._buffer_size = buffer_size
        self._vector_fetch_fn = vector_fetch_fn
        self._hash_on_device = hash_mode == "device"

        if storage is not None:
            self._storage: Any = storage
            backend = "device" if storage.supports_signature_batches else "custom"
            # A device store decides where the device hash runs.
            device = getattr(storage, "device", device)
        elif backend == "device":
            store_kw = dict(
                num_bands=num_bands,
                rows_per_band=rows_per_band,
                dim=self._hash_dim,
                initial_capacity=initial_capacity,
                chunk_size=chunk_size,
                enable_hamming=enable_hamming,
                hamming_storage=hamming_storage,
                hamming_cascade=hamming_cascade,
                hamming_cascade_refine=hamming_cascade_refine,
                group_size=group_size,
                dedupe=dedupe,
                query_mode=query_mode,
                bucket_cap=bucket_cap,
                store_vectors=store_vectors,
                payload_dtype=payload_dtype,
                rerank_engine=rerank_engine,
                rerank_candidates=rerank_candidates,
                device_budget_bytes=device_budget_bytes,
            )
            if shards is not None and shards > 1:
                from lshrs_tpu_torch.parallel import ShardedDeviceStore, available_devices, make_mesh

                mesh = make_mesh(shards, devices=available_devices(device))
                self._storage = ShardedDeviceStore(mesh=mesh, **store_kw)
                device = self._storage.device
            else:
                self._storage = DeviceStore(device=device, **store_kw)
        elif backend == "memory":
            self._storage = MemoryStorage()
        elif backend == "redis":
            from lshrs_tpu_torch.storage.redis import RedisStorage

            self._storage = RedisStorage(
                host=redis_host,
                port=redis_port,
                db=redis_db,
                password=redis_password,
                decode_responses=decode_responses,
                prefix=redis_prefix,
                max_connections=redis_max_connections,
            )
        else:
            raise ValueError(f"Unsupported storage backend '{backend}'")

        # Device mode: signature batches into a device store. Bucket mode:
        # the host hash and BucketOperation tuples, nothing on a device.
        self._device_mode = bool(self._storage.supports_signature_batches)
        if isinstance(self._storage, DeviceStore):
            store_vectors = self._storage.store_vectors
        self._store_vectors = store_vectors and self._device_mode
        self._hasher = LSHHasher(
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            dim=self._hash_dim,
            seed=seed,
            hash_family=hash_family,
            device=device if self._device_mode else "cpu",
        )

        # Write buffer: (ids, words, vectors or None) batch records in
        # device mode; BucketOperation tuples in bucket mode, so the flush
        # threshold counts operations as the reference does.
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
            "max_norm": max_norm,
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
            "query_mode": query_mode,
            "bucket_cap": bucket_cap,
            "hash_mode": hash_mode,
            "hash_family": hash_family,
            "hamming_storage": hamming_storage,
            "hamming_cascade": hamming_cascade,
            "hamming_cascade_refine": hamming_cascade_refine,
            "payload_dtype": payload_dtype,
            "rerank_engine": rerank_engine,
            "rerank_candidates": rerank_candidates,
            "engine": engine,
            "multiprobe": multiprobe,
        }
        self._redis_config: dict[str, Any] = {
            "host": redis_host,
            "port": redis_port,
            "db": redis_db,
            "password": redis_password,
            "prefix": redis_prefix,
            "decode_responses": decode_responses,
            "max_connections": redis_max_connections,
        }

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def close(self) -> None:
        """Flush pending operations and release the storage backend (a
        device store drops its tensors, a Redis store its pool)."""
        self.flush()
        self._storage.close()

    def __enter__(self) -> "LSHRS":
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        self.close()

    def __repr__(self) -> str:
        engine = self._engine
        resolved = self._tpu_config.get("engine_resolved")
        if resolved:
            engine = f"{engine}->{resolved}"
        return (
            "LSHRS("
            f"dim={self._dim}, "
            f"num_perm={self._config['num_perm']}, "
            f"num_bands={self._config['num_bands']}, "
            f"rows_per_band={self._config['rows_per_band']}, "
            f"engine='{engine}', "
            f"backend='{self._tpu_config['backend']}'"
            ")"
        )

    # ------------------------------------------------------------------
    # ingestion
    # ------------------------------------------------------------------

    def create_signatures(
        self,
        *,
        format: str = "postgres",
        prefetch: int = 2,
        **loader_kwargs: Any,
    ) -> None:
        """Bulk-build the index by streaming ``(indices, vectors)`` batches.

        ``format`` selects a loader: ``postgres`` / ``pg``, ``parquet`` /
        ``pq`` or ``numpy`` / ``npy`` / ``npz`` / ``arrays`` (see
        `lshrs_tpu_torch.io`); the loader keyword arguments are passed
        through. Each batch is indexed and flushed as `index` does.
        ``prefetch`` batches are pulled ahead on a background thread (0
        turns that off).

        On the device backend, with two or more CPUs available to this
        process, a worker thread validates batch i+1 (and hashes it, with
        ``hash_mode="host"``) while this thread commits batch i to the
        device; the worker never touches the device. A loader that fails
        mid-stream leaves every batch before the failing one committed, as
        the serial loop does. Bucket backends run the serial loop.
        """
        loader = self._resolve_loader(format)
        stream: Iterable = loader(**loader_kwargs)
        if prefetch > 0:
            from lshrs_tpu_torch.io.prefetch import prefetch_batches

            stream = prefetch_batches(stream, depth=prefetch)
        # The affinity mask, not os.cpu_count(): a one-CPU container on a
        # many-core host must not start a worker that convoys with the
        # commits.
        try:
            avail_cpus = len(os.sched_getaffinity(0))
        except (AttributeError, OSError):  # not Linux
            avail_cpus = os.cpu_count() or 1
        if not self._device_mode or avail_cpus < 2:
            for indices, vectors in stream:
                self.index(indices, vectors)
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=1) as ex:
            pending = None
            it = iter(stream)
            while True:
                try:
                    indices, vectors = next(it)
                except StopIteration:
                    break
                except BaseException:
                    # The serial loop commits batch i before it pulls batch
                    # i+1: the batch already prepared commits here too.
                    if pending is not None:
                        self._commit_index_batch(pending.result())
                        pending = None
                    raise
                fut = ex.submit(self._prepare_index_batch, indices, vectors)
                if pending is not None:
                    self._commit_index_batch(pending.result())
                pending = fut
            if pending is not None:
                self._commit_index_batch(pending.result())

    def ingest(self, index: int, vector: np.ndarray) -> None:
        """Hash one vector and buffer it; searchable after the next flush
        (explicit, at buffer capacity, or via ``index()``)."""
        if index < 0:
            raise ValueError("index must be non-negative")
        vec = self._augment_data(self._prepare_vector(vector)[None, :])
        if self._device_mode:
            record = (
                np.asarray([index], dtype=np.int64),
                self._hash_for_ingest(vec),
                vec if self._store_vectors else None,
            )
            with self._buffer_lock:
                self._buffer.append(record)
        else:
            signatures = self._hasher.hash_vector(vec[0])
            with self._buffer_lock:
                for band_id, sig in enumerate(signatures):
                    self._buffer.append((band_id, sig, int(index)))
        self._count("vectors_ingested")
        self._flush_buffer_if_needed()

    def index(self, indices: Sequence[int], vectors: Optional[np.ndarray] = None) -> None:
        """Index a batch of vectors and flush, making them searchable.

        ``vectors=None`` fetches the batch through ``vector_fetch_fn``.
        Runs inside the span ``lshrs.index``.
        """
        if indices is None or len(indices) == 0:
            return
        with span("lshrs.index"):
            if self._device_mode:
                self._commit_index_batch(self._prepare_index_batch(indices, vectors))
                return
            idx_arr, arr = self._validate_index_batch(indices, vectors)
            words = self._hasher.hash_batch_words_host(arr)
            with self._buffer_lock:
                for j, idx in enumerate(idx_arr.tolist()):
                    for band_id, band in enumerate(self._hasher.words_to_signature(words[j])):
                        self._buffer.append((band_id, band, idx))
            self._count("vectors_ingested", idx_arr.size)
            self.flush()

    def _validate_index_batch(self, indices, vectors):
        """Shared `index()` validation -> ``(idx_arr, float32 arr)`` (span
        ``lshrs.index.validate``)."""
        with span("lshrs.index.validate"):
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
                    "Cannot index zero vector - norm undefined. "
                    "Check embeddings for corruption."
                )
            return idx_arr, self._augment_data(arr)

    def _prepare_index_batch(self, indices, vectors):
        """Device-mode `index()` stage 1: validate, and hash on the host in
        host mode; the device hash is deferred to the store's fused build.
        Host work only: safe on the pipeline's worker thread (a worker
        that touched CUDA would run on its own current device)."""
        idx_arr, arr = self._validate_index_batch(indices, vectors)
        if self._hash_on_device:
            return (idx_arr, None, arr)
        return (
            idx_arr,
            self._hasher.hash_batch_dense_host(arr),
            arr if self._store_vectors else None,
        )

    def _commit_index_batch(self, record) -> None:
        """Device-mode `index()` stage 2: store the batch (flushing
        buffered singles first, in order) and count it."""
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
        """Write buffered batches to the store in one append (bucket
        backends: one ``batch_add`` of the buffered operations).

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
            if not self._device_mode:
                self._storage.batch_add(pending)
            elif len(pending) == 1:
                self._storage.add_signature_batch(*pending[0])
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
        if not self._device_mode:
            return len(self._buffer)
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
        pickle round trip too. Bucket backends never do.
        """
        if not self._device_mode or not getattr(self._storage, "enable_hamming", False):
            return False
        if self._engine == "hamming":
            return True
        if self._engine != "auto":
            return False
        if self._tpu_config.get("engine_resolved") == "hamming":
            return True
        switched = getattr(self._storage, "_capacity", 0) >= self._AUTO_HAMMING_CAPACITY
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

        Bucket backends read every band's bucket (and with ``multiprobe``
        its probe buckets) and count collisions on the host; ``where``
        filters the counted candidates.
        """
        if top_k is not None and top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        if top_p is not None and not 0 < top_p <= 1:
            raise ValueError("top_p must be within the range (0, 1]")
        where = as_filter(where)
        query_vector = self._augment_query(self._prepare_vector(vector)[None, :])[0]
        self._count("queries_served")
        if self._device_mode and top_p is None and top_k is not None:
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
            return [idx for idx, _ in ordered[:top_k]]
        candidate_indices = [idx for idx, _ in ordered]
        arr = self._fetch_candidates(candidate_indices)
        similarities = top_k_cosine(query_vector, arr, k=len(candidate_indices))
        scale = float(self._score_scale(query_vector[None, :])[0])
        ordered_scores = [
            (candidate_indices[pos], score * scale) for pos, score in similarities
        ]
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
        sims = sims * self._score_scale(query_vector[None, :])[0]
        return [(int(i), float(s)) for i, s in zip(ids[:limit], sims[:limit])]

    # First guess of the bounded candidate enumeration; it grows to the
    # next power of two of the device-counted candidate total.
    _CANDIDATE_ENUM_START = 4096

    def _ordered_candidates(
        self, query_vector: np.ndarray, where=None
    ) -> list[tuple[int, int]]:
        """Every colliding candidate as ``(id, count)``, by ``(-count, id)``.

        Device mode is bounded: the device counts the query's candidates
        (``query_nnz``, O(1) readback), then an exact collision top-M with
        M the next power of two of that count (at least
        `_CANDIDATE_ENUM_START`) returns them all; the ``(Q, C)`` count
        matrix never reaches the host. With ``multiprobe`` the candidates
        are the union over the probes (a band counts once, whichever probe
        it matches). Bucket mode counts `_candidate_counts` and filters the
        candidates with one vectorised ``where.admits``.
        """
        if not self._device_mode:
            counts_map = self._candidate_counts(query_vector)
            if where is not None and counts_map:
                cand = np.fromiter(counts_map, dtype=np.int64, count=len(counts_map))
                counts_map = {
                    int(i): counts_map[int(i)] for i in cand[where.admits(cand)]
                }
            return sorted(counts_map.items(), key=lambda item: (-item[1], item[0]))
        qwords = self._hash_query_words(query_vector[None, :])
        n = int(self._storage.query_nnz(qwords, where=where)[0])
        if n == 0:
            return []
        m = max(self._CANDIDATE_ENUM_START, 1 << (n - 1).bit_length())
        counts, ids = self._storage.query_topk(qwords, m, where=where)
        return [(int(i), int(c)) for i, c in zip(ids[0, :n], counts[0, :n])]

    def _candidate_counts(self, query_vector: np.ndarray) -> dict[int, int]:
        """Bucket mode: per-band bucket reads counted in a dict.

        With ``multiprobe=T > 1`` every band also reads its T-1 probe
        buckets (host probe words); a candidate's band signature lies in
        exactly one bucket, so the union over the probes keeps each count
        at most ``num_bands``.
        """
        counts: dict[int, int] = {}
        if self._multiprobe > 1:
            probe_words = self._hasher.hash_batch_probe_words_host(
                query_vector[None, :], self._multiprobe
            )[0]
            sigs = [self._hasher.words_to_signature(w) for w in probe_words]
            for band_id in range(self._config["num_bands"]):
                candidates: set[int] = set()
                for sig in sigs:
                    candidates |= self._storage.get_bucket(band_id, sig[band_id])
                for candidate in candidates:
                    counts[candidate] = counts.get(candidate, 0) + 1
            return counts
        for band_id, hash_val in enumerate(self._hasher.hash_vector(query_vector)):
            for candidate in self._storage.get_bucket(band_id, hash_val):
                counts[candidate] = counts.get(candidate, 0) + 1
        return counts

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
        return self._augment_data(arr)

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
        arr = self._augment_query(arr)
        # The cutoff is min(ceil(p * n), top_k): top_k bounds the prefix.
        max_out = min(max_candidates, top_k) if top_k is not None else max_candidates
        ids, sims, n = self._storage.query_topp_batch(
            self._hash_query_words(arr), arr, max_out, wire_dtype=wire_dtype, where=where
        )
        if self._similarity == "dot":
            sims = sims * self._score_scale(arr)[:, None]
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
        """Batched top-k query: one hash matmul and one fused scan. Bucket
        backends answer with a :meth:`query` per vector, as the reference
        does."""
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        where = as_filter(where)
        if not self._device_mode:
            return [self.query(v, top_k=top_k, where=where) for v in self._validate_batch(vectors)]
        arr = self._augment_query(self._validate_batch(vectors))
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
        self._require_device_backend("query_hamming")
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        query_vector = self._augment_query(self._prepare_vector(vector)[None, :])
        self._count("queries_served")
        hamming, ids = self._storage.query_hamming(
            self._hash_words(query_vector), top_k, where=as_filter(where)
        )
        return self._hamming_scores(hamming, ids, self._score_scale(query_vector))[0]

    def query_hamming_batch(
        self, vectors: np.ndarray, *, top_k: int = 10, where=None
    ) -> list[CandidateScores]:
        """Batched :meth:`query_hamming` (one hash, one fused scan)."""
        self._require_device_backend("query_hamming")
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        arr = self._augment_query(self._validate_batch(vectors))
        self._count("queries_served", arr.shape[0])
        hamming, ids = self._storage.query_hamming(
            self._hash_words(arr), top_k, where=as_filter(where)
        )
        return self._hamming_scores(hamming, ids, self._score_scale(arr))

    def _hamming_scores(
        self, hamming: np.ndarray, ids: np.ndarray, scales: np.ndarray
    ) -> list[CandidateScores]:
        """``(id, cos(pi * hamming / num_perm) * scale)`` per row (the
        scale maps the estimate to an inner product under MIPS)."""
        num_perm = self._config["num_perm"]
        return [
            [
                (int(i), float(math.cos(math.pi * int(h) / num_perm)) * scale)
                for i, h in zip(row_ids, row_h)
                if i >= 0
            ]
            for row_ids, row_h, scale in zip(ids, hamming, scales)
        ]

    def query_asymmetric(
        self, vector: np.ndarray, *, top_k: int = 10, where=None
    ) -> CandidateScores:
        """Rank by the asymmetric SimHash estimator.

        Like :meth:`query_hamming`, but the query keeps its projection
        coordinates (quantised to int8) where Hamming ranking keeps their
        signs: a better rank correlation with cosine at the same store
        memory. Requires ``enable_hamming=True`` (or an auto/hamming
        engine) with ``hamming_storage="planes"`` and no cascade. Returns
        ``(id, estimated_cosine)`` tuples, the estimate being
        ``dots / sum|q|``.
        """
        return self.query_asymmetric_batch(
            self._prepare_vector(vector)[None, :], top_k=top_k, where=where
        )[0]

    def query_asymmetric_batch(
        self, vectors: np.ndarray, *, top_k: int = 10, where=None
    ) -> list[CandidateScores]:
        """Batched :meth:`query_asymmetric` (one scan through kernel B2)."""
        self._require_device_backend("query_asymmetric")
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        arr = self._augment_query(self._validate_batch(vectors))
        self._count("queries_served", arr.shape[0])
        qi8, sumabs = quantize_coords_np(self._hasher.hash_batch_coords_host(arr))
        dots, ids = self._storage.query_asymmetric(qi8, top_k, where=as_filter(where))
        denom = np.maximum(sumabs, 1).astype(np.float64) / self._score_scale(arr)
        return [
            [(int(i), float(d / denom[r])) for i, d in zip(ids[r], dots[r]) if i >= 0]
            for r in range(arr.shape[0])
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
        coords_wire: str = "int8",
        auto_refresh: bool = False,
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
                to be available), ``"asymmetric"`` (quantised query
                coordinates against the bitplanes, kernel B2; requires
                Hamming ranking on planes, no cascade), ``"topp"`` (cosine
                rerank against the resident payload; requires
                ``store_vectors=True``) or ``None`` (default): the
                instance's resolved ranking engine.
            wire_dtype: ``"topp"`` only — ``"bfloat16"`` rounds the query
                vectors to bf16 for the rerank (half the upload bytes in
                host hash mode; ~1e-2 relative cosine rounding);
                ``"float32"`` is value-exact.
            coords_wire: ``"asymmetric"`` only — ``"int8"`` (``num_perm``
                bytes per query) or ``"int4"`` (coordinates quantised to
                ``[-7, 7]``, two per byte: half the upload).
            auto_refresh: serve through mutations: on a stale snapshot the
                closure takes a new one of the current contents and retries
                (thread-safe). ``False`` (default) keeps the strict
                contract: after a mutation the closure raises.
            batch_hint: ``"topp"`` only — the batch size the closure will
                serve; the auto rerank engine sizes the full engine's
                ``(Q, capacity)`` temporaries from it.
            where: optional id filter baked into the snapshot: every batch
                ranks ONLY the admitted subset.

        With ``multiprobe=T`` the ``"collision"`` and ``"topp"`` closures
        hash T probe signatures per query (probe words on the device, or
        the dense probe wire from the host); ``"hamming"`` uses probe 0.

        Returns:
            ``"collision"`` / ``"hamming"`` / ``"asymmetric"``: callable
            ``(vectors (Q, dim)) -> (Q, top_k) int32 ndarray`` of ids, -1
            padded. ``"topp"``:
            callable returning ``(ids (Q, top_k) int32, cosines (Q, top_k)
            float32, n_candidates (Q,) int32)`` ndarrays.
        """
        self._require_device_backend("serving_fn")
        where = as_filter(where)
        if auto_refresh:
            return self._serving_refreshing(
                top_k, mode=mode, wire_dtype=wire_dtype, coords_wire=coords_wire,
                batch_hint=batch_hint, where=where,
            )
        if mode is None:
            mode = "hamming" if self._use_hamming_ranking() else "collision"
        if mode not in ("collision", "hamming", "asymmetric", "topp"):
            raise ValueError("mode must be 'collision', 'hamming', 'asymmetric' or 'topp'")
        if mode in ("hamming", "asymmetric") and self._hasher.hash_family == "crosspolytope":
            raise ValueError(
                f"mode='{mode}' requires sign-bit signatures; the "
                "cross-polytope family serves mode='collision' or 'topp'"
            )
        if top_k is None or top_k <= 0:
            raise ValueError("top_k must be greater than zero when provided")
        if wire_dtype not in ("float32", "bfloat16"):
            raise ValueError("wire_dtype must be 'float32' or 'bfloat16'")
        if mode == "topp":
            return self._serving_topp(top_k, wire_dtype=wire_dtype, batch_hint=batch_hint,
                                      where=where)
        if mode == "asymmetric":
            return self._serving_asymmetric(top_k, coords_wire=coords_wire, where=where)
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
            with span("lshrs.serve"):
                with span("lshrs.validate"):
                    arr = self._augment_query(self._validate_batch(vectors))
                with span("lshrs.hash"):
                    sig = self._hash_wire(arr, probes)
                with span("lshrs.engine"):
                    ids = serve(sig)
                with span("lshrs.download"):
                    out = ids.cpu().numpy()
                # Count after the dispatch: stale-snapshot calls raise and must
                # not inflate queries_served.
                self._count("queries_served", arr.shape[0])
                return out

        return run

    def _serving_refreshing(self, top_k: int, **kw):
        """``serving_fn(auto_refresh=True)``: a closure over an inner
        serving closure, made lazily and made again when it raises stale
        (another thread may have refreshed it first)."""
        refresh_lock = Lock()
        inner: list = [None]

        def current():
            with refresh_lock:
                if inner[0] is None:
                    inner[0] = self.serving_fn(top_k, **kw)
                return inner[0]

        def refreshing(vectors):
            fn = current()
            try:
                return fn(vectors)
            except RuntimeError as e:
                if "stale" not in str(e):
                    raise
                with refresh_lock:
                    if inner[0] is fn:
                        inner[0] = None
                return current()(vectors)

        return refreshing

    def _serving_asymmetric(self, top_k: int, *, coords_wire: str, where):
        """``serving_fn(mode="asymmetric")``: the wire is the quantised
        projection coordinates, computed on the host for both hash modes
        (as :meth:`query_asymmetric_batch`): ``num_perm`` int8 bytes per
        query, or half that on the int4 wire."""
        if coords_wire not in ("int8", "int4"):
            raise ValueError("coords_wire must be 'int8' or 'int4'")
        int4 = coords_wire == "int4"
        serve = self._storage.snapshot_query_fn(
            top_k, mode="asymmetric", wire="coords4" if int4 else "words", where=where
        )

        def run_asym(vectors) -> np.ndarray:
            with span("lshrs.serve"):
                with span("lshrs.validate"):
                    arr = self._augment_query(self._validate_batch(vectors))
                with span("lshrs.hash"):
                    coords = self._hasher.hash_batch_coords_host(arr)
                    if int4:
                        sig = pack_coords_int4_np(quantize_coords_np(coords, qmax=QMAX4)[0])
                    else:
                        sig = quantize_coords_np(coords)[0]
                with span("lshrs.engine"):
                    ids = serve(sig)
                with span("lshrs.download"):
                    out = ids.cpu().numpy()
                # Count after the dispatch: stale-snapshot calls raise and must
                # not inflate queries_served.
                self._count("queries_served", arr.shape[0])
                return out

        return run_asym

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
            with span("lshrs.serve"):
                with span("lshrs.validate"):
                    arr = self._augment_query(self._validate_batch(vectors))
                with span("lshrs.hash"):
                    if self._hash_on_device:
                        qv = torch.from_numpy(arr).to(dev)
                        sig = self._hash_wire(qv, probes)
                    else:
                        sig = self._hash_wire(arr, probes)
                        qv = torch.from_numpy(arr)
                    if wire_dtype == "bfloat16":
                        qv = qv.to(torch.bfloat16)
                with span("lshrs.engine"):
                    ids, sims, n = serve(sig, qv)
                # Count after the dispatch: stale-snapshot calls raise and must
                # not inflate queries_served.
                self._count("queries_served", arr.shape[0])
                with span("lshrs.download"):
                    sims = sims.cpu().numpy()
                    if self._similarity == "dot":
                        sims = sims * self._score_scale(arr)[:, None]
                    return ids.cpu().numpy(), sims, n.cpu().numpy()

        return run_topp

    # ------------------------------------------------------------------
    # maintenance / introspection
    # ------------------------------------------------------------------

    def delete(self, indices: Union[int, Sequence[int]]) -> None:
        """Delete ids from the index (on the device backend their slots are
        tombstoned until :meth:`compact`; bucket stores drop them from every
        bucket)."""
        to_remove = [indices] if isinstance(indices, int) else [int(i) for i in indices]
        self._count("deletes", len(to_remove))
        self._storage.remove_indices(to_remove)

    def compact(self) -> int:
        """Reclaim tombstoned slots; returns how many were reclaimed."""
        self._require_device_backend("compact")
        return self._storage.compact()

    def clear(self) -> None:
        """Flush, then drop every indexed entry (projections are kept)."""
        self.flush()
        self._storage.clear()

    def rehash(
        self,
        *,
        num_perm: Optional[int] = None,
        num_bands: Optional[int] = None,
        rows_per_band: Optional[int] = None,
        similarity_threshold: Optional[float] = None,
        seed: Optional[int] = None,
        hash_family: Optional[str] = None,
    ) -> None:
        """Retune the index in place: rebuild every stored signature from
        the resident payload under a new banding, threshold, seed or hash
        family, with no re-ingestion (`DeviceStore.rehash`).

        Args:
            num_perm / similarity_threshold: auto-tune the new banding with
                `get_optimal_config` (defaults: the current values); or pass
                ``num_bands`` and ``rows_per_band`` together.
            seed / hash_family: draw new projections. A learned matrix is
                data, not a seed: it can be re-banded within its
                ``num_perm`` but not drawn (see :meth:`retrain`).

        Requires the device backend with ``store_vectors=True``. Deleted
        entries stay deleted. Signatures derive from the payload at its
        stored precision: equal to a fresh build for a float32 payload.
        Serving closures taken before raise as stale (``auto_refresh``
        ones take a new snapshot).
        """
        if not isinstance(self._storage, DeviceStore):
            raise RuntimeError(
                "rehash requires the device backend: bucket stores hold "
                "no payload to rebuild signatures from"
            )
        if not self._store_vectors:
            raise RuntimeError(
                "rehash requires store_vectors=True: signatures are "
                "rebuilt from the resident payload"
            )
        if (num_bands is None) != (rows_per_band is None):
            raise ValueError("provide both num_bands and rows_per_band, or neither")
        self.flush()
        cfg = self._config
        threshold = (
            cfg["similarity_threshold"] if similarity_threshold is None else similarity_threshold
        )
        if num_bands is None:
            new_perm = cfg["num_perm"] if num_perm is None else num_perm
            num_bands, rows_per_band = get_optimal_config(new_perm, threshold)
        new_perm = num_bands * rows_per_band
        if num_perm is not None and num_perm != new_perm:
            raise ValueError(
                "num_bands * rows_per_band must equal num_perm "
                f"(received {num_bands} * {rows_per_band} != {num_perm})"
            )
        seed = cfg["seed"] if seed is None else seed
        if hash_family is None:
            hash_family = self._tpu_config["hash_family"]
        if hash_family not in ("gaussian", "structured", "learned", "crosspolytope"):
            raise ValueError(
                "hash_family must be 'gaussian', 'structured', 'learned' "
                "or 'crosspolytope'"
            )
        if (hash_family == "crosspolytope") != (
            self._tpu_config["hash_family"] == "crosspolytope"
        ) and (self._storage.enable_hamming or self._engine == "hamming"):
            raise ValueError(
                "cannot rehash across the cross-polytope boundary while "
                "Hamming ranking is enabled: construct the index with "
                "engine='collision' and enable_hamming=False first"
            )
        max_probes = (
            1 << (rows_per_band - 1) if hash_family == "crosspolytope" else rows_per_band
        )
        if self._multiprobe > max_probes:
            bound = "cp_dims" if hash_family == "crosspolytope" else "rows_per_band"
            raise ValueError(
                f"multiprobe must be <= {bound} "
                f"(= {max_probes}); received {self._multiprobe}"
            )
        projection = None
        if hash_family == "learned":
            if (
                self._hasher.hash_family != "learned"
                or self._hasher.projection_matrix.shape[0] != new_perm
            ):
                raise ValueError(
                    "rehash cannot draw a learned projection; use "
                    "retrain(sample) to fit one (or rehash within the "
                    "current num_perm to re-band the existing learned bits)"
                )
            projection = self._hasher.projection_matrix
        hasher = LSHHasher(
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            dim=self._hash_dim,
            seed=seed,
            hash_family=hash_family,
            projection=projection,
            device=self._hasher.device,
        )
        self._rebuild_store_signatures(hasher, num_bands, rows_per_band)
        cfg.update(
            num_perm=new_perm,
            num_bands=num_bands,
            rows_per_band=rows_per_band,
            similarity_threshold=threshold,
            seed=seed,
        )
        self._tpu_config["hash_family"] = hash_family

    def _rebuild_store_signatures(
        self, hasher: LSHHasher, num_bands: int, rows_per_band: int
    ) -> None:
        """Rebuild every stored signature under ``hasher`` and adopt it.

        The device hash (and the structured and cross-polytope families,
        bit-identical on host and device) rebuild on the device from the
        payload. ``hash_mode="host"`` with a matmul family goes through
        the host instead, so that stored and query signatures keep one
        hash path: the payload round-trips through `state_arrays`."""
        store = self._storage
        if self._hash_on_device or hasher.hash_family in ("structured", "crosspolytope"):
            store.rehash(
                hasher.device_projection(),
                num_bands=num_bands,
                rows_per_band=rows_per_band,
                hash_family=hasher.hash_family,
            )
        else:
            snap = store.state_arrays()
            ids = np.asarray(snap["ids"], dtype=np.int64)
            alive = ids >= 0
            vec = np.asarray(snap["payload"], dtype=np.float32)[alive]
            store._reset_banding(num_bands, rows_per_band)
            if len(vec):
                store.add_signature_batch(ids[alive], hasher.hash_batch_words_host(vec), vec)
        self._hasher = hasher

    def retrain(
        self,
        sample: Optional[np.ndarray] = None,
        *,
        iters: int = 64,
        sample_cap: int = 131072,
        seed: Optional[int] = None,
    ) -> dict[str, Any]:
        """Fit data-dependent hyperplanes (ITQ, `lshrs_tpu_torch.hash.itq`)
        and rebuild the index's signatures under them, in place.

        Args:
            sample: ``(n, dim)`` vectors to fit on (augmented like ingest
                under ``similarity="dot"``). Default: up to ``sample_cap``
                resident payload rows (`DeviceStore.sample_payload_rows`).
            iters: ITQ alternations.
            sample_cap: fit on at most this many rows (evenly strided).
            seed: rotation and padding seed (default: the current seed).

        Returns the fit's diagnostics (`fit_itq_projection`). Keeps the
        banding (:meth:`rehash` re-bands the learned matrix afterwards).
        Requires the device backend with ``store_vectors=True``; serving
        closures taken before raise as stale.
        """
        if not isinstance(self._storage, DeviceStore):
            raise RuntimeError(
                "retrain requires the device backend: bucket stores hold "
                "no payload to rebuild signatures from"
            )
        if not self._store_vectors:
            raise RuntimeError(
                "retrain requires store_vectors=True: signatures are "
                "rebuilt from the resident payload"
            )
        self.flush()
        cfg = self._config
        if sample is None:
            rows = self._storage.sample_payload_rows(sample_cap)
            if rows.shape[0] < 2:
                raise RuntimeError(
                    "retrain needs at least 2 indexed vectors to fit on "
                    "(or pass an explicit sample)"
                )
        else:
            arr = np.asarray(sample, dtype=np.float32)
            if arr.ndim != 2 or arr.shape[1] != self._dim:
                raise ValueError(
                    f"sample must have shape (n, {self._dim}); received {tuple(arr.shape)}"
                )
            rows = self._augment_data(arr)
        if rows.shape[0] > sample_cap:
            rows = rows[(np.arange(sample_cap) * (rows.shape[0] / sample_cap)).astype(np.int64)]
        seed = cfg["seed"] if seed is None else seed
        proj, info = fit_itq_projection(
            rows, cfg["num_perm"], iters=iters, seed=seed, return_info=True
        )
        hasher = LSHHasher(
            num_bands=cfg["num_bands"],
            rows_per_band=cfg["rows_per_band"],
            dim=self._hash_dim,
            seed=seed,
            hash_family="learned",
            projection=proj,
            device=self._hasher.device,
        )
        self._rebuild_store_signatures(hasher, cfg["num_bands"], cfg["rows_per_band"])
        cfg["seed"] = seed
        self._tpu_config["hash_family"] = "learned"
        return info

    def stats(self) -> dict[str, Any]:
        """Configuration snapshot plus counters, and the device store's
        statistics (``"index"``; bucket backends have none). ``backend``
        is ``"device"``, ``"memory"``, ``"redis"`` or ``"custom"``;
        ``device`` is the device store's torch device, None for a bucket
        store."""
        with self._buffer_lock:
            buffered = self._buffered_ops()
        with self._counter_lock:
            counters = dict(self._counters)
        out: dict[str, Any] = {
            "dimension": self._dim,
            "num_perm": self._config["num_perm"],
            "num_bands": self._config["num_bands"],
            "rows_per_band": self._config["rows_per_band"],
            "buffer_size": self._buffer_size,
            "similarity_threshold": self._config["similarity_threshold"],
            "redis_prefix": self._redis_config["prefix"],
            "backend": self._tpu_config["backend"],
            "device": str(self._storage.device) if self._device_mode else None,
            "engine": self._engine,
            "engine_resolved": self._tpu_config.get("engine_resolved"),
            "similarity": self._config["similarity"],
            "hash_family": self._hasher.hash_family,
            "multiprobe": self._multiprobe,
            "ranking": "hamming" if self._use_hamming_ranking() else "collision",
            "buffered_operations": buffered,
            "counters": counters,
        }
        if isinstance(self._storage, DeviceStore):
            out["index"] = self._storage.stats()
        return out

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save_to_disk(self, path: Union[str, Path]) -> None:
        """Persist config, projections and the index to a directory.

        Writes the reference package's format: ``metadata.json`` (version
        ``"0.1.0"``, ``config`` / ``redis_config`` with the password
        redacted / ``tpu_config``), ``projections.npz`` (one
        ``(rows_per_band, dim)`` matrix per band; the structured and
        cross-polytope families write their +-1 ``diagonals.npz``
        instead) and, when a device store holds live entries,
        ``index.npz`` (`DeviceStore.state_arrays`). A bucket store's
        contents live outside the process and are not written. Either
        package loads it.
        """
        self.flush()
        output_dir = Path(path)
        output_dir.mkdir(parents=True, exist_ok=True)
        metadata = {
            "version": _METADATA_VERSION,
            "config": self._config,
            "redis_config": {**self._redis_config, "password": "<REDACTED>"},
            "tpu_config": self._tpu_config,
        }
        with open(output_dir / "metadata.json", "w") as f:
            json.dump(metadata, f, indent=2)
        if self._hasher.hash_family in ("structured", "crosspolytope"):
            np.savez_compressed(output_dir / "diagonals.npz", diagonals=self._hasher.diagonals)
        else:
            np.savez_compressed(output_dir / "projections.npz", *self._hasher.projections)
        if isinstance(self._storage, DeviceStore) and len(self._storage):
            np.savez_compressed(output_dir / "index.npz", **self._storage.state_arrays())

    @classmethod
    def load_from_disk(
        cls,
        path: Union[str, Path],
        *,
        redis_config: Optional[dict[str, Any]] = None,
        vector_fetch_fn: Optional[VectorFetchFn] = None,
        storage: Optional[BaseStorage] = None,
        device: str | torch.device = "cuda",
    ) -> "LSHRS":
        """Restore an index saved by :meth:`save_to_disk` of either package
        onto ``device``.

        ``redis_config`` overrides stored connection settings (the stored
        password is redacted: supply it again where it is needed).
        ``storage`` is used as the store (a checkpoint of a ``"custom"``
        store restores onto a memory store without it). A checkpoint
        asking for a capability the port lacks raises
        ``NotImplementedError``."""
        input_dir = Path(path)
        if not input_dir.exists():
            raise FileNotFoundError(f"Directory not found: {input_dir}")
        with open(input_dir / "metadata.json") as f:
            metadata = json.load(f)
        config = metadata["config"]
        stored_redis = dict(metadata["redis_config"])
        if redis_config:
            stored_redis.update(redis_config)
        tpu_config = cls._restorable(metadata.get("tpu_config", {}), storage)
        instance = cls(
            **cls._restore_tpu_kwargs(config, tpu_config, device),
            **cls._restore_redis_kwargs(stored_redis),
            vector_fetch_fn=vector_fetch_fn,
            storage=storage,
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
        if index_path.exists() and isinstance(instance._storage, DeviceStore):
            with np.load(index_path) as data:
                instance._storage.load_state_arrays({k: data[k] for k in data.files})
        instance._restore_engine_resolved(tpu_config)
        return instance

    @staticmethod
    def _restorable(tpu_config: dict[str, Any], storage) -> dict[str, Any]:
        """A ``"custom"`` store cannot be rebuilt from a checkpoint: without
        a ``storage=`` it restores onto a memory store (bucket contents
        live outside the process anyway)."""
        if tpu_config.get("backend") == "custom" and storage is None:
            return {**tpu_config, "backend": "memory"}
        return tpu_config

    @staticmethod
    def _restore_redis_kwargs(redis_config: dict[str, Any]) -> dict[str, Any]:
        return {
            "redis_host": redis_config["host"],
            "redis_port": redis_config["port"],
            "redis_db": redis_config["db"],
            "redis_password": redis_config["password"],
            "redis_prefix": redis_config["prefix"],
            "decode_responses": redis_config["decode_responses"],
            "redis_max_connections": redis_config.get("max_connections", 50),
        }

    @staticmethod
    def _restore_tpu_kwargs(
        config: dict[str, Any], tpu_config: dict[str, Any], device: str | torch.device
    ) -> dict[str, Any]:
        """Constructor kwargs reproducing a saved instance on ``device`` (the
        reference's defaults for absent keys). Capabilities the port lacks
        raise here or in the constructor, never silently dropped.
        ``shards`` degrades (with a warning) to an unsharded store when
        ``device``'s kind offers fewer devices than the index was sharded
        over (`lshrs_tpu_torch.parallel.available_devices`)."""
        shards = tpu_config.get("shards")
        if shards is not None and shards > 1:
            from lshrs_tpu_torch.parallel import available_devices

            available = len(available_devices(device))
            if shards > available:
                logger.warning(
                    "Index was saved with shards=%d but only %d device(s) "
                    "are available; restoring unsharded (results are "
                    "identical, capacity is single-device).",
                    shards,
                    available,
                )
                shards = None
        return {
            "dim": config["dim"],
            "num_perm": config["num_perm"],
            "num_bands": config["num_bands"],
            "rows_per_band": config["rows_per_band"],
            "similarity_threshold": config["similarity_threshold"],
            "buffer_size": config["buffer_size"],
            "seed": config["seed"],
            "similarity": config.get("similarity", "cosine"),
            "max_norm": config.get("max_norm"),
            "backend": tpu_config.get("backend", "device"),
            "store_vectors": tpu_config.get("store_vectors", False),
            "initial_capacity": tpu_config.get("initial_capacity", 1 << 14),
            "chunk_size": tpu_config.get("chunk_size", 2048),
            "shards": shards,
            "enable_hamming": tpu_config.get("enable_hamming", False),
            "group_size": tpu_config.get("group_size", 32),
            "dedupe": tpu_config.get("dedupe", True),
            "query_mode": tpu_config.get("query_mode", "scan"),
            "bucket_cap": tpu_config.get("bucket_cap", 128),
            "hash_mode": tpu_config.get("hash_mode", "device"),
            "hash_family": tpu_config.get("hash_family", "gaussian"),
            "hamming_storage": tpu_config.get("hamming_storage", "planes"),
            "hamming_cascade": tpu_config.get("hamming_cascade", 0),
            "hamming_cascade_refine": tpu_config.get("hamming_cascade_refine", 2048),
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
        # The password is kept, as the reference keeps it; save_to_disk
        # redacts it.
        self.flush()
        state: dict[str, Any] = {
            "config": self._config.copy(),
            "redis_config": self._redis_config.copy(),
            "tpu_config": self._tpu_config.copy(),
            "device": str(self._hasher.device),
        }
        if self._hasher.hash_family in ("structured", "crosspolytope"):
            state["diagonals"] = np.asarray(self._hasher.diagonals)
        else:
            state["projections"] = [
                np.asarray(m, dtype=np.float32) for m in self._hasher.projections
            ]
        if isinstance(self._storage, DeviceStore) and len(self._storage):
            state["index_state"] = self._storage.state_arrays()
        return state

    def __setstate__(self, state: dict[str, Any]) -> None:
        tpu_config = self._restorable(state.get("tpu_config", {}), None)
        restored = self.__class__(
            **self._restore_tpu_kwargs(state["config"], tpu_config, state.get("device", "cuda")),
            **self._restore_redis_kwargs(state["redis_config"]),
            device=state.get("device", "cuda"),
        )
        self.__dict__ = restored.__dict__
        self._restore_engine_resolved(tpu_config)
        if "diagonals" in state:
            self._hasher.diagonals = state["diagonals"]
        else:
            self._hasher.projections = state["projections"]
        if "index_state" in state and isinstance(self._storage, DeviceStore):
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

    # MIPS (similarity="dot"): stored vectors gain the coordinate
    # sqrt(max_norm^2 - |x|^2) (every augmented norm is max_norm), queries a
    # literal 0, so the cosine of the augmented pair is (q . x) / (|q| *
    # max_norm): inner-product order under every cosine stage (hashing,
    # collision counts, Hamming, asymmetric, rerank). `_score_scale` maps
    # the scores back to inner products.

    def _augment_data(self, arr: np.ndarray) -> np.ndarray:
        if self._similarity != "dot":
            return arr
        m2 = self._max_norm * self._max_norm
        n2 = np.einsum("ij,ij->i", arr.astype(np.float64), arr.astype(np.float64))
        if np.any(n2 > m2 * (1.0 + 1e-5)):
            raise ValueError(
                f"vector norm exceeds max_norm={self._max_norm}: the MIPS "
                "augmentation requires every stored vector inside the "
                "declared norm bound (re-create the index with a larger "
                "max_norm)"
            )
        aug = np.sqrt(np.maximum(m2 - n2, 0.0)).astype(np.float32)
        return np.concatenate([arr, aug[:, None]], axis=1)

    def _augment_query(self, arr: np.ndarray) -> np.ndarray:
        if self._similarity != "dot":
            return arr
        return np.concatenate([arr, np.zeros((arr.shape[0], 1), np.float32)], axis=1)

    def _score_scale(self, q_aug: np.ndarray) -> np.ndarray:
        """Per-query factor from augmented cosines to the public score: 1
        for cosine, ``|q| * max_norm`` for dot (the augmented query's norm
        is the original's: its extra coordinate is 0)."""
        if self._similarity != "dot":
            return np.ones(q_aug.shape[0], np.float64)
        return np.linalg.norm(q_aug, axis=1).astype(np.float64) * self._max_norm

    def _require_vector_fetch_fn(self) -> VectorFetchFn:
        if self._vector_fetch_fn is None:
            raise RuntimeError(
                "vector_fetch_fn must be supplied for operations requiring reranking"
            )
        return self._vector_fetch_fn

    def _require_device_backend(self, what: str) -> None:
        if not self._device_mode:
            raise RuntimeError(f"{what} requires the device backend")

    def _resolve_loader(self, format: str) -> Loader:
        normalized = format.lower()
        if normalized in {"postgres", "pg"}:
            from lshrs_tpu_torch.io.postgres import iter_postgres_vectors

            return iter_postgres_vectors
        if normalized in {"parquet", "pq"}:
            from lshrs_tpu_torch.io.parquet import iter_parquet_vectors

            return iter_parquet_vectors
        if normalized in {"numpy", "npy", "npz", "arrays"}:
            from lshrs_tpu_torch.io.numpy_io import iter_numpy_vectors

            return iter_numpy_vectors
        raise ValueError(f"Unsupported signature creation format '{format}'")

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


# The reference package's lower-case alias.
lshrs = LSHRS
