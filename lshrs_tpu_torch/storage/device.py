"""Device-resident signature store — the index engine, on PyTorch tensors.

Every indexed vector's packed banded signature lives in device memory and
queries run as fused scans (`lshrs_tpu_torch.ops.scan`,
`lshrs_tpu_torch.ops.hamming`):

    layout (device tensors, power-of-two capacity):
        sig_t    (num_bands * W, capacity)  int32  transposed signatures
                                                   (slot axis minor)
        sig_rows (capacity, num_bands * W)  int32  row-major twin
        ids      (capacity,)                int32  vector id, -1 = dead
        tie      (capacity,)                int32  global id-rank key
        ranks    (capacity,)                int32  id rank within each chunk
                                                   (chunked cores, lazy)
        block_tie (capacity,)               int32  tie key within each B2 block
                                                   (bitplanes past one block,
                                                   lazy)
        planes   (capacity, Pp)             int8   +-1 bitplanes (Hamming with
                                                   hamming_storage="planes",
                                                   built lazily); Pp is num_perm
                                                   rounded up to 32, zero-padded,
                                                   or the cascade's prefix width
        payload  (capacity, dim)   f32/bf16/int8   raw vectors (store_vectors)
        pnorm    (capacity,)                f32    norms of the stored rows
        pscale   (capacity,)                f32    int8 per-row scales

Words are int32 bit-views of the uint32 signature words (see
`lshrs_tpu_torch.ops.bitpack`).

Query engines: grouped collision counting (kernel B1), the bucketed
engine (``query_mode="bucket"``: sorted band keys and a binary search,
`lshrs_tpu_torch.ops.bucketed`, plain torch) and grouped
Hamming ranking, on int8 bitplanes (kernel B2) or on the packed words
themselves (kernel B3), all exact against the reference ordering;
asymmetric ranking of quantised query coordinates against the bitplanes
(B2 with a shifted key, exact re-rank); the refinement cascade (B2 on a
bitplane prefix, a deep full-width refine with int64 keys), approximate;
and,
with ``store_vectors``, top-p cosine rerank over the resident payload by
the full or the gather engine (`lshrs_tpu_torch.ops.rerank`, the gather
engine on kernel B1). Collision counting and top-p take multi-probe query
words ``(Q, T, BW)`` (kernel B1 counts a band that matches any probe), and
every query takes a ``where=`` id filter (`lshrs_tpu_torch.storage.filter`:
the kernels read the filtered tie column, refinement gathers per slot).
Hamming ranking on the bitplanes runs in blocks of at most one B2
launch's int32 key (2**22 slots at 256 bits), one block or many
(`lshrs_tpu_torch.ops.hamming.hamming_topk_blocked_core`): kernel B2
and the selection tail once per block of live slots; past one block
they key by block-local ties (``block_tie``, computed on first use) and
one exact merge joins the blocks. The other stores the grouped engines cannot take — packed words,
asymmetric ranking or a collision key past int32, more than 64 bands, a
capacity below the group — rank through the chunked fallbacks, as the
reference's do (`lshrs_tpu_torch.ops.scan.collision_topk_core` and the
Hamming and asymmetric chunked cores: keys embed each slot's id rank
within its chunk, ``ranks``, computed on first use). They launch no
kernel.

Mutation model: appends write the tail in place; re-ingesting an id
overwrites its slot (upsert); deleting an id tombstones its slot (id -1)
until `DeviceStore.compact` rebuilds the dense prefix; `DeviceStore.rehash`
rebuilds every signature from the resident payload under a new banding or
hash. Every mutation drops the derived state (refine table, bitplanes,
bucket index) and bumps the generation. Capacity grows
exactly as the reference's does — each batch reserves ``next_pow2(n)``
slots and capacity at least doubles when they do not fit — because
capacity sets the key scale and the engine switch of
`LSHRS(engine="auto")`.
"""

from __future__ import annotations

import threading
from collections.abc import Iterable, Sequence

import numpy as np
import torch

from lshrs_tpu_torch.hash.hasher import hash_words
from lshrs_tpu_torch.ops.bitpack import (
    as_words,
    band_bytes_to_words,
    bytes_per_band,
    dense_to_words,
    narrow_refine_r,
    pack_words_narrow,
    words_per_band,
    words_to_numpy,
)
from lshrs_tpu_torch.ops.asymmetric import (
    QMAX,
    QMAX4,
    asymmetric_shift,
    asymmetric_topk_chunked_core,
    asymmetric_topk_core,
    unpack_coords_int4,
)
from lshrs_tpu_torch.ops.bucketed import bucketed_topk, build_bucket_index
from lshrs_tpu_torch.ops.hamming import (
    cascade_slice_queries,
    hamming_block_slots,
    hamming_topk_blocked_core,
    hamming_topk_cascade_core,
    hamming_topk_chunked_core,
    hamming_topk_packed_chunked_core,
    hamming_topk_packed_core,
    plane_width,
    supports_hamming_grouped,
    unpack_bitplanes,
)
from lshrs_tpu_torch.ops.rerank import (
    rerank_topp_batch_core,
    rerank_topp_core,
    rerank_topp_gather_core,
)
from lshrs_tpu_torch.ops.scan import (
    build_grouped_refine_rows,
    collision_counts_core,
    collision_nnz_core,
    collision_topk_core,
    collision_topk_grouped_core,
    compute_chunk_ranks,
    count_step,
    global_tie_core,
    key_scale,
    supports_fast_path,
)
from lshrs_tpu_torch.storage.base import BaseStorage, BucketOperation
from lshrs_tpu_torch.storage.filter import as_filter
from lshrs_tpu_torch.utils.trace import span

__all__ = ["DeviceStore"]

_MAX_ID = 2**31 - 1
_PAYLOAD_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _cast_payload_rows(
    x: torch.Tensor, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Float32 rows -> ``(rows, pnorm, pscale)`` at the payload dtype.

    ``int8``: symmetric per-row quantization ``rows = round(x / s)`` with
    ``s = max|x| / 127`` (zero rows get s = 1); ``torch.round`` rounds half
    to even like ``jnp.round``, so the rows equal the reference's.
    ``pnorm`` is the norm of the rows as stored (the integer rows for
    int8, so the scale cancels out of the cosine); ``pscale`` is None for
    float dtypes. Re-quantizing a dequantized row gives the same int8 row
    (the reference's argument, `lshrs_tpu/storage/device.py`), so queries
    survive a checkpoint or a compact unchanged.
    """
    scale = None
    if dtype == torch.int8:
        scale = x.abs().amax(dim=1) / 127.0
        scale = torch.where(scale > 0, scale, 1.0)
        rows = torch.clamp(torch.round(x / scale[:, None]), -127, 127).to(torch.int8)
    else:
        rows = x.to(dtype)
    return rows, torch.linalg.vector_norm(rows.to(torch.float32), dim=1), scale


def _band_bucket(band_words_t: torch.Tensor, ids: torch.Tensor, q_band: torch.Tensor) -> torch.Tensor:
    """Slots whose band words ``(W, C)`` equal ``q_band`` ``(W,)`` and are
    alive, ``(C,)`` bool."""
    return (band_words_t == q_band[:, None]).all(dim=0) & (ids >= 0)


class DeviceStore(BaseStorage):
    """Device-resident LSH signature store with fused query kernels.

    Args:
        num_bands / rows_per_band: banding scheme (must match the hasher).
        dim: vector dimensionality.
        initial_capacity: starting slot count (rounded up to a power of
            two, at least ``chunk_size``).
        chunk_size: capacity floor, kept so capacities match the reference
            package's store for the same arguments.
        group_size: group width of the group-max selection (a power of two).
        dedupe: track id -> slot on the host so re-ingesting an id
            overwrites its slot (upsert).
        enable_hamming: make `query_hamming` (full-signature Hamming
            ranking) available.
        hamming_storage: ``"planes"`` (default) ranks on +-1 int8
            bitplanes (kernel B2), ``num_perm`` bytes per slot, built
            lazily on the first Hamming use; ``"packed"`` ranks on the
            packed words the store already holds (kernel B3 expands each
            slot tile to +-1 in shared memory), zero extra bytes. Results
            are identical.
        hamming_cascade: prefix width (bits) of the two-pass refinement
            cascade; 0 (default) is off. The store then holds only the
            first ``hamming_cascade`` bitplane columns, ranks them with
            kernel B2 and re-ranks the top ``hamming_cascade_refine``
            slots per query by the exact full-width popcount. Approximate
            (the prefix can exclude a true top-k slot), and the Hamming
            engine that serves past the int32 key ceiling. Needs
            ``enable_hamming`` with planes, a multiple of 32 below
            ``num_perm``; asymmetric queries are refused (they rank
            against full-width planes).
        hamming_cascade_refine: the cascade's refine pool per query, in
            slots (rounded up to whole groups, at least ``k`` groups).
        store_vectors: keep the raw vectors resident (the payload), so
            top-p cosine rerank runs on the device; requires ``dim``.
        payload_dtype: payload precision — ``"float32"`` (value-exact
            cosines), ``"bfloat16"`` (half the bytes, ~1e-3 relative
            cosine rounding) or ``"int8"`` (a quarter, per-row-scale
            quantized, ~4e-3).
        rerank_engine: top-p formulation — ``"full"`` (one ``(Q, C)``
            cosine matmul over the store), ``"gather"`` (rerank only the
            ``rerank_candidates`` most-colliding slots, selected by kernel
            B1; exact whenever the colliding set fits, flagged per query)
            or ``"auto"`` (the reference's cost model, see
            :meth:`_resolve_rerank_engine`).
        rerank_candidates: per-query candidate budget of the gather engine.
        query_mode: ``"scan"`` (default: the grouped scans above) or
            ``"bucket"`` (collision top-k through sorted band keys and a
            binary search, `lshrs_tpu_torch.ops.bucketed`; multi-probe,
            filtered and past-`supports_fast_path` queries take the scan).
        bucket_cap: the bucketed engine's window per (query, band); longer
            bucket runs are truncated and counted
            (``stats()["bucket_overflows"]``).
        device: where the store's tensors live (``"cuda"`` by default; the
            CPU runs the kernels' plain PyTorch versions).
    """

    supports_signature_batches = True

    def __init__(
        self,
        *,
        num_bands: int,
        rows_per_band: int,
        dim: int | None = None,
        store_vectors: bool = False,
        initial_capacity: int = 1 << 14,
        chunk_size: int = 2048,
        group_size: int = 64,
        dedupe: bool = True,
        query_mode: str = "scan",
        bucket_cap: int = 128,
        enable_hamming: bool = False,
        hamming_storage: str = "planes",
        hamming_cascade: int = 0,
        hamming_cascade_refine: int = 2048,
        payload_dtype: str = "float32",
        rerank_engine: str = "auto",
        rerank_candidates: int = 1024,
        device: str | torch.device = "cuda",
    ) -> None:
        if chunk_size <= 0 or chunk_size > 1 << 14:
            raise ValueError("chunk_size must be in (0, 16384]")
        if payload_dtype not in _PAYLOAD_DTYPES:
            raise ValueError("payload_dtype must be 'float32', 'bfloat16' or 'int8'")
        if rerank_engine not in ("auto", "full", "gather"):
            raise ValueError("rerank_engine must be 'auto', 'full' or 'gather'")
        if rerank_candidates <= 0:
            raise ValueError("rerank_candidates must be greater than zero")
        if store_vectors and not dim:
            raise ValueError("dim is required when store_vectors=True")
        if group_size <= 0 or group_size & (group_size - 1):
            raise ValueError("group_size must be a power of two")
        if query_mode not in ("scan", "bucket"):
            raise ValueError("query_mode must be 'scan' or 'bucket'")
        if bucket_cap <= 0:
            raise ValueError("bucket_cap must be greater than zero")
        if hamming_storage not in ("planes", "packed"):
            raise ValueError("hamming_storage must be 'planes' or 'packed'")
        if hamming_cascade:
            num_perm = num_bands * rows_per_band
            if not enable_hamming or hamming_storage != "planes":
                raise ValueError(
                    "hamming_cascade requires enable_hamming=True with "
                    'hamming_storage="planes" (the coarse pass scans a '
                    "bitplane prefix)"
                )
            if hamming_cascade % 32 or not 0 < hamming_cascade < num_perm:
                raise ValueError(
                    "hamming_cascade must be a positive multiple of 32 "
                    f"below num_perm (= {num_perm}); received {hamming_cascade}"
                )
            if hamming_cascade_refine <= 0:
                raise ValueError("hamming_cascade_refine must be greater than zero")

        self.num_bands = num_bands
        self.rows_per_band = rows_per_band
        self.words = num_bands * words_per_band(rows_per_band)
        # Narrow refine-table packing (bands share words when they divide
        # 32 evenly): half the refine-gather bytes at r=16. 0 = word-aligned.
        self._refine_narrow_r = narrow_refine_r(rows_per_band)
        self.dim = dim
        self.chunk = chunk_size
        self.group = group_size
        self.dedupe = dedupe
        self.query_mode = query_mode
        self.bucket_cap = bucket_cap
        self._bucket_overflows = 0
        self.enable_hamming = enable_hamming
        self.hamming_storage = hamming_storage
        self.hamming_cascade = hamming_cascade
        self.hamming_cascade_refine = hamming_cascade_refine
        self.store_vectors = store_vectors
        self.payload_dtype = payload_dtype
        self.rerank_engine = rerank_engine
        self.rerank_candidates = rerank_candidates
        self._rerank_truncations = 0
        self.device = torch.device(device)

        self._capacity = _next_pow2(max(chunk_size, initial_capacity))
        self._alloc(self._capacity)
        self._size = 0  # high-water mark of used slots (tombstones included)
        self._tombstones = 0
        self._slot_of: dict[int, int] | None = {} if dedupe else None
        # Bumped on every mutation; snapshot_query_fn closures check it
        # (writes land in place, so a stale closure would see new data).
        self._generation = 0
        self._lock = threading.RLock()
        # Bucket-level ingestion stages index -> {band_id: bytes} until all
        # of a vector's bands have arrived (the signature-batch path never
        # stages).
        self._pending_ops: dict[int, dict[int, bytes]] = {}

    def _alloc(self, cap: int) -> None:
        dev = self.device
        self._sig_t = torch.zeros((self.words, cap), dtype=torch.int32, device=dev)
        # Row-major twin of sig_t: the refine table and the bitplanes are
        # built from whole contiguous rows.
        self._sig_rows = torch.zeros((cap, self.words), dtype=torch.int32, device=dev)
        self._ids = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        self._tie = torch.full((cap,), -1, dtype=torch.int32, device=dev)
        # Id ranks within each chunk: only the chunked cores read them.
        self._ranks: torch.Tensor | None = None
        # (block, tie keys within each block of that many slots): only
        # bitplanes past one block read them.
        self._block_tie: tuple[int, torch.Tensor] | None = None
        self._refine: torch.Tensor | None = None  # grouped refine table, lazy
        # Sorted per-band bucket index (query_mode="bucket"), lazy.
        self._bucket_index: tuple[torch.Tensor, torch.Tensor] | None = None
        # Bitplanes are LAZY: built from the packed words on the first
        # Hamming use, then kept current by appends and overwrites. A
        # packed store never builds them.
        self._planes: torch.Tensor | None = None
        self._ranks_dirty = False  # fresh tensors are self-consistent
        self._payload: torch.Tensor | None = None
        self._pnorm: torch.Tensor | None = None
        # Per-row int8 scales: reconstruction only (get_vectors,
        # checkpoints); the rerank never reads them.
        self._pscale: torch.Tensor | None = None
        if self.store_vectors:
            dtype = _PAYLOAD_DTYPES[self.payload_dtype]
            self._payload = torch.zeros((cap, self.dim), dtype=dtype, device=dev)
            self._pnorm = torch.zeros((cap,), dtype=torch.float32, device=dev)
            if dtype == torch.int8:
                self._pscale = torch.zeros((cap,), dtype=torch.float32, device=dev)

    # -- query path selection ------------------------------------------------

    def _group(self) -> int:
        return min(self.group, self._capacity)

    def _live_slots(self) -> int:
        """Slots kernel B2 scores on the grouped bitplane path: the
        high-water mark rounded up to whole groups (at least one). Every
        slot past it is dead; tombstoned and filtered-out slots inside it
        are scored and masked."""
        g = self._group()
        return min(self._capacity, max(g, -(-self._size // g) * g))

    def _use_grouped(self) -> bool:
        return (
            supports_fast_path(self.num_bands, self._capacity)
            and self.num_bands <= 64
            and self._capacity % self.group == 0
        )

    # The reference's auto rerank policy, kept constant for constant so both
    # packages resolve the same engine. Its cost model was fitted on a TPU
    # v5e at 768d and 1024-query batches (full ~ 125 ms * C / 1M, gather ~
    # 0.25 ms * M + 25 ms * C / 1M: a crossover near C ~ 2560 * M), and the
    # 8 GB budget for the full engine's (Q, C) temporaries is a 16 GB
    # chip's; their fit on this card is an open question (PERF.md).
    _GATHER_MIN_CAPACITY = 1 << 18
    _GATHER_CROSSOVER_SLOTS_PER_CANDIDATE = 2560
    _FULL_RERANK_TEMP_BUDGET = 8 << 30

    def _gather_usable(self) -> bool:
        return self.store_vectors and self._use_grouped()

    def _rerank_cost_rows(self) -> int:
        """Rows the rerank cost model scales with: the capacity here, a
        shard's rows in `lshrs_tpu_torch.parallel.ShardedDeviceStore`."""
        return self._capacity

    def _expected_candidates(self) -> float:
        """Expected colliding candidates per query for random pairs:
        ``alive * (1 - (1 - 2^-r)^b)``. Near-duplicates exceed it;
        truncations are counted."""
        alive = max(0, self._size - self._tombstones)
        r = min(self.rows_per_band, 40)
        return alive * (1.0 - (1.0 - 2.0**-r) ** self.num_bands)

    def _resolve_rerank_engine(
        self, engine: str | None, max_candidates: int | None, q: int = 1024
    ) -> tuple[str, int]:
        """``(engine, max_candidates)`` for a ``q``-query rerank: explicit
        arguments, else the store's; ``"auto"`` takes gather when the full
        engine's temporaries cannot fit, or past both the capacity floor
        and the cost crossover while the expected candidate load fits half
        the budget, and full otherwise."""
        engine = engine if engine is not None else self.rerank_engine
        mc = max_candidates if max_candidates is not None else self.rerank_candidates
        if engine not in ("auto", "full", "gather"):
            raise ValueError("rerank engine must be 'auto', 'full' or 'gather'")
        if mc <= 0:
            raise ValueError("max_candidates must be greater than zero")
        if engine == "gather" and not self._gather_usable():
            raise RuntimeError(
                "rerank_engine='gather' requires store_vectors=True and the "
                "grouped fast path (capacity within int32 key packing)"
            )
        if engine == "auto":
            rows = self._rerank_cost_rows()
            usable = self._gather_usable()
            full_infeasible = q * rows * 8 > self._FULL_RERANK_TEMP_BUDGET and usable
            engine = (
                "gather"
                if full_infeasible
                or (
                    usable
                    and rows >= self._GATHER_MIN_CAPACITY
                    and rows >= mc * self._GATHER_CROSSOVER_SLOTS_PER_CANDIDATE
                    and self._expected_candidates() <= mc / 2
                )
                else "full"
            )
        return engine, mc

    def _refresh_ranks(self) -> None:
        """Mark selection keys stale after a mutation (recomputed lazily)."""
        self._ranks_dirty = True
        self._ranks = None
        self._block_tie = None
        self._refine = None
        self._bucket_index = None
        self._generation += 1

    def _ensure_ranks(self) -> None:
        """Recompute the tie keys if stale (call under the lock; span
        ``lshrs.store.ranks``)."""
        if self._ranks_dirty:
            with span("lshrs.store.ranks"):
                self._tie = global_tie_core(self._ids)
            self._ranks_dirty = False

    def _chunk_ranks(self) -> torch.Tensor:
        """The chunked cores' id ranks within each chunk, computed on first
        use after a mutation (call under the lock). Under ``where=`` they go
        in with the filtered ids, as the reference's do: a filtered-out
        slot scores 0 whatever its rank."""
        if self._ranks is None:
            self._ranks = compute_chunk_ranks(self._ids, chunk=self.chunk)
        return self._ranks

    def _block_ties(self, block: int) -> torch.Tensor:
        """The tie keys of bitplanes ranked in more than one block,
        ``key_scale(block) - 1 - rank`` of each slot's id within its block
        of ``block`` slots (-1 dead), computed on first use after a mutation
        (call under the lock; span ``lshrs.store.ranks``)."""
        if self._block_tie is None or self._block_tie[0] != block:
            with span("lshrs.store.ranks"):
                ranks = compute_chunk_ranks(self._ids, chunk=block)
                tie = torch.where(self._ids >= 0, key_scale(block) - 1 - ranks, -1)
                self._block_tie = (block, tie.to(torch.int32))
        return self._block_tie[1]

    def _ensure_planes(self) -> None:
        """Build the int8 bitplanes on first Hamming use (call under the
        lock; span ``lshrs.store.planes``). Bit-identical to the stored
        words by construction."""
        if (
            not self.enable_hamming
            or self.hamming_storage != "planes"
            or self._planes is not None
        ):
            return
        with span("lshrs.store.planes"):
            self._planes = self._materialize_planes()

    # Bound the unpack intermediates to ~1 GB per step.
    _PLANES_MATERIALIZE_STEP = 1 << 17

    def _plane_bits(self) -> int:
        """Stored bitplane columns: the cascade prefix, or ``num_perm``
        padded to ``plane_width``."""
        return self.hamming_cascade or plane_width(self.num_bands * self.rows_per_band)

    def _cascade_groups(self, k: int) -> int:
        """The cascade's refine pool in groups: ``hamming_cascade_refine``
        slots rounded up to whole groups, at least ``k``."""
        return max(k, -(-self.hamming_cascade_refine // self._group()))

    def _packed_word_bits(self) -> int:
        """The low bits of each stored word that hold signature bits: a
        band of at most 32 rows is one word with its rows in bits
        ``0 .. r-1`` (the rest zero), so kernel B3 expands only those."""
        return min(self.rows_per_band, 32)

    def _planes_rows(self, words: torch.Tensor) -> torch.Tensor:
        """Bitplane rows of ``words`` at the stored width (stores and
        queries alike): zero-padded to ``plane_width(P)`` columns (kernel
        B2 takes the true P), or the cascade's first columns, contiguous."""
        rows = unpack_bitplanes(
            words, num_bands=self.num_bands, rows_per_band=self.rows_per_band,
            width=plane_width(self.num_bands * self.rows_per_band),
        )
        if self.hamming_cascade:
            return rows[:, : self.hamming_cascade].contiguous()
        return rows

    def _materialize_planes(self) -> torch.Tensor:
        p = self._plane_bits()
        planes = torch.empty((self._capacity, p), dtype=torch.int8, device=self.device)
        step = min(self._PLANES_MATERIALIZE_STEP, self._capacity)
        for off in range(0, self._capacity, step):
            planes[off : off + step] = self._planes_rows(self._sig_rows[off : off + step])
        return planes

    def _refine_rows(self) -> torch.Tensor:
        """Lazily built GROUPED refine table, ``(C // group, group * (nw + 2))``.

        Each row concatenates one selection group's per-slot (words | tie |
        id) rows, word-major; refinement gathers one wide row per
        candidate group. Invalidated on any mutation. Built inside the span
        ``lshrs.store.refine_table``.
        """
        if self._refine is None:
            with span("lshrs.store.refine_table"):
                self._ensure_ranks()  # the tie column must be fresh
                words = self._sig_rows
                if self._refine_narrow_r:
                    words = pack_words_narrow(
                        words, num_bands=self.num_bands, rows_per_band=self._refine_narrow_r
                    )
                ext = torch.cat([words, self._tie[:, None], self._ids[:, None]], dim=1)
                self._refine = build_grouped_refine_rows(ext, group=self._group())
        return self._refine

    # ------------------------------------------------------------------
    # signature-batch ingestion
    # ------------------------------------------------------------------

    def _decode_words(self, words, n: int) -> torch.Tensor:
        """Word or dense-wire signatures -> ``(n, BW)`` int32 on the device."""
        dense = (
            words.dtype == torch.uint8
            if isinstance(words, torch.Tensor)
            else np.asarray(words).dtype == np.uint8
        )
        if dense:
            nb = self.num_bands * bytes_per_band(self.rows_per_band)
            if tuple(words.shape) != (n, nb):
                raise ValueError(
                    f"dense signatures must have shape ({n}, {nb}); "
                    f"received {tuple(words.shape)}"
                )
            if not isinstance(words, torch.Tensor):
                words = torch.from_numpy(np.ascontiguousarray(words))
            return dense_to_words(
                words.to(self.device),
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
            )
        w = as_words(words, self.device)
        if tuple(w.shape) != (n, self.words):
            raise ValueError(
                f"signature words must have shape ({n}, {self.words}); "
                f"received {tuple(w.shape)}"
            )
        return w

    @staticmethod
    def _check_ids(indices) -> np.ndarray:
        ids_np = np.asarray(indices, dtype=np.int64).reshape(-1)
        if ids_np.size and (ids_np.min() < 0 or ids_np.max() > _MAX_ID):
            raise ValueError("indices must be in [0, 2**31) for the device store")
        return ids_np

    def _payload_vectors(self, vectors, n: int) -> torch.Tensor | None:
        """Payload rows -> ``(n, dim)`` float32 on the device, or None
        without ``store_vectors``."""
        if not self.store_vectors:
            return None
        if vectors is None:
            raise ValueError("vectors are required when store_vectors=True")
        if not isinstance(vectors, torch.Tensor):
            vectors = torch.from_numpy(np.ascontiguousarray(vectors, dtype=np.float32))
        if tuple(vectors.shape) != (n, self.dim):
            raise ValueError(
                f"vectors must have shape ({n}, {self.dim}); received {tuple(vectors.shape)}"
            )
        return vectors.to(self.device, torch.float32)

    def add_signature_batch(
        self,
        indices: Sequence[int] | np.ndarray,
        words,
        vectors=None,
    ) -> None:
        """Insert/overwrite a batch of ``(id, packed-signature)`` rows.

        Args:
            indices: integer ids, each in ``[0, 2**31)``.
            words: ``(n, num_bands * W)`` uint32 words (NumPy) or int32 /
                uint32 tensor (device tensors stay on the device), or the
                dense uint8 wire ``(n, num_bands * ceil(r/8))`` from
                `LSHHasher.hash_batch_dense_host`, decoded on the device.
            vectors: ``(n, dim)`` float32 payload rows (NumPy or tensor),
                required when ``store_vectors``.
        """
        ids_np = self._check_ids(indices)
        if ids_np.size == 0:
            return
        words = self._decode_words(words, ids_np.size)
        vecs = self._payload_vectors(vectors, ids_np.size)
        ids32 = ids_np.astype(np.int32)
        with self._lock:
            if self._slot_of is not None and self._needs_upsert(ids32):
                # Duplicate or already-present ids: resolve the upserts on
                # the host. Within a batch the last occurrence wins, in the
                # order of last occurrences.
                _, last_pos = np.unique(ids32[::-1], return_index=True)
                keep = np.sort(ids32.size - 1 - last_pos)
                if keep.size != ids32.size:
                    ids32 = ids32[keep]
                    pick = torch.as_tensor(keep, device=self.device)
                    words = words[pick]
                    vecs = vecs[pick] if vecs is not None else None
                existing = np.fromiter(
                    (i in self._slot_of for i in ids32.tolist()), dtype=bool,
                    count=ids32.size,
                )
                if existing.any():
                    slots = np.fromiter(
                        (self._slot_of[i] for i in ids32[existing].tolist()),
                        dtype=np.int64, count=int(existing.sum()),
                    )
                    old = torch.as_tensor(existing, device=self.device)
                    self._overwrite(slots, words[old], vecs[old] if vecs is not None else None)
                    ids32 = ids32[~existing]
                    words = words[~old]
                    vecs = vecs[~old] if vecs is not None else None
            if ids32.size:
                with span("lshrs.store.append"):
                    self._append(ids32, words, vecs)

    # Rows the fused build hashes at a time: the projection and the
    # bitpack's int64 temporaries take ~5.5 KB a row at 256 bits, so a
    # slice holds ~1.4 GB and a 6.4M-row batch fits the card beside its
    # upload.
    _BUILD_HASH_ROWS = 1 << 18

    def add_vectors_batch(
        self,
        indices: Sequence[int] | np.ndarray,
        vectors,
        proj_t: torch.Tensor,
        hash_family: str = "gaussian",
    ) -> None:
        """Device build: hash a raw-vector batch with the device hash
        operand (`LSHHasher.device_projection`) and append it.

        Args:
            proj_t: ``(dim, num_perm)`` float32 projection for the gaussian
                and learned families, the ``(nblocks, 3, dpad)`` diagonals
                for the structured one, ``(num_bands, 3, dpad)`` for
                cross-polytope.
            hash_family: `LSHHasher.hash_family` of the hasher that made
                ``proj_t`` (gaussian / learned: one full-float32 matmul;
                structured / crosspolytope: the fixed-order FWHT, hashed in
                row slices so its temporaries stay near 1 GiB — see
                `lshrs_tpu_torch.hash.fwht.slice_rows`).

        The hash is the formulation the device query path uses
        (`lshrs_tpu_torch.hash.hasher.hash_words`), so stored and query
        signatures agree bit for bit; it runs in slices of
        ``_BUILD_HASH_ROWS`` rows, so its temporaries stay bounded. Batches
        with duplicate or already-present ids take the upsert path. With ``store_vectors``
        the same device tensor becomes the payload rows (one upload per
        batch).
        """
        if hash_family not in ("gaussian", "structured", "learned", "crosspolytope"):
            raise ValueError(
                "hash_family must be 'gaussian', 'structured', 'learned' "
                "or 'crosspolytope'"
            )
        ids_np = self._check_ids(indices)
        if ids_np.size == 0:
            return
        with span("lshrs.hash"):  # the upload, the projection, the bitpack
            x = torch.as_tensor(vectors, dtype=torch.float32).to(self.device)
            if x.ndim != 2 or x.shape[0] != ids_np.size or (
                self.dim is not None and x.shape[1] != self.dim
            ):
                raise ValueError(
                    f"vectors must have shape ({ids_np.size}, {self.dim}); "
                    f"received {tuple(x.shape)}"
                )
            step = self._BUILD_HASH_ROWS
            parts = [
                hash_words(
                    x[s : s + step], proj_t, num_bands=self.num_bands,
                    rows_per_band=self.rows_per_band, hash_family=hash_family,
                )
                for s in range(0, x.shape[0], step)
            ]
            words = parts[0] if len(parts) == 1 else torch.cat(parts)
        self.add_signature_batch(ids_np, words, x if self.store_vectors else None)

    def _needs_upsert(self, ids32: np.ndarray) -> bool:
        """True when the batch holds duplicate or already-present ids (span
        ``lshrs.store.upsert_check``)."""
        with span("lshrs.store.upsert_check"):
            if np.unique(ids32).size != ids32.size:
                return True
            slot_of = self._slot_of
            return any(i in slot_of for i in ids32.tolist())

    def _write_payload(self, idx, vecs: torch.Tensor | None) -> None:
        """Cast ``vecs`` to the payload dtype and write them, their norms
        and (int8) scales at slots ``idx`` (a slice or an index tensor)."""
        if self._payload is None or vecs is None:
            return
        rows, norms, scale = _cast_payload_rows(vecs, self._payload.dtype)
        self._payload[idx] = rows
        self._pnorm[idx] = norms
        if scale is not None:
            self._pscale[idx] = scale

    def _overwrite(self, slots: np.ndarray, words: torch.Tensor, vecs: torch.Tensor | None) -> None:
        idx = torch.as_tensor(slots, device=self.device)
        self._sig_t[:, idx] = words.T
        self._sig_rows[idx] = words
        if self._planes is not None:
            self._planes[idx] = self._planes_rows(words)
        self._write_payload(idx, vecs)
        self._refine = None
        self._bucket_index = None  # the slots' band keys changed
        self._generation += 1
        # ids unchanged -> tie keys unchanged.

    def _append(self, ids32: np.ndarray, words: torch.Tensor, vecs: torch.Tensor | None) -> None:
        n = ids32.size
        # Reserve next_pow2(n) slots, as the reference pads each batch.
        pad = _next_pow2(n)
        if self._size + pad > self._capacity:
            with span("lshrs.store.grow"):
                self._grow(max(2 * self._capacity, _next_pow2(self._size + pad)))
        off = self._size
        self._write_slots(off, torch.from_numpy(ids32).to(self.device), words, vecs)
        if self._slot_of is not None:
            self._slot_of.update(zip(ids32.tolist(), range(off, off + n)))
        self._size += n
        self._refresh_ranks()

    def _write_slots(
        self, off: int, ids: torch.Tensor, words: torch.Tensor, vecs: torch.Tensor | None
    ) -> None:
        """Write ``len(ids)`` rows at slots ``[off, off + n)`` in place, where
        the reference donated its buffers to a jitted update
        (lshrs_tpu/storage/device.py::_append_jit). The caller keeps the
        bookkeeping (size, id -> slot map, derived state)."""
        n = ids.shape[0]
        self._sig_t[:, off : off + n] = words.T
        self._sig_rows[off : off + n] = words
        self._ids[off : off + n] = ids
        if self._planes is not None:
            self._planes[off : off + n] = self._planes_rows(words)
        self._write_payload(slice(off, off + n), vecs)

    def _grow(self, new_cap: int) -> None:
        new_cap = _next_pow2(new_cap)
        cap = self._capacity
        old = (self._sig_t, self._sig_rows, self._ids, self._payload, self._pnorm, self._pscale)
        planes = self._planes
        self._alloc(new_cap)
        for new, prev in zip(
            (self._sig_t.T, self._sig_rows, self._ids, self._payload, self._pnorm, self._pscale),
            (old[0].T, *old[1:]),
        ):
            if prev is not None:
                new[:cap] = prev
        if planes is not None:
            self._planes = torch.zeros(
                (new_cap, planes.shape[1]), dtype=torch.int8, device=self.device
            )
            self._planes[:cap] = planes
        self._capacity = new_cap
        self._refresh_ranks()

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------

    def _norm_qwords(self, qwords) -> tuple[torch.Tensor, int]:
        """Query words -> ``((Q, probes * BW) int32 on the device, probes)``.

        Accepts the standard ``(Q, BW)`` layout and the multi-probe
        ``(Q, T, BW)`` layout (`LSHHasher.hash_batch_probe_words[_host]`),
        flattened probe-major, which is what kernel B1 reads.

        Multi-probe CONTRACT: within each band, a query's T probe
        signatures must be pairwise DISTINCT (the hashers' probe
        generators guarantee this — each variant flips a distinct bit).
        Any-match counting relies on it: a duplicated variant counts its
        band twice, inflating counts past ``num_bands`` and, at the
        packing limit, corrupting the (count, tie) selection keys. Pad a
        ragged probe axis by flipping further distinct bits, never by
        repeating a signature.
        """
        qw = as_words(qwords, self.device)
        if qw.ndim == 3 and qw.shape[2] == self.words and qw.shape[1] >= 1:
            q, t, bw = qw.shape
            return qw.reshape(q, t * bw), t
        if qw.ndim != 2 or qw.shape[1] != self.words:
            raise ValueError(
                f"query words must have shape (Q, {self.words}) or "
                f"(Q, T, {self.words}); received {tuple(qw.shape)}"
            )
        return qw, 1

    def _query_words(self, qwords) -> torch.Tensor:
        """Single-probe query words -> ``(Q, BW)`` int32 on the device
        (the Hamming modes rank every slot already and take no probes)."""
        qw, probes = self._norm_qwords(qwords)
        if probes != 1:
            raise ValueError(
                "multi-probe applies to collision counting only (the "
                "Hamming estimator ranks every slot already)"
            )
        return qw

    def _wire_words(self, q, wire: str, probes: int) -> torch.Tensor:
        """A serving closure's input -> ``(Q, probes * BW)`` int32 on the
        device. ``wire="dense"``: ``(Q, DB)`` uint8, or ``(Q, T, DB)``
        with probes, decoded probe by probe; ``wire="words"``: ``(Q, BW)``,
        ``(Q, T, BW)`` or the flat probe-major ``(Q, T * BW)``."""
        if wire == "dense":
            d = torch.as_tensor(q).to(self.device)
            nq = d.shape[0]
            return dense_to_words(
                d.reshape(nq * probes, -1),
                num_bands=self.num_bands, rows_per_band=self.rows_per_band,
            ).reshape(nq, -1)
        qw = as_words(q, self.device)
        qw = qw.reshape(qw.shape[0], -1)
        if qw.shape[1] != probes * self.words:
            raise ValueError(
                f"query words must hold {probes} x {self.words} words per "
                f"query; received {tuple(qw.shape)}"
            )
        return qw

    def _filtered_ids_tie(self, where) -> tuple[torch.Tensor, torch.Tensor]:
        """(ids, tie) with ``where``-inadmissible slots marked dead (call
        under the lock, after :meth:`_ensure_ranks`).

        The filtered columns flow through every query core exactly like
        tombstones (id / tie < 0: a dead key), so filtered results equal
        brute force over the admitted subset. The grouped refine table
        bakes in the UNfiltered tie / id columns, so filtered queries pass
        ``sig_rows=None`` and the cores gather per slot.
        """
        if where is None:
            return self._ids, self._tie
        if isinstance(where, tuple):  # a shard's columns, resolved by its sharded store
            return where
        return as_filter(where).device_state(self)

    def _query_topk_dev(
        self, qw: torch.Tensor, k: int, probes: int = 1, where=None, *, bucket: bool = True
    ):
        """Device-resident collision top-k (call under the lock).

        ``query_mode="bucket"`` answers through the bucket index, except for
        multi-probe queries (the index holds exact band keys), filtered
        ones (it bakes in the unfiltered tie column), stores past
        `supports_fast_path` (its key packs into int32) and ``bucket=False``
        (serving closures, as the reference's snapshot closes over the scan
        state only): those take the scan — kernel B1, or the chunked core
        where the grouped key cannot run (past int32, more than 64 bands,
        below the group)."""
        if (
            bucket
            and self.query_mode == "bucket"
            and probes == 1
            and where is None
            and supports_fast_path(self.num_bands, self._capacity)
        ):
            self._ensure_ranks()
            if self._bucket_index is None:
                self._bucket_index = build_bucket_index(
                    self._sig_t, self._ids, num_bands=self.num_bands
                )
            counts, ids, overflows = bucketed_topk(
                self._sig_t, self._ids, self._tie, *self._bucket_index, qw,
                num_bands=self.num_bands,
                k=max(1, min(k, self._capacity)),
                bucket_cap=min(self.bucket_cap, self._capacity),
            )
            self._bucket_overflows += int(overflows)
            return counts, ids
        self._ensure_ranks()
        ids_x, tie_x = self._filtered_ids_tie(where)
        if not self._use_grouped():
            return collision_topk_core(
                self._sig_t, ids_x, self._chunk_ranks(), qw,
                num_bands=self.num_bands, k=max(1, min(k, self._capacity)),
                chunk=self.chunk, probes=probes,
            )
        return collision_topk_grouped_core(
            self._sig_t, tie_x, qw,
            self._refine_rows() if where is None else None,
            num_bands=self.num_bands,
            k=max(1, min(k, self._capacity)),
            group=self._group(),
            narrow_r=self._refine_narrow_r,
            probes=probes,
            ids=ids_x,
        )

    def query_topk(self, qwords, k: int, *, where=None) -> tuple[np.ndarray, np.ndarray]:
        """Exact (count desc, id asc) top-k for a query batch.

        Args:
            qwords: ``(Q, num_bands * W)`` signature words, or the
                multi-probe ``(Q, T, num_bands * W)`` layout — counts are
                then bands matching ANY probe variant.
            where: optional `lshrs_tpu_torch.storage.IdFilter` (or an
                array-like allowlist of ids): results rank ONLY the
                admitted subset — exact top-k over it, not post-filtering.
        Returns:
            ``(counts, ids)`` NumPy int32 arrays of shape ``(Q, k)``;
            zero-count padding carries id -1.
        """
        qw, probes = self._norm_qwords(qwords)
        q = qw.shape[0]
        with self._lock:
            if self._size == 0:
                return np.zeros((q, k), np.int32), np.full((q, k), -1, np.int32)
            counts, ids = self._query_topk_dev(qw, k, probes, where)
        counts, ids = counts.cpu().numpy(), ids.cpu().numpy()
        if counts.shape[1] < k:
            pad = k - counts.shape[1]
            counts = np.pad(counts, ((0, 0), (0, pad)))
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return counts, ids

    def query_topk_ids(self, qwords, k: int, *, where=None) -> torch.Tensor:
        """Device-resident id-only top-k, ``(Q, k_eff)`` int32 tensor."""
        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return torch.full((qw.shape[0], k), -1, dtype=torch.int32, device=self.device)
            return self._query_topk_dev(qw, k, probes, where)[1]

    def _require_hamming(self) -> None:
        if not self.enable_hamming:
            raise RuntimeError(
                "enable_hamming=False: construct the store with "
                "enable_hamming=True for Hamming-mode queries"
            )

    def _query_hamming_dev(self, qw: torch.Tensor, k: int, where=None):
        """Device-resident Hamming top-k (call under the lock)."""
        p = self.num_bands * self.rows_per_band
        aligned = self._capacity % self.group == 0
        if self.hamming_cascade and aligned:
            # The coarse key packs at any capacity (its tie is shifted past
            # the ceiling) and the refine keys in int64.
            return self._query_cascade_dev(qw, k, where)
        self._ensure_ranks()
        ids_x, tie_x = self._filtered_ids_tie(where)
        k_eff = max(1, min(k, self._capacity))
        planes = self.hamming_storage == "planes" and not self.hamming_cascade
        # Bitplanes rank in blocks of at most one B2 launch's int32 key,
        # packed words in one launch.
        block = min(hamming_block_slots(p), self._capacity) if planes else self._capacity
        if not (aligned and supports_hamming_grouped(p, block)):
            # The chunked fallbacks. A cascade store's planes are a prefix
            # only, so it ranks on the packed words, as the reference's does.
            if not planes:
                return hamming_topk_packed_chunked_core(
                    self._sig_t, ids_x, self._chunk_ranks(), qw,
                    num_perm=p, k=k_eff, chunk=self.chunk,
                )
            self._ensure_planes()
            return hamming_topk_chunked_core(
                self._planes, ids_x, self._chunk_ranks(), self._planes_rows(qw),
                k=k_eff, chunk=self.chunk, num_perm=p,
            )
        rows = self._refine_rows() if where is None else None
        kw = dict(k=k_eff, group=self._group(), narrow_r=self._refine_narrow_r, ids=ids_x)
        if not planes:
            return hamming_topk_packed_core(
                self._sig_t, tie_x, qw, rows, num_perm=p,
                word_bits=self._packed_word_bits(), **kw
            )
        self._ensure_planes()
        btie = tie_x  # one block: its ties are the global ones
        if block < self._capacity:
            btie = self._block_ties(block)
            if where is not None:  # the filter's dead slots, as in tie_x
                btie = torch.where(tie_x >= 0, btie, -1)
        return hamming_topk_blocked_core(
            self._planes, btie, self._planes_rows(qw), qw, rows,
            block=block, live=self._live_slots(), num_perm=p, sig_t=self._sig_t, **kw
        )

    def _query_cascade_dev(self, qw: torch.Tensor, k: int, where=None):
        """The refinement cascade's top-k, in query slices of
        :func:`cascade_slice_queries` (call under the lock)."""
        self._ensure_ranks()
        self._ensure_planes()
        ids_x, tie_x = self._filtered_ids_tie(where)
        k_eff = max(1, min(k, self._capacity))
        group = self._group()
        refine_groups = self._cascade_groups(k_eff)
        rows = self._refine_rows() if where is None else None
        step = cascade_slice_queries(
            self._capacity, group=group,
            pool_groups=min(refine_groups, self._capacity // group),
            words=qw.shape[1] if rows is None else rows.shape[1] // group - 2,
        )
        kw = dict(
            num_perm=self.num_bands * self.rows_per_band,
            k=k_eff,
            refine_groups=refine_groups,
            group=group,
            narrow_r=self._refine_narrow_r if where is None else 0,
            sig_t=self._sig_t,
            ids=ids_x,
        )
        parts = [
            hamming_topk_cascade_core(
                self._planes, tie_x, self._planes_rows(qw[s : s + step]), qw[s : s + step],
                rows, **kw,
            )
            for s in range(0, qw.shape[0], step)
        ]
        if len(parts) == 1:
            return parts[0]
        return torch.cat([h for h, _ in parts]), torch.cat([i for _, i in parts])

    def query_hamming(self, qwords, k: int, *, where=None) -> tuple[np.ndarray, np.ndarray]:
        """Top-k by full-signature Hamming distance (kernel B2 on
        bitplanes, B3 on packed words).

        Requires ``enable_hamming=True``. Returns ``(hamming (Q, k),
        ids (Q, k))`` ordered by (hamming asc, id asc); empty tail entries
        carry id -1 and hamming ``num_perm + 1``. ``where``: optional id
        filter (exact ranking over the admitted subset).
        """
        self._require_hamming()
        qw = self._query_words(qwords)
        p = self.num_bands * self.rows_per_band
        with self._lock:
            if self._size == 0:
                q = qw.shape[0]
                return np.full((q, k), p + 1, np.int32), np.full((q, k), -1, np.int32)
            hamming, ids = self._query_hamming_dev(qw, k, where)
        hamming, ids = hamming.cpu().numpy(), ids.cpu().numpy()
        if hamming.shape[1] < k:
            pad = k - hamming.shape[1]
            hamming = np.pad(hamming, ((0, 0), (0, pad)), constant_values=p + 1)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return hamming, ids

    def query_hamming_ids(self, qwords, k: int, *, where=None) -> torch.Tensor:
        """Device-resident id-only Hamming top-k."""
        self._require_hamming()
        qw = self._query_words(qwords)
        with self._lock:
            if self._size == 0:
                return torch.full((qw.shape[0], k), -1, dtype=torch.int32, device=self.device)
            return self._query_hamming_dev(qw, k, where)[1]

    def _check_asymmetric(self) -> None:
        if not self.enable_hamming:
            raise RuntimeError(
                "enable_hamming=False: construct the store with "
                "enable_hamming=True for asymmetric-mode queries"
            )
        if self.hamming_cascade:
            raise RuntimeError(
                "asymmetric ranking is unavailable with hamming_cascade: "
                "the store holds only the coarse bitplane prefix, and the "
                "asymmetric estimator ranks against full-width bitplanes"
            )

    def _require_asymmetric_planes(self) -> None:
        if self.hamming_storage != "planes":
            raise RuntimeError(
                'asymmetric ranking requires hamming_storage="planes": the '
                "query's quantised coordinates rank against int8 bitplanes "
                "(kernel B2; the packed words have no bitplane operand)"
            )

    def _query_coords(self, qcoords) -> torch.Tensor:
        """Quantised coordinates ``(Q, P)`` -> int8 on the device, zero-padded
        to the planes' width (contiguous: kernel B2's operand)."""
        p = self.num_bands * self.rows_per_band
        if not isinstance(qcoords, torch.Tensor):
            qcoords = torch.from_numpy(np.ascontiguousarray(qcoords, dtype=np.int8))
        qc = qcoords.to(self.device, torch.int8)
        if qc.ndim != 2 or qc.shape[1] != p:
            raise ValueError(
                f"query coordinates must have shape (Q, {p}); received {tuple(qc.shape)}"
            )
        return torch.nn.functional.pad(qc, (0, plane_width(p) - p)).contiguous()

    def _query_asymmetric_dev(self, qc: torch.Tensor, k: int, where=None, qmax: int = QMAX):
        """Device-resident asymmetric top-k of padded int8 coordinates
        (call under the lock)."""
        self._require_asymmetric_planes()
        self._ensure_ranks()
        self._ensure_planes()
        ids_x, tie_x = self._filtered_ids_tie(where)
        p = self.num_bands * self.rows_per_band
        k_eff = max(1, min(k, self._capacity))
        if self._capacity % self._group():
            return asymmetric_topk_chunked_core(
                self._planes, ids_x, self._chunk_ranks(), qc,
                k=k_eff, chunk=self.chunk, qmax=qmax, num_perm=p,
            )
        return asymmetric_topk_core(
            self._planes, tie_x, qc, self._refine_rows() if where is None else None,
            num_bands=self.num_bands, rows_per_band=self.rows_per_band,
            k=k_eff, group=self._group(),
            shift=asymmetric_shift(p, self._capacity, qmax=qmax), qmax=qmax,
            narrow_r=self._refine_narrow_r if where is None else 0,
            sig_t=self._sig_t, ids=ids_x,
        )

    def query_asymmetric(self, qcoords, k: int, *, where=None) -> tuple[np.ndarray, np.ndarray]:
        """Top-k by asymmetric SimHash score (kernel B2 on the bitplanes).

        Args:
            qcoords: ``(Q, num_perm)`` int8 quantised projection coordinates
                (`lshrs_tpu_torch.ops.asymmetric.quantize_coords_np`).
            k: result depth.
            where: optional id filter (exact ranking over the admitted
                subset).

        Returns ``(dots (Q, k) int32, ids (Q, k) int32)`` by (dots desc, id
        asc); empty tail entries carry id -1 and dots ``-(P * 127 + 1)``.
        ``dots / sum|qcoords_row|`` estimates the cosine. Requires
        ``enable_hamming=True`` with ``hamming_storage="planes"`` and no
        cascade.
        """
        self._check_asymmetric()
        qc = self._query_coords(qcoords)
        empty = -(self.num_bands * self.rows_per_band * QMAX + 1)
        with self._lock:
            if self._size == 0:
                q = qc.shape[0]
                return np.full((q, k), empty, np.int32), np.full((q, k), -1, np.int32)
            dots, ids = self._query_asymmetric_dev(qc, k, where)
        dots, ids = dots.cpu().numpy(), ids.cpu().numpy()
        if dots.shape[1] < k:
            pad = k - dots.shape[1]
            dots = np.pad(dots, ((0, 0), (0, pad)), constant_values=empty)
            ids = np.pad(ids, ((0, 0), (0, pad)), constant_values=-1)
        return dots, ids

    def snapshot_query_fn(
        self,
        k: int,
        *,
        wire: str = "words",
        dev_batch: int | None = None,
        mode: str = "collision",
        probes: int = 1,
        where=None,
    ):
        """Serving closure over the CURRENT contents.

        Mutating the store invalidates the snapshot: a stale closure raises
        ``RuntimeError`` (take a new snapshot after ingesting). Collision
        mode serves through the scan under ``query_mode="bucket"`` too, as
        the reference's closure does (equal results whenever no bucket run
        overflows).

        Args:
            k: result depth.
            wire: ``"words"`` (signature words) or ``"dense"`` (minimal-byte
                signatures from `LSHHasher.hash_batch_dense_host`, decoded
                on the device); for ``mode="asymmetric"``, ``"words"`` means
                ``(Q, num_perm)`` int8 quantised coordinates and
                ``"coords4"`` the half-size nibble wire of
                `lshrs_tpu_torch.ops.asymmetric.pack_coords_int4_np` (coords
                quantised with ``qmax=QMAX4``).
            dev_batch: optionally serve a batch in slices of this many
                queries (bounds the working set of very large batches; the
                ids do not depend on it). The cascade's own query slices and
                the chunked cores' steps apply inside each slice.
            mode: ``"collision"`` (band-collision counting, kernel B1),
                ``"hamming"`` (full-signature ranking, kernel B2 or B3 by
                ``hamming_storage``, or the cascade; requires
                ``enable_hamming=True``) or ``"asymmetric"`` (quantised
                coordinates against the bitplanes, kernel B2).
            probes: multi-probe depth T (collision mode only). The
                closure's input grows a probe axis —
                ``(Q, T, num_bands * W)`` words from
                `LSHHasher.hash_batch_probe_words[_host]` (a flat
                ``(Q, T * num_bands * W)`` probe-major layout is also
                accepted), or ``(Q, T, dense_bytes)`` with
                ``wire="dense"``.
            where: optional id filter, resolved once here; every batch
                ranks only the admitted subset.

        Returns:
            callable ``(signatures) -> (Q, k) int32 device tensor of ids``.
        """
        if wire not in ("words", "dense", "coords4"):
            raise ValueError("wire must be 'words', 'dense' or 'coords4'")
        if wire == "coords4" and mode != "asymmetric":
            raise ValueError("wire='coords4' applies to mode='asymmetric' only")
        if mode not in ("collision", "hamming", "asymmetric"):
            raise ValueError("mode must be 'collision', 'hamming' or 'asymmetric'")
        if probes < 1:
            raise ValueError("probes must be >= 1")
        if probes > 1 and mode != "collision":
            raise ValueError(
                "multi-probe applies to collision counting only (the "
                "hamming/asymmetric estimators rank every slot already)"
            )
        if mode == "hamming":
            self._require_hamming()
        if mode == "asymmetric":
            self._check_asymmetric()
        if dev_batch is not None and dev_batch <= 0:
            raise ValueError("dev_batch must be greater than zero")
        qmax = QMAX4 if wire == "coords4" else QMAX
        where = as_filter(where)
        with self._lock:
            if self._size == 0:
                raise RuntimeError("snapshot_query_fn requires a non-empty store")
            if mode == "asymmetric":
                self._require_asymmetric_planes()
            snapshot_gen = self._generation

        def run_slice(q) -> torch.Tensor:
            if mode == "asymmetric":
                if wire == "coords4":  # packed nibbles -> int8 coords
                    q = unpack_coords_int4(torch.as_tensor(q).to(self.device))
                qc = self._query_coords(q)
                return self._query_asymmetric_dev(qc, k, where, qmax)[1]
            qw = self._wire_words(q, wire, probes)
            if mode == "hamming":
                return self._query_hamming_dev(qw, k, where)[1]
            return self._query_topk_dev(qw, k, probes, where, bucket=False)[1]

        def serve(q) -> torch.Tensor:
            with self._lock:
                if self._generation != snapshot_gen:
                    raise RuntimeError(
                        "snapshot_query_fn is stale: the store was mutated "
                        "after the snapshot was taken; call snapshot_query_fn "
                        "again"
                    )
                if dev_batch is None or len(q) <= dev_batch:
                    return run_slice(q)
                return torch.cat(
                    [run_slice(q[s : s + dev_batch]) for s in range(0, len(q), dev_batch)]
                )

        return serve

    # ------------------------------------------------------------------
    # full counts, candidate enumeration, top-p rerank
    # ------------------------------------------------------------------

    def _counts_dev(
        self, qw: torch.Tensor, ids: torch.Tensor | None = None, probes: int = 1
    ) -> torch.Tensor:
        """``(Q, C)`` collision counts on the device, 0 where ``ids`` (the
        store's id column by default, or a filtered copy) is dead (call
        under the lock)."""
        return collision_counts_core(
            self._sig_t, self._ids if ids is None else ids, qw, num_bands=self.num_bands,
            chunk=count_step(qw.shape[0], self.chunk), probes=probes,
        )

    def query_counts(self, qwords, *, where=None) -> tuple[np.ndarray, np.ndarray]:
        """Full per-slot collision counts plus the slot-id map:
        ``(counts (Q, capacity), ids (capacity,))``, the device analogue of
        the reference's whole candidate dict. ``where``-inadmissible slots
        report zero counts and id -1."""
        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return (
                    np.zeros((qw.shape[0], self._capacity), np.int32),
                    np.full((self._capacity,), -1, np.int32),
                )
            self._ensure_ranks()
            ids_x, _ = self._filtered_ids_tie(where)
            counts, ids = self._counts_dev(qw, ids_x, probes), ids_x.clone()
        return counts.cpu().numpy(), ids.cpu().numpy()

    def query_nnz(self, qwords, *, where=None) -> np.ndarray:
        """Per-query colliding-candidate counts, ``(Q,)``: the completeness
        probe of the bounded candidate enumeration (O(Q) readback, and no
        ``(Q, C)`` matrix on the device either). ``where``-inadmissible
        slots do not count."""
        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return np.zeros((qw.shape[0],), np.int32)
            self._ensure_ranks()
            ids_x, _ = self._filtered_ids_tie(where)
            n = collision_nnz_core(
                self._sig_t, ids_x, qw, num_bands=self.num_bands,
                chunk=count_step(qw.shape[0], self.chunk), probes=probes,
            )
        return n.cpu().numpy()

    def _require_payload(self) -> None:
        if not self.store_vectors:
            raise RuntimeError("store_vectors=False: no resident payload to rerank")

    def _query_vectors(self, qvecs, q: int) -> torch.Tensor:
        """Query vectors -> ``(q, dim)`` float32 or bfloat16 on the device."""
        if isinstance(qvecs, torch.Tensor):
            if qvecs.dtype not in (torch.float32, torch.bfloat16):
                qvecs = qvecs.to(torch.float32)
        else:
            qvecs = torch.from_numpy(np.ascontiguousarray(qvecs, dtype=np.float32))
        if tuple(qvecs.shape) != (q, self.dim):
            raise ValueError(
                f"query vectors must have shape ({q}, {self.dim}); "
                f"received {tuple(qvecs.shape)}"
            )
        return qvecs.to(self.device)

    def query_topp(
        self, qwords, qvec, max_out: int, *, where=None
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Top-p rerank of one query on the device: collision counts, then
        the cosine ranking (full engine). Returns the first ``max_out``
        colliding candidates by (cosine desc, id asc) and the candidate
        count; only ``O(max_out)`` values reach the host."""
        self._require_payload()
        qw, probes = self._norm_qwords(qwords)
        with self._lock:
            if self._size == 0:
                return np.full(max_out, -1, np.int32), np.zeros(max_out, np.float32), 0
            qv = self._query_vectors(np.asarray(qvec, np.float32).reshape(1, -1), 1)[0]
            self._ensure_ranks()
            ids_x, _ = self._filtered_ids_tie(where)
            ids, sims, n = rerank_topp_core(
                self._payload, self._pnorm, ids_x, self._counts_dev(qw, ids_x, probes)[0], qv,
                max_out=max(1, min(max_out, self._capacity)),
            )
        return ids.cpu().numpy(), sims.cpu().numpy(), int(n)

    def _topp_dev_batch(self, eng: str, mc: int) -> int:
        """Queries per slice of a top-p batch: each slice's working set
        stays near 2 GB. Gather: the refine-row and payload gathers, ~``mc *
        (group * (BW + 2) + dim) * 4`` bytes per query, plus the group-max
        keys; full: the ``(Q, C)`` counts and cosines, ``C * 8``. No floor:
        a 128-query floor would overshoot the bound (the reference's
        ``max(128, ...)`` does)."""
        if eng == "gather":
            group = self._group()
            per_q = mc * (group * (self.words + 2) + self.dim) * 4
            per_q += (self._capacity // group) * 4
        else:
            per_q = self._capacity * 8
        q_cap = max(1, (1 << 31) // per_q)
        return (q_cap // 128) * 128 if q_cap >= 128 else q_cap

    def _topp_dev(
        self, qw, qv, *, eng: str, mc: int, max_out: int, dev_batch: int,
        probes: int = 1, where=None,
    ):
        """Top-p rerank of a batch on the device, ``dev_batch`` queries at
        a time (call under the lock). Returns device ``(ids, sims, n,
        exact)``; ``exact`` is all True on the full engine."""
        self._ensure_ranks()
        ids_x, tie_x = self._filtered_ids_tie(where)
        if eng == "gather":
            refine = self._refine_rows() if where is None else None
        parts = []
        for s in range(0, qw.shape[0], dev_batch):
            q_s, v_s = qw[s : s + dev_batch], qv[s : s + dev_batch]
            if eng == "gather":
                parts.append(rerank_topp_gather_core(
                    self._payload, self._pnorm, tie_x, self._sig_t, q_s, v_s, refine,
                    num_bands=self.num_bands, max_out=max_out, max_candidates=mc,
                    group=self._group(), narrow_r=self._refine_narrow_r,
                    probes=probes, ids=ids_x,
                ))
            else:
                ids, sims, n = rerank_topp_batch_core(
                    self._payload, self._pnorm, ids_x,
                    self._counts_dev(q_s, ids_x, probes), v_s,
                    max_out=max_out,
                )
                parts.append((ids, sims, n, torch.ones_like(n, dtype=torch.bool)))
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat(cols) for cols in zip(*parts))

    def query_topp_batch(
        self,
        qwords,
        qvecs,
        max_out: int,
        *,
        wire_dtype: str = "float32",
        engine: str | None = None,
        max_candidates: int | None = None,
        where=None,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batched top-p rerank on the device.

        Returns ``(ids (Q, out), sims (Q, out), n (Q,))`` ordered by
        (cosine desc, id asc), ``out = min(max_out, capacity)``; ``n[i]``
        is query i's colliding-candidate count.

        Args:
            wire_dtype: ``"float32"`` (value-exact cosines) or
                ``"bfloat16"``: the queries are rounded to bf16 (on the
                host, by ``torch``, half to even) and ship half the bytes,
                at ~1e-2 relative cosine rounding.
            engine / max_candidates: override ``rerank_engine`` /
                ``rerank_candidates`` for this call. On the gather engine a
                query whose colliding set exceeds the budget reranks the
                ``max_candidates`` most-colliding candidates, ``n`` is a
                lower bound, and ``stats()["rerank_truncations"]`` counts it.
            where: optional id filter; the candidate set and ``n`` cover
                the admitted subset only.

        ``qwords`` may carry a probe axis ``(Q, T, BW)``: candidate sets
        then include any-probe band matches before the cosine rerank.
        """
        self._require_payload()
        if wire_dtype not in ("float32", "bfloat16"):
            raise ValueError("wire_dtype must be 'float32' or 'bfloat16'")
        qw, probes = self._norm_qwords(qwords)
        q = qw.shape[0]
        with self._lock:
            if self._size == 0:
                return (
                    np.full((q, max_out), -1, np.int32),
                    np.zeros((q, max_out), np.float32),
                    np.zeros((q,), np.int32),
                )
            eng, mc = self._resolve_rerank_engine(engine, max_candidates, q=q)
            qv = torch.from_numpy(np.ascontiguousarray(qvecs, dtype=np.float32))
            if wire_dtype == "bfloat16":
                qv = qv.to(torch.bfloat16)
            ids, sims, n, exact = self._topp_dev(
                qw, self._query_vectors(qv, q), eng=eng, mc=mc,
                max_out=max(1, min(max_out, self._capacity)),
                dev_batch=self._topp_dev_batch(eng, mc),
                probes=probes, where=where,
            )
            self._rerank_truncations += q - int(exact.sum())
        return ids.cpu().numpy(), sims.cpu().numpy(), n.cpu().numpy()

    def snapshot_topp_fn(
        self,
        max_out: int,
        *,
        wire: str = "words",
        engine: str | None = None,
        max_candidates: int | None = None,
        probes: int = 1,
        batch_hint: int = 1024,
        dev_batch: int | None = None,
        where=None,
    ):
        """Top-p rerank serving closure over the CURRENT contents.

        Args:
            max_out: ranked prefix length per query.
            wire: ``"words"`` or ``"dense"`` signatures (as
                :meth:`snapshot_query_fn`).
            engine / max_candidates: rerank formulation, resolved once
                here. On the gather engine ``n[i] >= max_candidates`` marks
                a possibly truncated ranking.
            probes: multi-probe depth T — the signature input grows a
                probe axis (``(Q, T, ...)`` words or dense, as
                :meth:`snapshot_query_fn`); candidate sets then include
                any-probe band matches before the cosine rerank.
            where: optional id filter, resolved once here.
            batch_hint: the batch size the closure will serve; the auto
                engine sizes the full engine's ``(Q, C)`` temporaries from
                it.
            dev_batch: queries per device slice; ``None`` sizes slices to
                ~2 GB of working set (see :meth:`_topp_dev_batch`).

        Returns:
            callable ``(signatures, qvecs) -> (ids (Q, out) int32, sims
            (Q, out) float32, n (Q,) int32)`` device tensors; ``qvecs`` is
            float32 or bfloat16 (NumPy float32, or a tensor on any
            device). Mutating the store invalidates the snapshot (a stale
            closure raises ``RuntimeError``).
        """
        if wire not in ("words", "dense"):
            raise ValueError("wire must be 'words' or 'dense'")
        if probes < 1:
            raise ValueError("probes must be >= 1")
        self._require_payload()
        where = as_filter(where)
        with self._lock:
            if self._size == 0:
                raise RuntimeError("snapshot_topp_fn requires a non-empty store")
            eng, mc = self._resolve_rerank_engine(engine, max_candidates, q=batch_hint)
            out = max(1, min(max_out, self._capacity))
            snapshot_gen = self._generation
        if dev_batch is None:
            dev_batch = self._topp_dev_batch(eng, mc)

        def serve(q, qvecs):
            with self._lock:
                if self._generation != snapshot_gen:
                    raise RuntimeError(
                        "snapshot_topp_fn is stale: the store was mutated "
                        "after the snapshot was taken; call snapshot_topp_fn "
                        "again"
                    )
                qw = self._wire_words(q, wire, probes)
                qv = self._query_vectors(qvecs, qw.shape[0])
                return self._topp_dev(
                    qw, qv, eng=eng, mc=mc, max_out=out, dev_batch=dev_batch,
                    probes=probes, where=where,
                )[:3]

        return serve

    def get_vectors(self, indices: Sequence[int]) -> np.ndarray:
        """Resident payload rows by id, float32 (int8 rows dequantized by
        their scale). Ids never indexed or deleted raise ``KeyError``."""
        if not self.store_vectors:
            raise RuntimeError("store_vectors=False: no resident payload to fetch")
        if self._slot_of is None:
            raise RuntimeError("get_vectors requires dedupe=True (id -> slot map)")
        with self._lock:
            missing = [int(i) for i in indices if int(i) not in self._slot_of]
            if missing:
                raise KeyError(
                    f"ids not present in the index (unknown or deleted): "
                    f"{missing[:8]}{'...' if len(missing) > 8 else ''}"
                )
            return self._payload_rows(np.asarray([self._slot_of[int(i)] for i in indices], np.int64))

    def sample_payload_rows(self, cap: int) -> np.ndarray:
        """Up to ``cap`` alive payload rows, float32 on the host (int8 rows
        dequantized by their scale): evenly strided over the live slots
        and gathered on the device, so the readback is ``cap`` rows plus
        the id column whatever the capacity. `LSHRS.retrain` fits on it."""
        if cap <= 0:
            raise ValueError("cap must be > 0")
        with self._lock:
            if not self.store_vectors:
                raise RuntimeError("sample_payload_rows requires store_vectors=True")
            alive = np.flatnonzero(self._used_ids() >= 0)
            if alive.size > cap:
                alive = alive[(np.arange(cap) * (alive.size / cap)).astype(np.int64)]
            return self._payload_rows(alive)

    def _used_ids(self) -> np.ndarray:
        """The id column of the used slots (tombstones -1), on the host."""
        return self._ids[: self._size].cpu().numpy()

    def _payload_rows(self, slots: np.ndarray) -> np.ndarray:
        """Payload rows at ``slots``, float32 on the host (int8 rows
        dequantized by their scale), gathered on the device."""
        idx = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        rows = self._payload[idx].to(torch.float32)
        if self._pscale is not None:
            rows = rows * self._pscale[idx][:, None]
        return rows.cpu().numpy()

    # ------------------------------------------------------------------
    # bucket-level API and maintenance
    # ------------------------------------------------------------------

    def batch_add(self, operations: Sequence[BucketOperation]) -> None:
        """Bucket-op ingestion: stages per-band ops until a vector's band
        set is complete, then appends the assembled signature row."""
        if not operations:
            return
        ready_ids: list[int] = []
        ready_words: list[np.ndarray] = []
        with self._lock:
            for band_id, hash_val, index in operations:
                bands = self._pending_ops.setdefault(int(index), {})
                bands[int(band_id)] = bytes(hash_val)
                if len(bands) == self.num_bands:
                    ready_ids.append(int(index))
                    ready_words.append(band_bytes_to_words(
                        tuple(bands[b] for b in range(self.num_bands)),
                        rows_per_band=self.rows_per_band,
                    ))
                    del self._pending_ops[int(index)]
        if ready_ids:
            if self.store_vectors:
                raise RuntimeError(
                    "bucket-level batch_add cannot carry payload vectors; "
                    "use add_signature_batch with store_vectors=True"
                )
            self.add_signature_batch(ready_ids, np.stack(ready_words))

    def add_to_bucket(self, band_id: int, hash_val: bytes, index: int) -> None:
        self.batch_add([(band_id, hash_val, index)])

    def get_bucket(self, band_id: int, hash_val: bytes) -> set[int]:
        """Enumerate one implicit band bucket: the alive ids whose band
        ``band_id`` words equal ``hash_val`` (a compare over the band on
        the device)."""
        if not 0 <= band_id < self.num_bands:
            raise ValueError(f"band_id must be in [0, {self.num_bands})")
        with self._lock:
            if self._size == 0:
                return set()
            w = self.words // self.num_bands
            q_band = band_bytes_to_words((bytes(hash_val),), rows_per_band=self.rows_per_band)
            match = _band_bucket(
                self._sig_t[band_id * w : (band_id + 1) * w], self._ids,
                as_words(q_band, self.device),
            )
            ids = self._ids[match]
        return set(ids.cpu().numpy().tolist())

    def remove_indices(self, indices: Iterable[int]) -> None:
        """Tombstone the slots holding ``indices`` (their id becomes -1).

        With ``dedupe`` the host id -> slot map finds each slot; without
        it every slot whose id is listed is tombstoned (an id stored twice
        goes twice). Ids not present are ignored. The tie keys are marked
        stale, so every engine's key bias sees the dead slots.
        """
        to_remove = [int(i) for i in indices]
        if not to_remove:
            return
        with self._lock:
            for i in to_remove:
                self._pending_ops.pop(i, None)
            if self._slot_of is not None:
                slots = [self._slot_of.pop(i) for i in to_remove if i in self._slot_of]
                if not slots:
                    return
                self._ids[torch.as_tensor(slots, device=self.device)] = -1
                self._tombstones += len(slots)
            else:
                dels = torch.as_tensor(
                    np.unique(np.asarray(to_remove, dtype=np.int64)), device=self.device
                )
                hit = torch.isin(self._ids, dels) & (self._ids >= 0)
                self._ids[hit] = -1
                self._tombstones += int(hit.sum())
            self._refresh_ranks()

    def compact(self) -> int:
        """Reclaim tombstoned slots by rebuilding the dense prefix (one
        snapshot, one append; capacity is kept). Returns the number of
        slots reclaimed."""
        with self._lock:
            reclaimed = self._tombstones
            if reclaimed == 0:
                return 0
            self.load_state_arrays(self.state_arrays())
        return reclaimed

    def close(self) -> None:
        """Drop the device tensors (the store is unusable afterwards)."""
        with self._lock:
            self._sig_t = self._sig_rows = self._ids = self._tie = self._ranks = None
            self._block_tie = None
            self._planes = self._refine = self._bucket_index = None
            self._payload = self._pnorm = self._pscale = None

    def clear(self) -> None:
        with self._lock:
            self._alloc(self._capacity)
            self._size = 0
            self._tombstones = 0
            self._generation += 1
            if self._slot_of is not None:
                self._slot_of.clear()
            self._pending_ops.clear()

    # ------------------------------------------------------------------
    # retuning: a new banding or hash, rebuilt from the resident payload
    # ------------------------------------------------------------------

    def _check_banding(self, num_bands: int, rows_per_band: int) -> None:
        if (num_bands + 1) * self.chunk >= 2**31:
            raise ValueError("num_bands * chunk_size too large for exact top-k keys")
        if self.hamming_cascade and not self.hamming_cascade < num_bands * rows_per_band:
            raise ValueError(
                f"hamming_cascade={self.hamming_cascade} must stay below num_perm "
                f"(= {num_bands * rows_per_band}) after a rehash"
            )

    def _set_banding(self, num_bands: int, rows_per_band: int) -> None:
        """Adopt a new banding scheme (callers rebuild the signatures)."""
        self._check_banding(num_bands, rows_per_band)
        self.num_bands = num_bands
        self.rows_per_band = rows_per_band
        self.words = num_bands * words_per_band(rows_per_band)
        self._refine_narrow_r = narrow_refine_r(rows_per_band)

    def _reset_banding(self, num_bands: int, rows_per_band: int) -> None:
        """Re-allocate empty state under a new banding (the host-hash
        rehash path of `LSHRS` re-appends the payload afterwards)."""
        with self._lock:
            self._set_banding(num_bands, rows_per_band)
            self.clear()

    def rehash(
        self,
        proj_t,
        *,
        num_bands: int,
        rows_per_band: int,
        hash_family: str = "gaussian",
        block_slots: int = 1 << 17,
    ) -> None:
        """Rebuild every stored signature from the resident payload under
        a new banding, seed or hash family, on the device: no vector is
        re-streamed.

        Args:
            proj_t: the new hasher's device operand
                (`LSHHasher.device_projection`): a ``(dim, num_perm)``
                matrix, or the structured / cross-polytope diagonals.
            num_bands / rows_per_band: the new banding.
            hash_family: the family of ``proj_t``.
            block_slots: rows hashed per step (the largest power of two
                dividing the capacity, at most this; cross-polytope steps
                keep their rotated coordinates near 2 GiB).

        Signatures derive from the payload at its stored precision: exact
        for a float32 payload (equal to a fresh build); int8 rows hash as
        their raw integers (a positive per-row scale changes no sign), bf16
        rows upcast. Ids, payload, tombstones and the id -> slot map stay;
        the bitplanes, the refine table and the bucket index are dropped
        and rebuilt lazily, and the generation moves on, so serving
        closures taken before raise as stale.
        """
        with self._lock:
            if self._payload is None:
                raise RuntimeError(
                    "rehash requires store_vectors=True: signatures are "
                    "rebuilt from the resident payload"
                )
            self._check_banding(num_bands, rows_per_band)
            sig_rows = self._rehashed_rows(
                proj_t, num_bands=num_bands, rows_per_band=rows_per_band,
                hash_family=hash_family, block_slots=block_slots,
            )
            self._set_banding(num_bands, rows_per_band)
            self._finish_rehash(sig_rows)

    def _rehashed_rows(
        self, proj_t, *, num_bands: int, rows_per_band: int, hash_family: str, block_slots: int
    ) -> torch.Tensor:
        """Every slot's signature row under the new hash, ``(capacity, BW)``
        int32, hashed from the payload block by block (see :meth:`rehash`);
        the store itself is left unchanged."""
        cap = self._capacity
        if hash_family == "crosspolytope":
            dpad = 1 << (int(self.dim) - 1).bit_length()
            block_slots = min(block_slots, max(4096, (1 << 29) // max(1, num_bands * dpad)))
        step = min(_next_pow2(block_slots), cap)
        while cap % step:
            step //= 2
        proj_t = torch.as_tensor(proj_t, dtype=torch.float32).to(self.device)
        words = num_bands * words_per_band(rows_per_band)
        sig_rows = torch.empty((cap, words), dtype=torch.int32, device=self.device)
        for off in range(0, cap, step):
            sig_rows[off : off + step] = hash_words(
                self._payload[off : off + step].to(torch.float32), proj_t,
                num_bands=num_bands, rows_per_band=rows_per_band, hash_family=hash_family,
            )
        return sig_rows

    def _finish_rehash(self, sig_rows: torch.Tensor) -> None:
        """Install rebuilt signature rows and drop what derives from the
        old ones: the bitplanes (full or the cascade's prefix), the refine
        table, the bucket index; the tie keys are recomputed."""
        self._sig_rows = sig_rows
        self._sig_t = sig_rows.T.contiguous()
        self._planes = None
        self._refresh_ranks()

    # ------------------------------------------------------------------
    # introspection / persistence
    # ------------------------------------------------------------------

    def __len__(self) -> int:
        return self._size - self._tombstones

    def stats(self) -> dict:
        return {
            "backend": "device",
            "device": str(self.device),
            "size": self._size,
            "alive": self._size - self._tombstones,
            "tombstones": self._tombstones,
            "capacity": self._capacity,
            "chunk_size": self.chunk,
            "query_mode": self.query_mode,
            "hamming_storage": self.hamming_storage if self.enable_hamming else None,
            "hamming_cascade": self.hamming_cascade or None,
            # The bytes held, padding columns included.
            "hamming_plane_bytes": self._planes.numel() if self._planes is not None else 0,
            "bucket_overflows": self._bucket_overflows,
            "fast_path": self._use_grouped(),
            "signature_bytes": self._capacity * self.words * 4,
            # Payload rows plus, for int8, the 4-byte per-row scale.
            "payload_bytes": (
                self._capacity * self.dim * self._payload.element_size()
                + (self._capacity * 4 if self._pscale is not None else 0)
                if self._payload is not None
                else 0
            ),
            # Introspection never raises: a pinned "gather" the geometry
            # cannot take errors only when a rerank is issued.
            "rerank_engine": (
                (
                    self._resolve_rerank_engine(None, None)[0]
                    if self.rerank_engine != "gather" or self._gather_usable()
                    else "gather (unusable: needs the grouped fast path)"
                )
                if self.store_vectors
                else None
            ),
            "rerank_truncations": self._rerank_truncations,
        }

    def state_arrays(self) -> dict[str, np.ndarray]:
        """Dense host snapshot of the used slots: ``ids`` (n,) int32, ``sig``
        (n, BW) uint32 and, with ``store_vectors``, ``payload`` (n, dim)
        float32 — the reference package's format (bf16 rows export exactly;
        int8 rows export dequantized and re-quantize to the same rows). The
        arrays are copies: later in-place writes (upserts, deletes) leave a
        snapshot unchanged, on the CPU too."""
        with self._lock:
            n = self._size
            out = {
                "ids": self._ids[:n].to("cpu", copy=True).numpy(),
                "sig": words_to_numpy(self._sig_rows[:n].to("cpu", copy=True)),
            }
            if self._payload is not None:
                rows = self._payload[:n].to(torch.float32)
                if self._pscale is not None:
                    rows = rows * self._pscale[:n, None]
                out["payload"] = rows.to("cpu", copy=True).numpy()
            return out

    def load_state_arrays(self, state: dict[str, np.ndarray]) -> None:
        """Restore from a :meth:`state_arrays` snapshot (replaces contents;
        tombstoned slots are dropped); snapshots from the reference package
        load too."""
        with self._lock:
            self.clear()
            ids = np.asarray(state["ids"], dtype=np.int32)
            alive = ids >= 0
            self.add_signature_batch(
                ids[alive],
                np.asarray(state["sig"], dtype=np.uint32)[alive],
                np.asarray(state["payload"], dtype=np.float32)[alive]
                if "payload" in state and self.store_vectors
                else None,
            )
