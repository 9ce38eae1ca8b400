"""Slot-sharded device signature store.

The slot axis of the store splits into ``n_shards`` contiguous blocks over
a 1-D mesh (`lshrs_tpu_torch.parallel.mesh`): shard ``i`` holds global
slots ``[i * L, (i + 1) * L)`` with ``L = capacity / n_shards``, the
reference's placement (`lshrs_tpu/parallel/sharded.py`). Each shard is a
`DeviceStore` of ``L`` slots on its own device that owns its tensors
outright (transposed words, rows, ids, tie keys, bitplanes, payload,
refine table), all contiguous, so every kernel (B1, B2, B3) runs on a
shard's whole block as it would on an unsharded store of ``L`` slots; a
shard the grouped engines cannot take (past the int32 key ceiling, more
than 64 bands) ranks through its own store's chunked route, with
shard-local chunk ranks, as the reference's ``_sharded_*`` cores do. A
query runs as:

    query words to every shard  ->  shard-local scan + exact local top-k
                                ->  the (n_shards, Q, k) lists to the first
                                    device, one exact merge

The merge key is the unsharded engine's total order (count desc, id asc;
Hamming asc, id asc; asymmetric dots desc, id asc; cosine desc, id asc),
and each shard's keys are absolute, so collision, Hamming and the top-p
engines equal the unsharded store id for id. Two engines keep the
reference's per-shard contracts instead: the cascade's refine pool and
the gather engine's candidate budget apply per shard (a union pool
``n_shards`` times deeper), and asymmetric selection takes its shift from
the shard's rows. Tie keys are shard-local (`global_tie_core` of each
shard's ids), as the reference computes them under ``shard_map``.

Shards on one device run one after another on the current stream. The
merge moves ``O(n_shards * Q * k)`` values, independent of the index
size: the counterpart of the reference's one ``all_gather``.

Host bookkeeping (size, tombstones, the id -> slot map, the generation
that serving closures and filters check) stays here; appends write each
shard's part of the batch into its block, growth re-splits every block
(capacity at least doubles, so an old block lands whole in one new one),
and checkpoints concatenate the shards in slot order: the on-disk format
is the unsharded store's.
"""

from __future__ import annotations

from collections.abc import Iterable

import numpy as np
import torch

from lshrs_tpu_torch.ops.asymmetric import QMAX
from lshrs_tpu_torch.ops.hamming import merge_hamming_pools
from lshrs_tpu_torch.ops.rerank import merge_topp_pools
from lshrs_tpu_torch.ops.scan import merge_topk_pools
from lshrs_tpu_torch.parallel.mesh import Mesh
from lshrs_tpu_torch.storage.device import DeviceStore, _next_pow2
from lshrs_tpu_torch.storage.filter import as_filter
from lshrs_tpu_torch.utils.trace import span

__all__ = ["ShardedDeviceStore"]


class ShardedDeviceStore(DeviceStore):
    """`DeviceStore` whose slots shard over a mesh, merged exactly.

    Args:
        mesh: a 1-D mesh (`make_mesh`) with a power-of-two device count;
            a device may repeat (one card standing in for several shards).
            The store lives on ``mesh.devices[0]``: queries arrive and
            results merge there. Everything else as `DeviceStore` (its
            ``device`` is the mesh's). Capacity stays a power of two of at
            least ``n_shards * chunk_size``, so every shard holds
            ``capacity / n_shards`` slots, a whole number of chunks.
    """

    def __init__(self, *, mesh: Mesh, **kwargs) -> None:
        n = len(mesh.devices)
        if n == 0 or n & (n - 1):
            raise ValueError("ShardedDeviceStore requires a power-of-two device count")
        if kwargs.pop("device", None) is not None:
            raise ValueError("a sharded store lives on its mesh: leave device= out")
        self.mesh = mesh
        self.axis = mesh.axis_name
        self.n_shards = n
        self._shards: list[DeviceStore] = []
        kwargs.setdefault("initial_capacity", 1 << 14)
        kwargs["initial_capacity"] = max(
            kwargs["initial_capacity"], n * kwargs.get("chunk_size", 2048)
        )
        super().__init__(device=mesh.devices[0], **kwargs)

    # -- placement -----------------------------------------------------------

    def _alloc(self, cap: int) -> None:
        rows = cap // self.n_shards
        self._shards = [self._new_shard(dev, rows) for dev in self.mesh.devices]
        # The shards hold every tensor; the sharded store holds none.
        self._sig_t = self._sig_rows = self._ids = self._tie = None
        self._refine = self._bucket_index = self._planes = None
        self._payload = self._pnorm = self._pscale = None
        self._ranks_dirty = False

    def _new_shard(self, device: torch.device, rows: int) -> DeviceStore:
        shard = DeviceStore(
            num_bands=self.num_bands, rows_per_band=self.rows_per_band, dim=self.dim,
            store_vectors=self.store_vectors, initial_capacity=rows, chunk_size=self.chunk,
            group_size=self.group, dedupe=False, enable_hamming=self.enable_hamming,
            hamming_storage=self.hamming_storage, hamming_cascade=self.hamming_cascade,
            hamming_cascade_refine=self.hamming_cascade_refine,
            payload_dtype=self.payload_dtype, rerank_engine=self.rerank_engine,
            rerank_candidates=self.rerank_candidates, device=device,
        )
        assert shard._capacity == rows, (shard._capacity, rows)
        return shard

    def _local_rows(self) -> int:
        return self._capacity // self.n_shards

    def _blocks(self, lo: int, hi: int):
        """``(shard, first, end)`` for each shard holding global slots of
        ``[lo, hi)``: its part ``[first, end)`` of the range."""
        rows = self._local_rows()
        for i in range(lo // rows, -(-hi // rows)):
            yield i, max(lo, i * rows), min(hi, (i + 1) * rows)

    def _refresh(self, shards: Iterable[int]) -> None:
        """Drop the derived state of the ``shards`` a mutation touched and
        move the generation on (serving closures and filters check it)."""
        for i in shards:
            self._shards[i]._refresh_ranks()
        self._generation += 1

    def _refresh_ranks(self) -> None:
        self._refresh(range(self.n_shards))

    def _ensure_ranks(self) -> None:
        for shard in self._shards:
            shard._ensure_ranks()

    def _ensure_planes(self) -> None:
        for shard in self._shards:
            shard._ensure_planes()

    def _set_banding(self, num_bands: int, rows_per_band: int) -> None:
        super()._set_banding(num_bands, rows_per_band)
        for shard in self._shards:
            shard._set_banding(num_bands, rows_per_band)

    # -- geometry: each shard's own ------------------------------------------

    def _use_grouped(self) -> bool:
        return self._shards[0]._use_grouped()

    def _rerank_cost_rows(self) -> int:
        # Every shard scans and gathers only its block.
        return self._local_rows()

    def _expected_candidates(self) -> float:
        # The gather budget applies per shard.
        return super()._expected_candidates() / self.n_shards

    def _topp_dev_batch(self, eng: str, mc: int) -> int:
        return self._shards[0]._topp_dev_batch(eng, mc)

    def _query_dev_batch(self) -> int:
        """Queries per slice of a serving batch: one shard's group-max keys
        ``(Q, L / group)`` int32 stay near 2 GiB (8,192 queries at 2^22
        rows per shard, group 64). A chunked shard bounds its own steps
        (`lshrs_tpu_torch.ops.scan.chunk_step`)."""
        groups = self._local_rows() // min(self.group, self._local_rows())
        return max(1, (1 << 31) // (4 * groups))

    # -- writes ----------------------------------------------------------------

    def _append(self, ids32: np.ndarray, words: torch.Tensor, vecs: torch.Tensor | None) -> None:
        """Tail append: each shard writes the rows of the batch that fall in
        its block, ``O(batch)`` work whatever the capacity."""
        n = ids32.size
        pad = _next_pow2(n)  # the reference's per-batch reservation
        if self._size + pad > self._capacity:
            with span("lshrs.store.grow"):
                self._grow(max(2 * self._capacity, _next_pow2(self._size + pad)))
        off, rows = self._size, self._local_rows()
        ids = torch.from_numpy(ids32)
        touched = []
        for i, lo, hi in self._blocks(off, off + n):
            shard, a, b = self._shards[i], lo - off, hi - off
            dev = shard.device
            shard._write_slots(
                lo - i * rows, ids[a:b].to(dev), words[a:b].to(dev),
                None if vecs is None else vecs[a:b].to(dev),
            )
            shard._size = max(shard._size, hi - i * rows)
            touched.append(i)
        if self._slot_of is not None:
            self._slot_of.update(zip(ids32.tolist(), range(off, off + n)))
        self._size += n
        self._refresh(touched)

    def _overwrite(self, slots: np.ndarray, words: torch.Tensor, vecs: torch.Tensor | None) -> None:
        rows = self._local_rows()
        owner = slots // rows
        for i in np.unique(owner).tolist():
            shard, mine = self._shards[i], owner == i
            pick = torch.as_tensor(np.flatnonzero(mine), device=words.device)
            shard._overwrite(
                slots[mine] - i * rows, words[pick].to(shard.device),
                None if vecs is None else vecs[pick].to(shard.device),
            )
        self._generation += 1

    def _grow(self, new_cap: int) -> None:
        """Re-split at the new capacity: old shard ``i``'s used block moves
        whole into new shard ``i * L_old // L_new`` (capacity at least
        doubles), keeping every global slot; bitplanes are kept."""
        new_cap = _next_pow2(max(new_cap, self.n_shards * self.chunk))
        old, old_rows = self._shards, self._local_rows()
        self._alloc(new_cap)
        rows = new_cap // self.n_shards
        if old[0]._planes is not None:
            width = old[0]._planes.shape[1]
            for shard in self._shards:
                shard._planes = torch.zeros((rows, width), dtype=torch.int8, device=shard.device)
        for i, src in enumerate(old):
            if src._size:
                j, at = divmod(i * old_rows, rows)
                _copy_rows(self._shards[j], at, src, src._size)
        self._capacity = new_cap
        self._refresh_ranks()

    def remove_indices(self, indices: Iterable[int]) -> None:
        """Tombstone the slots holding ``indices`` (see
        `DeviceStore.remove_indices`), each in its own shard."""
        to_remove = [int(i) for i in indices]
        if not to_remove:
            return
        with self._lock:
            for i in to_remove:
                self._pending_ops.pop(i, None)
            if self._slot_of is not None:
                slots = np.asarray(
                    [self._slot_of.pop(i) for i in to_remove if i in self._slot_of], np.int64
                )
                if not slots.size:
                    return
                rows = self._local_rows()
                owner = slots // rows
                touched = np.unique(owner).tolist()
                for i in touched:
                    shard = self._shards[i]
                    local = torch.as_tensor(slots[owner == i] - i * rows, device=shard.device)
                    shard._ids[local] = -1
                self._tombstones += int(slots.size)
            else:
                touched = range(self.n_shards)
                for shard in self._shards:
                    before = shard._tombstones
                    shard.remove_indices(to_remove)
                    self._tombstones += shard._tombstones - before
            self._refresh(touched)

    def rehash(
        self,
        proj_t,
        *,
        num_bands: int,
        rows_per_band: int,
        hash_family: str = "gaussian",
        block_slots: int = 1 << 17,
    ) -> None:
        """`DeviceStore.rehash`, shard by shard: every shard hashes its own
        payload block; the new banding is adopted only once every block is
        hashed, so a failure leaves the store as it was."""
        with self._lock:
            if not self.store_vectors:
                raise RuntimeError(
                    "rehash requires store_vectors=True: signatures are "
                    "rebuilt from the resident payload"
                )
            self._check_banding(num_bands, rows_per_band)
            rows = [
                shard._rehashed_rows(
                    proj_t, num_bands=num_bands, rows_per_band=rows_per_band,
                    hash_family=hash_family, block_slots=block_slots,
                )
                for shard in self._shards
            ]
            self._set_banding(num_bands, rows_per_band)
            for shard, sig_rows in zip(self._shards, rows):
                shard._finish_rehash(sig_rows)
            self._generation += 1

    def close(self) -> None:
        with self._lock:
            for shard in self._shards:
                shard.close()
            self._shards = []

    # -- queries ---------------------------------------------------------------

    def _shard_columns(self, where) -> list:
        """Each shard's ``where=`` argument: None, or its filtered ``(ids,
        tie)`` columns from `IdFilter.device_state` (masked from the shard's
        own tie, cached per generation of this store)."""
        if where is None:
            return [None] * self.n_shards
        ids, tie = as_filter(where).device_state(self)
        return list(zip(ids, tie))

    def _gathered(self, parts) -> tuple[torch.Tensor, ...]:
        """Per-shard ``(Q, k_i)`` results, concatenated on the first device
        along the last axis, column by column."""
        return tuple(torch.cat([p[c].to(self.device) for p in parts], dim=-1) for c in range(len(parts[0])))

    def _k_eff(self, k: int) -> int:
        return max(1, min(k, self._capacity))

    def _query_topk_dev(
        self, qw: torch.Tensor, k: int, probes: int = 1, where=None, *, bucket: bool = True
    ):
        """Collision top-k: every shard's scan (kernel B1), one merge by
        (count desc, id asc). ``query_mode="bucket"`` scans here, as the
        reference's sharded store does."""
        parts = [
            shard._query_topk_dev(qw.to(shard.device), k, probes, cols, bucket=False)
            for shard, cols in zip(self._shards, self._shard_columns(where))
        ]
        return merge_topk_pools(*self._gathered(parts), k=self._k_eff(k))

    def _query_hamming_dev(self, qw: torch.Tensor, k: int, where=None):
        """Hamming top-k (B2 on planes, B3 on packed words, or the cascade
        with its refine pool per shard), merged by (distance asc, id asc)."""
        p = self.num_bands * self.rows_per_band
        parts = [
            shard._query_hamming_dev(qw.to(shard.device), k, cols)
            for shard, cols in zip(self._shards, self._shard_columns(where))
        ]
        return merge_hamming_pools(*self._gathered(parts), p=p, k=self._k_eff(k))

    def _query_asymmetric_dev(self, qc: torch.Tensor, k: int, where=None, qmax: int = QMAX):
        """Asymmetric top-k (B2 at each shard's own shift, exact re-rank),
        merged by (dots desc, id asc): the dots are absolute."""
        self._require_asymmetric_planes()
        offset = self.num_bands * self.rows_per_band * qmax
        parts = [
            shard._query_asymmetric_dev(qc.to(shard.device), k, cols, qmax)
            for shard, cols in zip(self._shards, self._shard_columns(where))
        ]
        dots, ids = self._gathered(parts)
        scaled, m_ids = merge_topk_pools(
            torch.where(ids >= 0, dots + offset + 1, 0), ids, k=self._k_eff(k)
        )
        return torch.where(m_ids >= 0, scaled - offset - 1, -(offset + 1)), m_ids

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
        """`DeviceStore.snapshot_query_fn` over the shards, serving a batch
        ``dev_batch`` queries at a time (default: :meth:`_query_dev_batch`,
        one shard's group-max keys near 2 GiB)."""
        if dev_batch is None:
            dev_batch = self._query_dev_batch()
        return super().snapshot_query_fn(
            k, wire=wire, dev_batch=dev_batch, mode=mode, probes=probes, where=where
        )

    def query_counts(self, qwords, *, where=None) -> tuple[np.ndarray, np.ndarray]:
        """Each shard's counts and ids, concatenated in slot order."""
        with self._lock:
            parts = [
                shard.query_counts(qwords, where=cols)
                for shard, cols in zip(self._shards, self._shard_columns(where))
            ]
        return np.concatenate([c for c, _ in parts], axis=1), np.concatenate([i for _, i in parts])

    def query_nnz(self, qwords, *, where=None) -> np.ndarray:
        with self._lock:
            return sum(
                shard.query_nnz(qwords, where=cols)
                for shard, cols in zip(self._shards, self._shard_columns(where))
            )

    def query_topp(
        self, qwords, qvec, max_out: int, *, where=None
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Every shard's top-p of one query, merged by (cosine desc, id asc)."""
        self._require_payload()
        with self._lock:
            if self._size == 0:
                return np.full(max_out, -1, np.int32), np.zeros(max_out, np.float32), 0
            out = max(1, min(max_out, self._capacity))
            parts = [
                shard.query_topp(qwords, qvec, min(out, self._local_rows()), where=cols)
                for shard, cols in zip(self._shards, self._shard_columns(where))
            ]
        ids, sims = merge_topp_pools(
            torch.from_numpy(np.concatenate([p[0] for p in parts]))[None],
            torch.from_numpy(np.concatenate([p[1] for p in parts]))[None], out=out,
        )
        return ids[0].numpy(), sims[0].numpy(), sum(p[2] for p in parts)

    def _topp_dev(
        self, qw, qv, *, eng: str, mc: int, max_out: int, dev_batch: int,
        probes: int = 1, where=None,
    ):
        """Top-p rerank on every shard (the gather engine's budget ``mc``
        per shard), merged by (cosine desc, id asc); ``n`` adds up and
        ``exact`` holds where it holds on every shard."""
        parts = []
        for shard, cols in zip(self._shards, self._shard_columns(where)):
            dev = shard.device
            ids, sims, n, exact = shard._topp_dev(
                qw.to(dev), qv.to(dev), eng=eng, mc=mc,
                max_out=min(max_out, self._local_rows()), dev_batch=dev_batch,
                probes=probes, where=cols,
            )
            parts.append((ids, sims, n[:, None], exact[:, None]))
        ids, sims, n, exact = self._gathered(parts)
        ids, sims = merge_topp_pools(ids, sims, out=max_out)
        return ids, sims, n.sum(dim=1, dtype=torch.int32), exact.all(dim=1)

    # -- reads -------------------------------------------------------------------

    def _payload_rows(self, slots: np.ndarray) -> np.ndarray:
        out = np.empty((slots.size, self.dim), np.float32)
        rows = self._local_rows()
        owner = slots // rows
        for i in np.unique(owner).tolist():
            mine = owner == i
            out[mine] = self._shards[i]._payload_rows(slots[mine] - i * rows)
        return out

    def _used_ids(self) -> np.ndarray:
        return np.concatenate([s._ids[: s._size].cpu().numpy() for s in self._shards])

    def get_bucket(self, band_id: int, hash_val: bytes) -> set[int]:
        with self._lock:
            return set().union(*(shard.get_bucket(band_id, hash_val) for shard in self._shards))

    def stats(self) -> dict:
        out = super().stats()
        out.update(
            backend="device-sharded",
            n_shards=self.n_shards,
            rows_per_shard=self._local_rows(),
            hamming_plane_bytes=sum(
                s._planes.numel() for s in self._shards if s._planes is not None
            ),
            payload_bytes=sum(s.stats()["payload_bytes"] for s in self._shards),
        )
        return out

    def state_arrays(self) -> dict[str, np.ndarray]:
        """The shards' used slots concatenated in slot order: the unsharded
        store's (and the reference's) format."""
        with self._lock:
            parts = [s.state_arrays() for s in self._shards if s._size] or [
                self._shards[0].state_arrays()
            ]
            return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}


def _copy_rows(dst: DeviceStore, at: int, src: DeviceStore, n: int) -> None:
    """Copy ``src``'s first ``n`` slots into ``dst`` at slot ``at``."""
    dev = dst.device
    dst._sig_t[:, at : at + n] = src._sig_t[:, :n].to(dev)
    for name in ("_sig_rows", "_ids", "_planes", "_payload", "_pnorm", "_pscale"):
        part = getattr(src, name)
        if part is not None:
            getattr(dst, name)[at : at + n] = part[:n].to(dev)
    dst._size = max(dst._size, at + n)
