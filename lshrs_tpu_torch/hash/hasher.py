"""Banded LSH hasher: the gaussian, structured, learned and
cross-polytope families, with multi-probe query hashing.

All ``num_bands`` projection matrices of the gaussian family are one
``(num_perm, dim)`` float32 array drawn from a single seeded NumPy stream
— the same draw as the reference package, so the projections are
identical for a given seed. The device keeps its transpose ``(dim,
num_perm)``, so a batch of vectors is hashed with one matmul ``(n, dim) @
(dim, num_perm)`` followed by a sign bitpack into int32 words
(`lshrs_tpu_torch.ops.bitpack`). The learned family
(`lshrs_tpu_torch.hash.itq`) is the same machinery with a fitted matrix.
The structured family replaces the matmul by seeded FWHT rotations
(`lshrs_tpu_torch.hash.fwht`), bit-identical on the host (native C or
NumPy) and on the device; the cross-polytope family
(`lshrs_tpu_torch.hash.crosspolytope`) emits one signed-argmax symbol per
band from the same rotations.

The device matmul runs in full float32: the sign of near-zero projections
decides hash bits, so TF32 matmuls must be off (PyTorch's default); the
device path raises rather than hash with TF32 on.

Every device function here is plain PyTorch on the tensor's device: the
reference computes the FWHT, the argmax symbols and the probe
construction in plain ``jnp``, outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from lshrs_tpu_torch._config.config import HashSignatures
from lshrs_tpu_torch.hash.crosspolytope import (
    cp_bits_np,
    cp_bits_torch,
    cp_diags,
    cp_probe_bits_np,
    cp_probe_bits_torch,
    max_cp_probes,
    validate_cp_geometry,
)
from lshrs_tpu_torch.hash.fwht import (
    slice_rows,
    structured_coords_np,
    structured_coords_torch,
    structured_diags,
)
from lshrs_tpu_torch.ops.bitpack import (
    band_bytes_to_words,
    pack_bits_dense_np,
    pack_bits_to_words,
    pack_bits_to_words_np,
    words_per_band,
    words_to_band_bytes,
)

__all__ = ["LSHHasher", "hash_coords", "hash_words", "probe_words_from_coords"]


def _require_f32_matmul(x: torch.Tensor) -> None:
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: signature hashing "
            "needs full float32 matmuls (near-zero projections decide bits)"
        )


def hash_coords(
    x: torch.Tensor, operand: torch.Tensor, *, num_perm: int, hash_family: str = "gaussian"
) -> torch.Tensor:
    """``(n, dim)`` float32 -> ``(n, num_perm)`` float32 projection
    coordinates, the values whose signs are the hash bits (sign-bit
    families only).

    ``operand`` is `LSHHasher.device_projection`: the ``(dim, num_perm)``
    matrix of the gaussian and learned families (one full-float32 matmul),
    or the ``(nblocks, 3, dpad)`` diagonals of the structured family (the
    fixed-order FWHT, in slices of `lshrs_tpu_torch.hash.fwht.slice_rows`
    rows so the butterfly temporaries stay near 1 GiB).
    """
    if hash_family == "crosspolytope":
        raise ValueError(
            "the cross-polytope family has no per-bit projection coordinates"
        )
    if hash_family != "structured":
        _require_f32_matmul(x)
        return x @ operand
    step = slice_rows(operand.shape[2])
    if x.shape[0] <= step:
        return structured_coords_torch(x, operand, num_perm)
    return torch.cat([
        structured_coords_torch(x[i : i + step], operand, num_perm)
        for i in range(0, x.shape[0], step)
    ])


def hash_words(
    x: torch.Tensor,
    operand: torch.Tensor,
    *,
    num_bands: int,
    rows_per_band: int,
    hash_family: str = "gaussian",
) -> torch.Tensor:
    """``(n, dim)`` float32 -> ``(n, num_bands * W)`` int32 signature
    words on the device of ``x``, by the family's device formulation (see
    :func:`hash_coords`; cross-polytope: per-band rotation and
    signed-argmax symbol, `lshrs_tpu_torch.hash.crosspolytope.cp_bits_torch`).
    The store's fused build and the query hash both come through here, so
    stored and query signatures agree bit for bit."""
    if hash_family == "crosspolytope":
        bits = cp_bits_torch(x, operand, num_bands=num_bands, rows_per_band=rows_per_band)
    else:
        bits = hash_coords(
            x, operand, num_perm=num_bands * rows_per_band, hash_family=hash_family
        ) > 0
    return pack_bits_to_words(bits, num_bands=num_bands, rows_per_band=rows_per_band)


def probe_words_from_coords(
    coords: torch.Tensor, *, num_bands: int, rows_per_band: int, n_probes: int
) -> torch.Tensor:
    """Coords ``(n, P)`` -> multi-probe words ``(n, n_probes, BW)`` int32.

    Probe 0 is the plain signature (``coords > 0``); probe ``t >= 1``
    flips, in EVERY band, the band's ``t``-th smallest-|coordinate| bit —
    the bit whose hyperplane the query sits closest to, i.e. the most
    likely single-bit hash miss (query-directed probing, Lv et al. 2007,
    restricted to the dominant single-bit perturbations, applied
    band-uniformly so downstream shapes stay static). Equal margins order
    by ascending bit index (a stable argsort: the reference's
    ``lax.top_k`` rule, which ``torch.topk`` does not keep).
    """
    n = coords.shape[0]
    r = rows_per_band
    bits = coords > 0

    def pack(b: torch.Tensor) -> torch.Tensor:
        return pack_bits_to_words(b, num_bands=num_bands, rows_per_band=r)

    outs = [pack(bits)]
    if n_probes > 1:
        margins = coords.abs().reshape(n, num_bands, r)
        idx = torch.argsort(margins, dim=2, stable=True)[..., : n_probes - 1]
        bits3 = bits.reshape(n, num_bands, r)
        lanes = torch.arange(r, device=coords.device)
        for t in range(1, n_probes):
            onehot = idx[..., t - 1, None] == lanes
            outs.append(pack((bits3 ^ onehot).reshape(n, num_bands * r)))
    return torch.stack(outs, dim=1)


class LSHHasher:
    """Random-projection LSH hasher producing banded binary signatures.

    Attributes:
        num_bands: number of independent bands (hash tables).
        rows_per_band: hyperplanes (bits) per band.
        dim: expected input dimensionality.
        words_per_band: uint32 words per band signature, ``ceil(r / 32)``.
        hash_family: ``"gaussian"`` (dense seeded hyperplanes, one
            matmul per batch), ``"structured"`` (FWHT pseudo-random
            rotations, `lshrs_tpu_torch.hash.fwht` — ~13x fewer flops per
            vector, native C host path, and host/device bit parity by
            construction), ``"learned"`` (data-dependent hyperplanes
            fitted with `lshrs_tpu_torch.hash.itq` — same dense matmul
            machinery as gaussian, only the matrix differs; pass it via
            ``projection`` or assign ``projections`` afterwards) or
            ``"crosspolytope"`` (one signed-argmax symbol per band,
            `lshrs_tpu_torch.hash.crosspolytope`).
        projections: list of per-band ``(rows_per_band, dim)`` float32
            matrices (views into one contiguous array); assignable, for
            restore-from-disk. Gaussian and learned families.
        diagonals: the ``(nblocks, 3, dpad)`` +-1 diagonal array of the
            structured family (``(num_bands, 3, dpad)`` for cross-polytope);
            assignable, for restore-from-disk.
        device: where :meth:`hash_batch_words`,
            :meth:`hash_batch_probe_words` and :meth:`device_projection`
            live.
    """

    def __init__(
        self,
        num_bands: int,
        rows_per_band: int,
        dim: int,
        seed: int = 42,
        hash_family: str = "gaussian",
        projection: np.ndarray | None = None,
        *,
        device: str | torch.device = "cuda",
    ) -> None:
        if num_bands <= 0:
            raise ValueError("num_bands must be > 0")
        if rows_per_band <= 0:
            raise ValueError("rows_per_band must be > 0")
        if dim <= 0:
            raise ValueError("dim must be > 0")
        if hash_family not in ("gaussian", "structured", "learned", "crosspolytope"):
            raise ValueError(
                "hash_family must be 'gaussian', 'structured', 'learned' "
                "or 'crosspolytope'"
            )
        if projection is not None and hash_family != "learned":
            raise ValueError(
                "an explicit projection requires hash_family='learned'"
            )

        self.num_bands = num_bands
        self.rows_per_band = rows_per_band
        self.dim = dim
        self.words_per_band = words_per_band(rows_per_band)
        self.hash_family = hash_family
        self.device = torch.device(device)

        num_perm = num_bands * rows_per_band
        if hash_family == "structured":
            self._proj = None
            self._diags = structured_diags(seed, dim=dim, num_perm=num_perm)
        elif hash_family == "crosspolytope":
            validate_cp_geometry(dim, rows_per_band)
            self._proj = None
            self._diags = cp_diags(seed, dim=dim, num_bands=num_bands)
        elif projection is not None:
            p = np.asarray(projection, dtype=np.float32)
            if p.shape != (num_perm, dim):
                raise ValueError(
                    f"projection must have shape ({num_perm}, {dim}); "
                    f"received {tuple(p.shape)}"
                )
            self._proj = p.copy()
            self._diags = None
        else:
            # The "learned" family without an explicit matrix starts from
            # the same seeded draw as gaussian — persistence restore
            # constructs the hasher first and assigns the learned
            # ``projections`` afterwards (`LSHRS.load_from_disk`).
            rng = np.random.default_rng(seed)
            self._proj = rng.standard_normal((num_perm, dim)).astype(np.float32)
            self._diags = None
        self._proj_dev: torch.Tensor | None = None  # device operand, lazy

    # -- projections --------------------------------------------------------

    @property
    def projections(self) -> list[np.ndarray]:
        """Per-band projection matrices, reference-compatible layout."""
        if self._proj is None:
            raise ValueError(
                f"the {self.hash_family} hash family has no projection "
                "matrices; persist `diagonals` instead"
            )
        r = self.rows_per_band
        return [self._proj[b * r : (b + 1) * r] for b in range(self.num_bands)]

    @projections.setter
    def projections(self, matrices) -> None:
        if self.hash_family not in ("gaussian", "learned"):
            raise ValueError(
                "projections are assignable only on the gaussian and "
                "learned hash families"
            )
        mats = [np.asarray(m, dtype=np.float32) for m in matrices]
        if len(mats) != self.num_bands or any(
            m.shape != (self.rows_per_band, self.dim) for m in mats
        ):
            raise ValueError(
                "projections must be a sequence of "
                f"{self.num_bands} matrices of shape ({self.rows_per_band}, {self.dim})"
            )
        self._proj = np.concatenate(mats, axis=0)
        self._proj_dev = None  # re-upload lazily

    @property
    def projection_matrix(self) -> np.ndarray:
        """The fused ``(num_perm, dim)`` float32 projection matrix."""
        return self._proj

    @property
    def diagonals(self) -> np.ndarray:
        """The ±1 FWHT diagonals: ``(nblocks, 3, dpad)`` for the structured
        family, ``(num_bands, 3, dpad)`` for cross-polytope."""
        if self._diags is None:
            raise ValueError(
                f"the {self.hash_family} hash family has no diagonals; "
                "persist `projections` instead"
            )
        return self._diags

    @diagonals.setter
    def diagonals(self, arr) -> None:
        if self.hash_family not in ("structured", "crosspolytope"):
            raise ValueError(
                "diagonals are assignable only on the structured and "
                "cross-polytope hash families"
            )
        a = np.asarray(arr, dtype=np.float32)
        if a.shape != self._diags.shape or not np.all(np.abs(a) == 1.0):
            raise ValueError(
                f"diagonals must be +-1 of shape {self._diags.shape}; "
                f"received shape {a.shape}"
            )
        self._diags = a
        self._proj_dev = None  # re-upload lazily

    def device_projection(self) -> torch.Tensor:
        """The hash operand on :attr:`device` (uploaded once).

        ``(dim, num_perm)`` projection for the gaussian and learned
        families, the ``(nblocks, 3, dpad)`` diagonals for the structured
        one, ``(num_bands, 3, dpad)`` for cross-polytope. Feed this to
        `DeviceStore.add_vectors_batch` (with ``hash_family=
        hasher.hash_family``) for the device build; it is the same tensor
        the device query hash uses, so signatures agree bit for bit.
        """
        if self._proj_dev is None:
            src = self._diags if self._proj is None else self._proj.T.copy()
            self._proj_dev = torch.from_numpy(np.ascontiguousarray(src)).to(self.device)
        return self._proj_dev

    # -- single-vector / parity API -----------------------------------------

    def _coords_host(self, arr: np.ndarray) -> np.ndarray:
        """Host projection coordinates, ``(n, num_perm)`` float32.

        Sign-bit families only — cross-polytope signatures are argmax
        symbols, not coordinate signs, so there is no per-bit coordinate
        to expose (callers needing bits use :meth:`_bits_host`).
        """
        if self.hash_family == "crosspolytope":
            raise ValueError(
                "the cross-polytope family has no per-bit projection "
                "coordinates (signatures are signed-argmax symbols); "
                "coordinate-based estimators (asymmetric ranking) require "
                "a sign-bit hash family"
            )
        if self.hash_family == "structured":
            return structured_coords_np(
                arr, self._diags, self.num_bands * self.rows_per_band
            )
        return arr @ self._proj.T

    def _bits_host(self, arr: np.ndarray) -> np.ndarray:
        """Host signature bits, ``(n, num_perm)`` bool — family dispatch."""
        if self.hash_family == "crosspolytope":
            return cp_bits_np(
                arr,
                self._diags,
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
            )
        return self._coords_host(arr) > 0

    def hash_vector(self, vector: np.ndarray) -> HashSignatures:
        """Hash one vector to per-band packed byte signatures (host path)."""
        vec = self._validate_vector(vector)
        if self.hash_family in ("structured", "crosspolytope"):
            # FWHT association is fixed, so the batch path is bit-identical
            # for a single row (unlike BLAS, where GEMV and GEMM may round
            # differently — the gaussian family keeps the reference's GEMV).
            bits = self._bits_host(vec.reshape(1, -1))
        else:
            bits = (self._proj @ vec > 0).reshape(1, -1)
        words = pack_bits_to_words_np(
            bits, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )[0]
        return HashSignatures(
            words_to_band_bytes(
                words, num_bands=self.num_bands, rows_per_band=self.rows_per_band
            )
        )

    def hash_batch(self, vectors: np.ndarray) -> list[HashSignatures]:
        """Hash a 2-D batch to a list of `HashSignatures` (host path)."""
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2:
            raise ValueError("Batch input must be a 2D array")
        if arr.shape[1] != self.dim:
            raise ValueError(
                f"Expected vectors of dimension {self.dim}, received {arr.shape[1]}"
            )
        words = self.hash_batch_words_host(arr)
        return [
            HashSignatures(
                words_to_band_bytes(
                    row, num_bands=self.num_bands, rows_per_band=self.rows_per_band
                )
            )
            for row in words
        ]

    # -- batch word-signature paths (the hot path) ---------------------------

    def _validated(self, vectors) -> np.ndarray:
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.dim:
            raise ValueError(
                f"Expected vectors of shape (n, {self.dim}), received {tuple(arr.shape)}"
            )
        return arr

    def _to_device(self, vectors) -> torch.Tensor:
        """``(n, dim)`` float32 on :attr:`device`; a tensor already there
        is used as it is (no host round trip)."""
        if isinstance(vectors, torch.Tensor):
            x = vectors.to(self.device, torch.float32)
            if x.ndim != 2 or x.shape[1] != self.dim:
                raise ValueError(
                    f"Expected vectors of shape (n, {self.dim}), received {tuple(x.shape)}"
                )
            return x
        return torch.from_numpy(self._validated(vectors)).to(self.device)

    def hash_batch_words(self, vectors) -> torch.Tensor:
        """Device path: ``(n, dim)`` -> ``(n, num_bands * W)`` int32 words
        on :attr:`device` (:func:`hash_words`: one matmul, or the FWHT
        rotations, plus a bitpack); this is what ingestion and querying
        against the device store use."""
        return hash_words(
            self._to_device(vectors), self.device_projection(),
            num_bands=self.num_bands, rows_per_band=self.rows_per_band,
            hash_family=self.hash_family,
        )

    def hash_batch_words_host(self, vectors: np.ndarray) -> np.ndarray:
        """Host twin of :meth:`hash_batch_words` (oracle / bucket backends).

        Gaussian: one BLAS sgemm. Structured: the native FWHT path
        (`lshrs_tpu_torch/native/fwht.c`) when it loads, NumPy otherwise — all
        bit-identical (see `lshrs_tpu_torch.hash.fwht`).
        """
        arr = self._validated(vectors)
        bits = self._bits_host(arr)
        return pack_bits_to_words_np(
            bits, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )

    def hash_batch_coords_host(self, vectors: np.ndarray) -> np.ndarray:
        """Host projection coordinates, ``(n, num_perm)`` float32.

        The pre-sign values whose signs are the hash bits — the query-side
        operand of asymmetric ranking, which keeps the query's coordinates
        instead of quantising them to bits — and the margins of the
        multi-probe construction.
        """
        return self._coords_host(self._validated(vectors))

    def hash_batch_probe_words_host(
        self, vectors: np.ndarray, n_probes: int
    ) -> np.ndarray:
        """Multi-probe signature words, ``(n, n_probes, num_bands*W)`` uint32.

        Probe 0 is the plain signature; probe ``t >= 1`` flips, in every
        band, the band's ``t``-th smallest-|coordinate| bit — the bit the
        query is most likely to disagree with a near neighbor on
        (query-directed probing). ``n_probes == 1`` is exactly
        :meth:`hash_batch_words_host` with a probe axis.

        Equal margins order by ascending bit index (a stable argsort),
        on the host and on the device alike.
        """
        probe_bits = self._probe_bits_host(vectors, n_probes)
        n = probe_bits.shape[0]
        b, r = self.num_bands, self.rows_per_band
        out = np.empty((n, n_probes, b * self.words_per_band), np.uint32)
        for t in range(n_probes):
            out[:, t] = pack_bits_to_words_np(
                probe_bits[:, t], num_bands=b, rows_per_band=r
            )
        return out

    def hash_batch_probe_dense_host(
        self, vectors: np.ndarray, n_probes: int
    ) -> np.ndarray:
        """Multi-probe dense wire, ``(n, n_probes, B * ceil(r/8))`` uint8.

        The minimal-byte probe encoding for shipping multi-probe query
        batches to a remote store (`snapshot_query_fn(..., probes=T,
        wire="dense")` decodes it on device); same probe construction as
        :meth:`hash_batch_probe_words_host`.
        """
        probe_bits = self._probe_bits_host(vectors, n_probes)
        n = probe_bits.shape[0]
        b, r = self.num_bands, self.rows_per_band
        first = pack_bits_dense_np(probe_bits[:, 0], num_bands=b, rows_per_band=r)
        out = np.empty((n, n_probes, first.shape[1]), np.uint8)
        out[:, 0] = first
        for t in range(1, n_probes):
            out[:, t] = pack_bits_dense_np(
                probe_bits[:, t], num_bands=b, rows_per_band=r
            )
        return out

    @property
    def max_probes(self) -> int:
        """Largest valid multi-probe depth for this hash family.

        Sign families flip one of the band's ``r`` bits per probe; the
        cross-polytope family steps through the band's ``cp_dims`` ranked
        signed axes.
        """
        if self.hash_family == "crosspolytope":
            return max_cp_probes(self.rows_per_band)
        return self.rows_per_band

    def _validate_probes(self, n_probes: int) -> None:
        if n_probes < 1 or n_probes > self.max_probes:
            bound = (
                "cp_dims"
                if self.hash_family == "crosspolytope"
                else "rows_per_band"
            )
            raise ValueError(
                f"n_probes must be in [1, {bound}] "
                f"(= {self.max_probes}); received {n_probes}"
            )

    def _probe_bits_host(self, vectors: np.ndarray, n_probes: int) -> np.ndarray:
        """Host probe construction: ``(n, n_probes, num_perm)`` bool bits."""
        self._validate_probes(n_probes)
        arr = self._validated(vectors)
        if self.hash_family == "crosspolytope":
            return cp_probe_bits_np(
                arr,
                self._diags,
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
                n_probes=n_probes,
            )
        coords = self._coords_host(arr)
        n, num_perm = coords.shape
        b, r = self.num_bands, self.rows_per_band
        bits = coords > 0
        out = np.empty((n, n_probes, num_perm), bool)
        out[:, 0] = bits
        if n_probes > 1:
            order = np.argsort(np.abs(coords).reshape(n, b, r), axis=2, kind="stable")
            bits3 = bits.reshape(n, b, r)
            rows = np.arange(n)[:, None]
            cols = np.arange(b)[None, :]
            for t in range(1, n_probes):
                bt = bits3.copy()
                bt[rows, cols, order[:, :, t - 1]] ^= True
                out[:, t] = bt.reshape(n, num_perm)
        return out

    def hash_batch_probe_words(self, vectors, n_probes: int) -> torch.Tensor:
        """Device twin of :meth:`hash_batch_probe_words_host`:
        ``(n, n_probes, num_bands * W)`` int32 on :attr:`device`.

        The base probe comes from the same device formulation as
        :meth:`hash_batch_words`, so probe 0 agrees bit-for-bit with
        device-hashed store signatures (one hash path per store).
        """
        self._validate_probes(n_probes)
        x = self._to_device(vectors)
        b, r = self.num_bands, self.rows_per_band
        if self.hash_family == "crosspolytope":
            bits = cp_probe_bits_torch(
                x, self.device_projection(), num_bands=b, rows_per_band=r,
                n_probes=n_probes,
            )
            n = bits.shape[0]
            flat = pack_bits_to_words(
                bits.reshape(n * n_probes, -1), num_bands=b, rows_per_band=r
            )
            return flat.reshape(n, n_probes, -1)
        coords = hash_coords(
            x, self.device_projection(), num_perm=b * r, hash_family=self.hash_family
        )
        return probe_words_from_coords(
            coords, num_bands=b, rows_per_band=r, n_probes=n_probes
        )

    def hash_batch_dense_host(self, vectors: np.ndarray) -> np.ndarray:
        """Host hash to the dense wire format, ``(n, B * ceil(r/8))`` uint8.

        The minimal-byte signature encoding for shipping query batches to a
        remote device store (`lshrs_tpu_torch.ops.bitpack.pack_bits_dense_np`);
        decode on device with `lshrs_tpu_torch.ops.bitpack.dense_to_words`.
        """
        arr = self._validated(vectors)
        bits = self._bits_host(arr)
        return pack_bits_dense_np(
            bits, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )

    # -- conversions ---------------------------------------------------------

    def signature_to_words(self, signatures: HashSignatures) -> np.ndarray:
        """`HashSignatures` bytes -> ``(num_bands * W,)`` uint32 words."""
        return band_bytes_to_words(
            signatures.as_tuple(), rows_per_band=self.rows_per_band
        )

    def words_to_signature(self, words_row: np.ndarray) -> HashSignatures:
        """``(num_bands * W,)`` uint32 words -> `HashSignatures` bytes."""
        return HashSignatures(
            words_to_band_bytes(
                np.asarray(words_row),
                num_bands=self.num_bands,
                rows_per_band=self.rows_per_band,
            )
        )

    # -- validation ----------------------------------------------------------

    def _validate_vector(self, vector: np.ndarray) -> np.ndarray:
        vec = np.asarray(vector, dtype=np.float32).reshape(-1)
        if vec.ndim != 1 or vec.shape[0] != self.dim:
            raise ValueError(
                f"Expected vector of dimension {self.dim}, received {vec.shape}"
            )
        return vec
