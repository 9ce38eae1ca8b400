"""Banded random-hyperplane LSH hasher (gaussian family).

All ``num_bands`` projection matrices are one ``(num_perm, dim)`` float32
array drawn from a single seeded NumPy stream — the same draw as the
reference package, so the projections are identical for a given seed.
The device keeps its transpose ``(dim, num_perm)``, so a batch of vectors
is hashed with one matmul ``(n, dim) @ (dim, num_perm)`` followed by a
sign bitpack into int32 words (`lshrs_tpu_torch.ops.bitpack`).

The device hash runs in full float32: the sign of near-zero projections
decides hash bits, so TF32 matmuls must be off (PyTorch's default); the
device path raises rather than hash with TF32 on.

Not ported yet: the structured (FWHT), cross-polytope and learned hash
families and multi-probe query hashing (ROADMAP Queue A).
"""

from __future__ import annotations

import numpy as np
import torch

from lshrs_tpu_torch.ops.bitpack import (
    pack_bits_dense_np,
    pack_bits_to_words,
    pack_bits_to_words_np,
    words_per_band,
)

__all__ = ["LSHHasher", "hash_words"]


def hash_words(
    x: torch.Tensor, proj_t: torch.Tensor, *, num_bands: int, rows_per_band: int
) -> torch.Tensor:
    """``(n, dim)`` float32 @ ``(dim, num_perm)`` -> ``(n, num_bands * W)``
    int32 signature words, in full float32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: signature hashing "
            "needs full float32 matmuls (near-zero projections decide bits)"
        )
    return pack_bits_to_words(
        (x @ proj_t) > 0, num_bands=num_bands, rows_per_band=rows_per_band
    )


class LSHHasher:
    """Random-projection LSH hasher producing banded binary signatures.

    Attributes:
        num_bands: number of independent bands (hash tables).
        rows_per_band: hyperplanes (bits) per band.
        dim: expected input dimensionality.
        words_per_band: 32-bit words per band signature, ``ceil(r / 32)``.
        device: where :meth:`hash_batch_words` and
            :meth:`device_projection` live.
    """

    def __init__(
        self,
        num_bands: int,
        rows_per_band: int,
        dim: int,
        seed: int = 42,
        hash_family: str = "gaussian",
        *,
        device: str | torch.device = "cuda",
    ) -> None:
        if num_bands <= 0:
            raise ValueError("num_bands must be > 0")
        if rows_per_band <= 0:
            raise ValueError("rows_per_band must be > 0")
        if dim <= 0:
            raise ValueError("dim must be > 0")
        if hash_family != "gaussian":
            raise NotImplementedError(
                f"hash_family={hash_family!r} is not ported yet (ROADMAP "
                "Queue A: structured and learned hashing with the native "
                "FWHT, the cross-polytope family)"
            )
        self.num_bands = num_bands
        self.rows_per_band = rows_per_band
        self.dim = dim
        self.words_per_band = words_per_band(rows_per_band)
        self.hash_family = hash_family
        self.device = torch.device(device)
        rng = np.random.default_rng(seed)
        self._proj = rng.standard_normal((num_bands * rows_per_band, dim)).astype(
            np.float32
        )
        self._proj_dev: torch.Tensor | None = None  # device operand, lazy

    @property
    def projections(self) -> list[np.ndarray]:
        """Per-band ``(rows_per_band, dim)`` projection matrices, the
        reference's layout (what checkpoints store)."""
        r = self.rows_per_band
        return [self._proj[b * r : (b + 1) * r] for b in range(self.num_bands)]

    @projections.setter
    def projections(self, matrices) -> None:
        mats = [np.asarray(m, dtype=np.float32) for m in matrices]
        if len(mats) != self.num_bands or any(
            m.shape != (self.rows_per_band, self.dim) for m in mats
        ):
            raise ValueError(
                "projections must be a sequence of "
                f"{self.num_bands} matrices of shape ({self.rows_per_band}, {self.dim})"
            )
        self._proj = np.concatenate(mats, axis=0)
        self._proj_dev = None  # re-uploaded at the next device hash

    @property
    def projection_matrix(self) -> np.ndarray:
        """The fused ``(num_perm, dim)`` float32 projection matrix."""
        return self._proj

    def device_projection(self) -> torch.Tensor:
        """The ``(dim, num_perm)`` float32 hash operand on :attr:`device`
        (uploaded once). The store's fused build hashes with it too, so
        stored and query signatures come from the same matmul."""
        if self._proj_dev is None:
            self._proj_dev = torch.from_numpy(self._proj.T.copy()).to(self.device)
        return self._proj_dev

    def _validated(self, vectors) -> np.ndarray:
        arr = np.asarray(vectors, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != self.dim:
            raise ValueError(
                f"Expected vectors of shape (n, {self.dim}), received {tuple(arr.shape)}"
            )
        return arr

    def hash_batch_words(self, vectors) -> torch.Tensor:
        """Device path: ``(n, dim)`` -> ``(n, num_bands * W)`` int32 words
        on :attr:`device` (one matmul plus a bitpack)."""
        x = torch.from_numpy(self._validated(vectors)).to(self.device)
        return hash_words(
            x, self.device_projection(),
            num_bands=self.num_bands, rows_per_band=self.rows_per_band,
        )

    def hash_batch_words_host(self, vectors) -> np.ndarray:
        """Host twin of :meth:`hash_batch_words`: one NumPy sgemm,
        ``(n, num_bands * W)`` uint32 words."""
        bits = self._validated(vectors) @ self._proj.T > 0
        return pack_bits_to_words_np(
            bits, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )

    def hash_batch_dense_host(self, vectors) -> np.ndarray:
        """Host hash to the dense wire format, ``(n, B * ceil(r/8))`` uint8
        (`lshrs_tpu_torch.ops.bitpack.pack_bits_dense_np`); the store
        decodes it on the device."""
        bits = self._validated(vectors) @ self._proj.T > 0
        return pack_bits_dense_np(
            bits, num_bands=self.num_bands, rows_per_band=self.rows_per_band
        )
