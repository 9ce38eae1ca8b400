"""Package-wide shared types.

`HashSignatures` is the immutable per-vector container of banded LSH
signatures. It mirrors the observable contract of the reference container
(upstream `lshrs/_config/config.py`): a tuple of `bytes`, one
per band, normalised from any bytes-like input, exposing the sequence
protocol plus `as_tuple()`.

The device hot path never materialises these objects — signatures live as
packed 32-bit words in device memory (see `lshrs_tpu_torch.storage.device`). This class
exists for API parity: single-vector `hash_vector`, bucket-style storage
backends, and any user code that treats signatures as dictionary keys.
"""

from __future__ import annotations

from collections.abc import Iterator
from dataclasses import dataclass


@dataclass(frozen=True)
class HashSignatures:
    """Immutable container of per-band packed binary signatures.

    Attributes:
        bands: One packed little-endian signature per band. Each entry is
            ``ceil(rows_per_band / 8)`` bytes. Band order is significant:
            band ``i`` of a query is only ever compared against band ``i``
            of indexed vectors.
    """

    bands: tuple[bytes, ...]

    def __post_init__(self) -> None:
        # Accept any bytes-like (bytearray, memoryview, np scalar buffers)
        # and freeze into true `bytes` so instances hash & compare by value.
        normalized = tuple(bytes(band) for band in self.bands)
        object.__setattr__(self, "bands", normalized)

    def __iter__(self) -> Iterator[bytes]:
        return iter(self.bands)

    def __len__(self) -> int:
        return len(self.bands)

    def __getitem__(self, item: int) -> bytes:
        return self.bands[item]

    def as_tuple(self) -> tuple[bytes, ...]:
        """Return the underlying tuple (usable as a dict key)."""
        return self.bands
