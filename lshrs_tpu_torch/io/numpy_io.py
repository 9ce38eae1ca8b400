"""In-memory / NumPy-file loader.

A convenience loader that upstream `lshrs` lacks: streams ``(indices, vectors)``
batches from an in-memory array pair or from ``.npy`` / ``.npz`` files,
with the same yield contract as the Parquet/Postgres loaders. This is the
natural feed for benchmark datasets (e.g. GloVe exported as ``.npy``) and
for double-buffered device ingestion.
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence
from pathlib import Path
from typing import Optional, Union

import numpy as np
from numpy.typing import NDArray

DEFAULT_NUMPY_BATCH_SIZE = 65_536

__all__ = ["DEFAULT_NUMPY_BATCH_SIZE", "iter_numpy_vectors"]


def iter_numpy_vectors(
    source: Union[str, Path, np.ndarray, None] = None,
    *,
    vectors: Optional[np.ndarray] = None,
    indices: Optional[Sequence[int]] = None,
    vector_key: str = "vectors",
    index_key: str = "indices",
    batch_size: int = DEFAULT_NUMPY_BATCH_SIZE,
) -> Iterator[tuple[list[int], NDArray[np.float32]]]:
    """Stream batches from an array, ``.npy`` file, or ``.npz`` archive.

    Args:
        source: a 2-D array, or a path to ``.npy`` (vectors only) /
            ``.npz`` (expects ``vector_key``, optionally ``index_key``).
        vectors: alternative to ``source``: the vector matrix directly.
        indices: explicit ids; defaults to ``0..n-1``.
        batch_size: rows per yielded batch (> 0).
    """
    if batch_size <= 0:
        raise ValueError("batch_size must be greater than zero")

    if vectors is None:
        if source is None:
            raise ValueError("Either `source` or `vectors` must be provided")
        if isinstance(source, (str, Path)):
            path = Path(source).expanduser()
            if not path.exists():
                raise FileNotFoundError(f"NumPy source '{path}' does not exist")
            if path.suffix == ".npz":
                with np.load(path) as data:
                    if vector_key not in data.files:
                        raise ValueError(
                            f"Key '{vector_key}' was not found in archive {sorted(data.files)}"
                        )
                    vectors = data[vector_key]
                    if indices is None and index_key in data.files:
                        indices = data[index_key]
            else:
                vectors = np.load(path)
        else:
            vectors = np.asarray(source)

    arr = np.asarray(vectors, dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError("vectors must be a 2D array")
    n = arr.shape[0]
    if indices is None:
        ids = np.arange(n, dtype=np.int64)
    else:
        ids = np.asarray(indices, dtype=np.int64).reshape(-1)
        if ids.shape[0] != n:
            raise ValueError(
                f"Number of indices ({ids.shape[0]}) does not match number of vectors ({n})"
            )

    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        # tolist() gives the same Python ints as int() per element, in one
        # C loop instead of a NumPy scalar per id (the per-element loop
        # showed in the build time: tools/torch_ingest_probe.py).
        yield ids[start:stop].tolist(), arr[start:stop]
