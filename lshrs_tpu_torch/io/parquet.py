"""Streaming Parquet loader.

Yields ``(indices, vectors)`` batches from a Parquet file using PyArrow's
columnar batch reader, with the same signature, validation and defaults as
the upstream `lshrs` loader (`lshrs/io/parquet.py`):
column-presence checks against the schema, tilde expansion, consistent
non-empty vector dimensionality, float32 output. PyArrow is an optional
dependency imported at call time.
"""

from __future__ import annotations

from collections.abc import Iterator, Sequence
from pathlib import Path

import numpy as np
from numpy.typing import NDArray

DEFAULT_PARQUET_BATCH_SIZE = 10_000

__all__ = ["DEFAULT_PARQUET_BATCH_SIZE", "iter_parquet_vectors"]


def iter_parquet_vectors(
    source: Path | str,
    *,
    index_column: str = "index",
    vector_column: str = "vector",
    batch_size: int = DEFAULT_PARQUET_BATCH_SIZE,
) -> Iterator[tuple[list[int], NDArray[np.float32]]]:
    """Stream ``(indices, (n, dim) float32 vectors)`` pairs from Parquet.

    Args:
        source: path to the Parquet file (``~`` expanded).
        index_column: integer id column name.
        vector_column: list/array-of-float embedding column name.
        batch_size: rows per yielded batch (> 0).

    Raises:
        ImportError: pyarrow is not installed.
        FileNotFoundError: the file does not exist.
        ValueError: missing columns, bad batch_size, empty or
            inconsistently-sized vectors.
    """
    try:
        import pyarrow.parquet as pq
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "pyarrow is required to stream Parquet data. Install it via `pip install pyarrow`."
        ) from e

    path = Path(source).expanduser()
    if not path.exists():
        raise FileNotFoundError(f"Parquet source '{path}' does not exist")
    if batch_size <= 0:
        raise ValueError("batch_size must be greater than zero")

    parquet_file = pq.ParquetFile(path)
    schema = parquet_file.schema_arrow
    for column in (index_column, vector_column):
        if column not in schema.names:
            raise ValueError(
                f"Column '{column}' was not found in Parquet schema {schema.names}"
            )

    expected_dim: int | None = None
    for batch in parquet_file.iter_batches(
        batch_size=batch_size, columns=[index_column, vector_column]
    ):
        indices = [int(v) for v in batch.column(index_column).to_pylist()]
        rows = batch.column(vector_column).to_pylist()
        vectors = _coerce_vectors(rows)
        if expected_dim is None:
            expected_dim = vectors.shape[1]
        elif vectors.shape[1] != expected_dim:
            raise ValueError(
                "Inconsistent vector dimensionality across Parquet batches: "
                f"expected {expected_dim}, received {vectors.shape[1]}"
            )
        yield indices, vectors


def _coerce_vectors(rows: Sequence[Sequence[float]]) -> NDArray[np.float32]:
    """Stack row lists into a dense float32 matrix with strict validation."""
    if not rows:
        return np.empty((0, 0), dtype=np.float32)
    arrays = []
    dim: int | None = None
    for row in rows:
        arr = np.asarray(row, dtype=np.float32).reshape(-1)
        if arr.size == 0:
            raise ValueError("Encountered empty vector while reading Parquet data")
        if dim is None:
            dim = arr.size
        elif arr.size != dim:
            raise ValueError(
                "Inconsistent vector dimensionality while reading Parquet data: "
                f"expected {dim}, received {arr.size}"
            )
        arrays.append(arr)
    return np.stack(arrays, axis=0)
