"""Input/output helpers for loading vector data from external sources."""

from .numpy_io import DEFAULT_NUMPY_BATCH_SIZE, iter_numpy_vectors
from .parquet import DEFAULT_PARQUET_BATCH_SIZE, iter_parquet_vectors
from .postgres import DEFAULT_POSTGRES_BATCH_SIZE, iter_postgres_vectors

__all__ = [
    "DEFAULT_NUMPY_BATCH_SIZE",
    "iter_numpy_vectors",
    "DEFAULT_PARQUET_BATCH_SIZE",
    "iter_parquet_vectors",
    "DEFAULT_POSTGRES_BATCH_SIZE",
    "iter_postgres_vectors",
]
