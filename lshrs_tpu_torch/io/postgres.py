"""Streaming PostgreSQL loader.

Yields ``(indices, vectors)`` batches from a table or custom query using a
named server-side cursor (constant memory), with the same signature and
validation as the reference loader
(upstream `lshrs/io/postgres.py`): dsn or connection
factory, identifier-quoted query building with optional raw
where/order/limit fragments, a fully custom ``fetch_query`` mode, vector
coercion from binary/string/array payloads, and consistent-dimensionality
checks. psycopg is an optional dependency imported at call time.
"""

from __future__ import annotations

from collections.abc import Callable, Iterator, Sequence
from typing import Any, Optional

import numpy as np
from numpy.typing import NDArray

DEFAULT_POSTGRES_BATCH_SIZE = 10_000

__all__ = ["DEFAULT_POSTGRES_BATCH_SIZE", "iter_postgres_vectors"]


def iter_postgres_vectors(
    *,
    dsn: Optional[str] = None,
    connection_factory: Optional[Callable[[], Any]] = None,
    table: str = "vectors",
    index_column: str = "id",
    vector_column: str = "embedding",
    batch_size: int = DEFAULT_POSTGRES_BATCH_SIZE,
    limit: Optional[int] = None,
    where_clause: Optional[str] = None,
    order_by: Optional[str] = None,
    params: Optional[Sequence[Any]] = None,
    fetch_query: Optional[str] = None,
) -> Iterator[tuple[list[int], NDArray[np.float32]]]:
    """Stream ``(indices, (n, dim) float32 vectors)`` pairs from PostgreSQL.

    Either ``dsn`` (connection owned and closed here) or
    ``connection_factory`` (caller owns the connection) must be given.
    ``fetch_query`` + ``params`` replaces the generated query entirely.

    Raises:
        ImportError: psycopg is not installed.
        ValueError: missing connection info, ``params`` without
            ``fetch_query``, bad batch_size, or inconsistent vector
            dimensionality mid-stream.
    """
    try:
        import psycopg
        from psycopg import sql as psql
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "psycopg is required to stream data from PostgreSQL. "
            "Install it via `pip install psycopg[binary]`."
        ) from e

    if connection_factory is None and dsn is None:
        raise ValueError("Either `dsn` or `connection_factory` must be provided")
    if fetch_query is None and params is not None:
        raise ValueError("`params` can only be used when `fetch_query` is supplied")
    if batch_size <= 0:
        raise ValueError("batch_size must be greater than zero")

    owned_connection = False
    if connection_factory is not None:
        connection = connection_factory()
    else:
        connection = psycopg.connect(dsn)
        connection.autocommit = True
        owned_connection = True

    try:
        if fetch_query is not None:
            query: Any = fetch_query
            query_params: Optional[Sequence[Any]] = params
        else:
            query = psql.SQL("SELECT {idx}, {vec} FROM {tbl}").format(
                idx=psql.Identifier(index_column),
                vec=psql.Identifier(vector_column),
                tbl=psql.Identifier(table),
            )
            if where_clause:
                query = psql.SQL("{q} WHERE {w}").format(
                    q=query, w=psql.SQL(where_clause)
                )
            if order_by:
                query = psql.SQL("{q} ORDER BY {o}").format(
                    q=query, o=psql.SQL(order_by)
                )
            if limit is not None:
                query = psql.SQL("{q} LIMIT {n}").format(
                    q=query, n=psql.Literal(int(limit))
                )
            query_params = None

        with connection.cursor(name="lshrs_tpu_stream") as cursor:
            cursor.itersize = batch_size
            cursor.execute(query, query_params)
            expected_dim: Optional[int] = None
            while True:
                rows = cursor.fetchmany(batch_size)
                if not rows:
                    break
                indices: list[int] = []
                vectors: list[NDArray[np.float32]] = []
                for row in rows:
                    idx = int(row[0])
                    vector = _coerce_vector(row[1])
                    if expected_dim is None:
                        expected_dim = vector.shape[0]
                    elif vector.shape[0] != expected_dim:
                        raise ValueError(
                            "Inconsistent vector dimensionality detected while "
                            "streaming from PostgreSQL: "
                            f"expected {expected_dim}, received {vector.shape[0]}"
                        )
                    indices.append(idx)
                    vectors.append(vector)
                yield indices, np.stack(vectors, axis=0).astype(np.float32, copy=False)
    finally:
        if owned_connection:
            connection.close()


def _coerce_vector(value: Any) -> NDArray[np.float32]:
    """Decode one row's embedding payload to a 1-D float32 array.

    Accepts raw float32 binary (memoryview/bytes), pgvector-style
    ``"{1,2,3}"`` / ``"[1,2,3]"`` strings, or any array-like.
    """
    if isinstance(value, (memoryview, bytes, bytearray)):
        return np.frombuffer(bytes(value), dtype=np.float32).copy()
    if isinstance(value, str):
        text = value.strip().lstrip("{[").rstrip("}]")
        if not text:
            raise ValueError("Encountered empty vector payload from PostgreSQL")
        return np.asarray(
            [float(part) for part in text.split(",")], dtype=np.float32
        )
    return np.asarray(value, dtype=np.float32).reshape(-1)
