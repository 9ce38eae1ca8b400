"""Cosine similarity and top-k reranking (host-side parity path).

These NumPy functions implement the rerank contract of the reference
(upstream `lshrs/utils/similarity.py`): candidates fetched via
a user callback are ranked by cosine against the query, descending, with
``(index, score)`` tuples returned.

The device-resident rerank (``store_vectors=True``) lives in
`lshrs_tpu_torch.ops.rerank` and reranks every cutoff on the device; this
module serves vectors from the user's primary datastore
(``vector_fetch_fn``). Those arrive on the host and are few (a candidate
set), so NumPy is the right tool.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np

from lshrs_tpu_torch.utils.norm import l2_norm


def cosine_similarity(query: np.ndarray, candidates: Sequence[np.ndarray]) -> np.ndarray:
    """Cosine similarity between one query and many candidates.

    Every vector (query and each candidate) is L2-normalised, so the result
    is a plain matrix-vector product. Returns a float32 array of
    ``len(candidates)`` values in [-1, 1].

    Raises:
        ValueError: if the query or any candidate is a zero vector.
    """
    q = l2_norm(query)
    cand = np.asarray(candidates, dtype=np.float32)
    if cand.ndim != 2:
        # Fall back to per-row normalisation of a ragged/odd input the same
        # way: stack after normalising each row.
        return np.stack([l2_norm(v) for v in candidates]) @ q
    norms = np.linalg.norm(cand, axis=1)
    if np.any(norms == 0):
        raise ValueError("Cannot normalize zero vector")
    return (cand / norms[:, None]) @ q


def top_k_cosine(
    query: np.ndarray,
    candidates: Sequence[np.ndarray],
    *,
    k: int,
) -> list[tuple[int, float]]:
    """k most-similar candidates by cosine, descending.

    Returns ``(position_in_candidates, score)`` tuples. Uses a partial sort
    (argpartition) so the cost is O(n + k log k). ``k`` larger than the
    candidate count returns everything.

    Raises:
        ValueError: if ``k <= 0``.
    """
    if k <= 0:
        raise ValueError("k must be > 0")

    sims = cosine_similarity(query, candidates)
    n = len(sims)
    if n == 0:
        return []

    top = np.argpartition(-sims, kth=min(k, n - 1))[:k]
    ordered = top[np.argsort(-sims[top], kind="stable")]
    return [(int(i), float(sims[i])) for i in ordered]
