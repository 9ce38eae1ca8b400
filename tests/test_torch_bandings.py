"""The bandings users get from the auto-tuner and the default index's
multi-probe: the port's ``LSHRS`` against the JAX package's.

``LSHRS(num_perm=384, similarity_threshold=0.6)`` tunes to 48 x 8,
``num_perm=192`` to 24 x 8 (t=0.7) and 12 x 16 (t=0.5), and the default
``num_perm=128`` to 8 x 16, here with ``multiprobe=2``; 16 x 16 with
``multiprobe=3`` beside them. Every one reaches kernel B1 at a band-word
count or probe count outside the powers of two. Both packages hash on the
host from one seed, so they hold the same signature words; ids and their
order must be equal, top-p cosines within 1e-5 on graded-cosine data.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.ops import group_max, rerank, scan

DIM, K, GAP = 32, 9, 1e-5
# (LSHRS arguments, the banding they resolve to, probes)
CASES = [
    (dict(num_perm=384, similarity_threshold=0.6), (48, 8), 1),
    (dict(num_perm=192, similarity_threshold=0.7), (24, 8), 1),
    (dict(num_perm=192, similarity_threshold=0.5), (12, 16), 1),
    (dict(multiprobe=2), (8, 16), 2),
    (dict(num_perm=256, num_bands=16, rows_per_band=16, multiprobe=3), (16, 16), 3),
]
IDS = ["48x8", "24x8", "12x16", "8x16_probes2", "16x16_probes3"]


def _data(rng, clusters=40, members=16, noise=0.05):
    c = rng.standard_normal((clusters, DIM)).astype(np.float32)
    steps = noise * (1 + np.arange(members, dtype=np.float32))
    X = (c[:, None] + steps[None, :, None] * rng.standard_normal(
        (clusters, members, DIM)).astype(np.float32)).reshape(-1, DIM)
    Q = np.concatenate([
        c[:10] + 0.05 * rng.standard_normal((10, DIM)).astype(np.float32), X[5:6],
    ])
    return rng.permutation(5 * len(X))[: len(X)], X, Q


def _pair(ids, X, **kw):
    base = dict(dim=DIM, seed=11, hash_mode="host", chunk_size=128, initial_capacity=256,
                engine="collision", **kw)
    jl, tl = JaxLSHRS(**base), TorchLSHRS(device="cpu", **base)
    for lsh in (jl, tl):
        lsh.index(ids.tolist(), X)
    return jl, tl


def _count_b1_shapes(monkeypatch, module) -> collections.Counter:
    """Wrap B1's wrapper where ``module`` calls it; count its calls by
    ``(band words, words per band, probes)``."""
    shapes = collections.Counter()

    def counted(sig_t, tie, qwords, **kw):
        shapes[sig_t.shape[0], kw["words"], kw.get("probes", 1)] += 1
        return group_max.group_max_keys(sig_t, tie, qwords, **kw)

    monkeypatch.setattr(module, "group_max_keys", counted)
    return shapes


def _assert_scored_equal(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    w = np.asarray([s for _, s in want], np.float64)
    assert (np.abs(np.diff(w)) > GAP).all(), "near-tie in the compared cosines"
    np.testing.assert_allclose([s for _, s in got], w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kw,banding,probes", CASES, ids=IDS)
def test_bandings_resolve_alike(kw, banding, probes):
    jl, tl = JaxLSHRS(dim=DIM, **kw), TorchLSHRS(dim=DIM, device="cpu", **kw)
    for lsh in (jl, tl):
        st = lsh.stats()
        assert (st["num_bands"], st["rows_per_band"], st["multiprobe"]) == (*banding, probes)


@pytest.mark.parametrize("kw,banding,probes", CASES, ids=IDS)
def test_topk_ids_match(kw, banding, probes, rng, monkeypatch):
    ids, X, Q = _data(rng)
    jl, tl = _pair(ids, X, **kw)
    shapes = _count_b1_shapes(monkeypatch, scan)
    assert tl.query_batch(Q, top_k=K) == jl.query_batch(Q, top_k=K)
    words = -(-banding[1] // 32)
    assert shapes[banding[0] * words, words, probes] > 0, shapes
    np.testing.assert_array_equal(tl.serving_fn(top_k=K)(Q), np.asarray(jl.serving_fn(top_k=K)(Q)))
    for q in Q[:3]:
        assert tl.query(q, top_k=K) == jl.query(q, top_k=K)
    # a stored vector collides with itself in every band
    assert int(ids[7]) in tl.query(X[7], top_k=K)


@pytest.mark.parametrize("engine", ["full", "gather"])
def test_topp_ids_match_at_48x8(engine, rng, monkeypatch):
    ids, X, Q = _data(rng)
    jl, tl = _pair(ids, X, num_perm=384, similarity_threshold=0.6, store_vectors=True,
                   rerank_engine=engine, rerank_candidates=128)
    assert (tl.stats()["num_bands"], tl.stats()["rows_per_band"]) == (48, 8)
    shapes = _count_b1_shapes(monkeypatch, rerank)
    for g, w in zip(tl.get_above_p_batch(Q, p=0.5, top_k=6), jl.get_above_p_batch(Q, p=0.5, top_k=6)):
        _assert_scored_equal(g, w)
    got = tl.serving_fn(top_k=6, mode="topp", batch_hint=len(Q))(Q)
    want = jl.serving_fn(top_k=6, mode="topp", batch_hint=len(Q))(Q)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    valid = np.asarray(want[0]) >= 0
    np.testing.assert_allclose(np.asarray(got[1])[valid], np.asarray(want[1])[valid], rtol=0,
                               atol=1e-5)
    # the gather engine's first stage is B1 at 48 band words; full has none
    assert (shapes[48, 1, 1] > 0) == (engine == "gather"), shapes
