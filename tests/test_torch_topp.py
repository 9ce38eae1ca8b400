"""LSHRS top-p entry points: the port against the JAX package end to end.

``get_above_p``, ``get_above_p_batch``, ``query(top_p=)``,
``query(top_k=None)``, ``serving_fn(mode="topp")`` and the
``vector_fetch_fn`` path. Queries hash on the host (``hash_mode="host"``),
where both packages compute bit-identical signatures, so both sides rank
the same candidates; the device hash path is held to the port's own
host-words path. Ids and candidate counts must be equal and cosines agree
within 1e-5 (1e-2 relative on a bfloat16 wire); the data are clustered
with graded noise, and each test asserts that no two compared cosines lie
within 1e-5 of each other.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu_torch import LSHRS as TorchLSHRS

DIM = 64
GAP = 1e-5


def _kw(**kw):
    base = dict(dim=DIM, num_perm=256, num_bands=16, rows_per_band=16, hash_mode="host", seed=13,
                chunk_size=128, initial_capacity=1024, store_vectors=True)
    return {**base, **kw}


def _data(rng, clusters=60, members=20):
    """Clusters with graded noise (member k: 0.05 * (k + 1)), and queries
    near the first 12 centres plus one random vector."""
    c = rng.standard_normal((clusters, DIM)).astype(np.float32)
    steps = 0.05 * (1 + np.arange(members, dtype=np.float32))
    X = c[:, None] + steps[None, :, None] * rng.standard_normal(
        (clusters, members, DIM)).astype(np.float32)
    Q = c[:12] + 0.02 * rng.standard_normal((12, DIM)).astype(np.float32)
    return X.reshape(-1, DIM), np.concatenate([Q, rng.standard_normal((1, DIM)).astype(np.float32)])


def _pair(rng, **kw):
    X, Q = _data(rng)
    jl, tl = JaxLSHRS(**_kw(**kw)), TorchLSHRS(device="cpu", **_kw(**kw))
    for lsh in (jl, tl):
        lsh.index(list(range(len(X))), X)
    return jl, tl, X, Q


def assert_scored_equal(got, want, *, rtol=0.0):
    """Two ``[(id, cosine), ...]`` lists: the same ids, cosines close; and
    no near-tie among the compared cosines."""
    assert [i for i, _ in got] == [i for i, _ in want]
    w = np.asarray([s for _, s in want], np.float64)
    assert (np.abs(np.diff(w)) > GAP).all(), "near-tie in the compared cosines"
    np.testing.assert_allclose([s for _, s in got], w, rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("payload_dtype", ["float32", "bfloat16", "int8"])
def test_single_query_top_p_matches(payload_dtype, rng):
    jl, tl, X, Q = _pair(rng, payload_dtype=payload_dtype)
    for q in Q:
        assert_scored_equal(tl.get_above_p(q, p=0.5), jl.get_above_p(q, p=0.5))
        assert_scored_equal(tl.query(q, top_p=1.0, top_k=3), jl.query(q, top_p=1.0, top_k=3))
        assert tl.query(q, top_k=None) == jl.query(q, top_k=None)
    assert tl.stats()["counters"]["queries_served"] == jl.stats()["counters"]["queries_served"]
    n = len(tl.query(Q[0], top_k=None))
    assert n > 4 and len(tl.get_above_p(Q[0], p=0.25)) == max(1, math.ceil(n * 0.25))
    assert tl.get_above_p(X[30], p=1.0)[0][0] == 30  # self-match first
    # A rounded payload (bf16, int8) moves the self-cosine by its rounding.
    assert abs(tl.get_above_p(X[30], p=1.0)[0][1] - 1.0) < (
        1e-5 if payload_dtype == "float32" else 1e-2)


@pytest.mark.parametrize("payload_dtype", ["float32", "int8"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", ["full", "gather"])
def test_batch_top_p_matches(payload_dtype, wire, engine, rng):
    jl, tl, X, Q = _pair(rng, payload_dtype=payload_dtype, rerank_engine=engine)
    rtol = 1e-2 if wire == "bfloat16" else 0.0
    for p, top_k in ((0.5, None), (1.0, 5)):
        want = jl.get_above_p_batch(Q, p=p, top_k=top_k, wire_dtype=wire)
        got = tl.get_above_p_batch(Q, p=p, top_k=top_k, wire_dtype=wire)
        assert len(got) == len(Q)
        for g, w in zip(got, want):
            assert_scored_equal(g, w, rtol=rtol)
    # The batch agrees with the single-query path on a float32 wire.
    if wire == "float32":
        for q, row in zip(Q, tl.get_above_p_batch(Q, p=0.5)):
            assert [i for i, _ in row] == [i for i, _ in tl.query(q, top_k=None, top_p=0.5)]


@pytest.mark.parametrize("hash_mode", ["host", "device"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("engine", ["full", "gather"])
def test_serving_topp(hash_mode, wire, engine, rng):
    jl, tl, X, Q = _pair(rng, hash_mode=hash_mode, rerank_engine=engine, payload_dtype="int8")
    serve = tl.serving_fn(top_k=6, mode="topp", wire_dtype=wire, batch_hint=len(Q))
    ids, sims, n = serve(Q)
    assert ids.shape == sims.shape == (len(Q), 6) and n.shape == (len(Q),)
    assert ids.dtype == n.dtype == np.int32 and sims.dtype == np.float32
    assert tl.stats()["counters"]["queries_served"] == len(Q)
    rtol = 1e-2 if wire == "bfloat16" else 0.0
    if hash_mode == "host":  # the same words as the reference
        want = [np.asarray(x) for x in jl.serving_fn(top_k=6, mode="topp", wire_dtype=wire)(Q)]
    else:  # the port's own host-words path on the same device-hashed words
        qw = tl._hasher.hash_batch_words(Q)
        want = tl._storage.query_topp_batch(qw, Q, 6, wire_dtype=wire)
    np.testing.assert_array_equal(n, want[2])
    np.testing.assert_array_equal(ids, want[0])
    valid = want[0] >= 0
    assert (np.abs(np.diff(np.where(valid, want[1], np.nan), axis=1)[valid[:, 1:]]) > GAP).all()
    np.testing.assert_allclose(sims[valid], want[1][valid], rtol=rtol, atol=1e-5)
    # Self-match: stored vectors rank themselves first, at cosine ~1 (to
    # the int8 payload's ~4e-3 rounding).
    ids_s, sims_s, _ = serve(X[:40])
    np.testing.assert_array_equal(ids_s[:, 0], np.arange(40))
    assert np.abs(sims_s[:, 0] - 1.0).max() < 1e-2
    tl.index([10**6], X[:1])
    with pytest.raises(RuntimeError, match="stale"):
        serve(Q)
    assert tl.stats()["counters"]["queries_served"] == len(Q) + 40


def test_candidate_enumeration_grows_past_its_first_guess(rng):
    """``top_k=None`` with more colliding candidates than the first bound
    (4096): the enumeration grows to the next power of two."""
    kw = dict(dim=16, num_perm=16, num_bands=4, rows_per_band=4, hash_mode="host", seed=2,
              chunk_size=128, initial_capacity=128)
    base = rng.standard_normal(16).astype(np.float32)
    X = base + 1e-3 * rng.standard_normal((5000, 16)).astype(np.float32)
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    for lsh in (jl, tl):
        lsh.index(list(range(5000)), X)
    got, want = tl.query(base, top_k=None), jl.query(base, top_k=None)
    assert got == want and len(got) > 4096


def test_vector_fetch_fn_reranks_on_the_host(rng):
    X, Q = _data(rng)
    fetched = []

    def fetch(ids):
        fetched.append(len(ids))
        return X[np.asarray(ids)]

    kw = _kw(store_vectors=False, vector_fetch_fn=fetch)
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    for lsh in (jl, tl):
        lsh.index(list(range(len(X))))  # vectors come from vector_fetch_fn
    for q in Q[:6]:
        assert_scored_equal(tl.get_above_p(q, p=0.5), jl.get_above_p(q, p=0.5))
    for g, w in zip(tl.get_above_p_batch(Q, p=1.0, top_k=4), jl.get_above_p_batch(Q, p=1.0, top_k=4)):
        assert_scored_equal(g, w)
    assert fetched and tl.stats()["index"]["payload_bytes"] == 0
    with pytest.raises(RuntimeError, match="store_vectors=False"):
        tl.serving_fn(top_k=4, mode="topp")

    bad = TorchLSHRS(device="cpu", **_kw(store_vectors=False,
                                         vector_fetch_fn=lambda ids: X[:1]))
    bad.index(list(range(len(X))), X)
    with pytest.raises(ValueError, match="mismatched batch size"):
        bad.get_above_p(Q[0], p=0.5)
    none = TorchLSHRS(device="cpu", **_kw(store_vectors=False))
    none.index(list(range(len(X))), X)
    with pytest.raises(RuntimeError, match="vector_fetch_fn"):
        none.get_above_p(Q[0], p=0.5)


def _no_payload_fetch(monkeypatch, lsh):
    def refuse(ids):
        raise AssertionError("the resident payload left the store for a host rerank")

    monkeypatch.setattr(lsh._storage, "get_vectors", refuse)


def test_long_cutoffs_take_the_enumeration_path(rng, monkeypatch):
    """A cutoff past the port's first device prefix (cut to 2 here): the
    port reranks again on the device at the cutoff's depth, and equals the
    reference's device rerank, whose prefix covers the cutoff. (Past its
    own prefix the reference reranks dequantized rows on the host against
    the unrounded query, which moves int8 cosines by ~4e-4.)"""
    jl, tl, X, Q = _pair(rng, payload_dtype="int8")
    tl._MAX_DEVICE_RERANK = 2
    _no_payload_fetch(monkeypatch, tl)
    for q in Q[:5]:
        assert_scored_equal(tl.get_above_p(q, p=1.0), jl.get_above_p(q, p=1.0))


def _graded_fan(rng, n, dim=16):
    """``n`` vectors around one direction ``u`` with cosines to it exactly
    ``1 - 2e-5 * (k + 1)`` (member k: ``cos u + sin v_k``, ``v_k`` a unit
    vector orthogonal to ``u``): neighbours differ by 2e-5."""
    u = rng.standard_normal(dim)
    u /= np.linalg.norm(u)
    v = rng.standard_normal((n, dim))
    v -= (v @ u)[:, None] * u
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    cos = 1.0 - 2e-5 * (1 + np.arange(n))
    X = cos[:, None] * u + np.sqrt(1.0 - cos**2)[:, None] * v
    return X.astype(np.float32), u.astype(np.float32)


def test_cutoffs_past_4096_candidates_rerank_on_the_device(rng, monkeypatch):
    """More than 4,096 colliding candidates and the bound as shipped: the
    default ``get_above_p`` (p=0.95) and a ``top_k`` past the first prefix
    equal the reference's host rerank, and no payload row is fetched."""
    X, u = _graded_fan(rng, 6000)
    kw = dict(dim=16, num_perm=16, num_bands=4, rows_per_band=4, hash_mode="host", seed=2,
              chunk_size=128, initial_capacity=128, store_vectors=True)
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    for lsh in (jl, tl):
        lsh.index(list(range(len(X))), X)
    _no_payload_fetch(monkeypatch, tl)
    n = len(tl.query(u, top_k=None))
    assert n == len(jl.query(u, top_k=None)) and math.ceil(0.95 * n) > tl._MAX_DEVICE_RERANK
    got = tl.get_above_p(u)
    assert len(got) == math.ceil(0.95 * n)
    assert_scored_equal(got, jl.get_above_p(u))
    assert_scored_equal(tl.query(u, top_p=1.0, top_k=4500), jl.query(u, top_p=1.0, top_k=4500))


def test_top_p_after_delete_upsert_and_compact(rng):
    jl, tl, X, Q = _pair(rng)
    gone = list(range(0, 1200, 7))
    Y = X[:5] + 0.3 * rng.standard_normal((5, DIM)).astype(np.float32)
    for lsh in (jl, tl):
        lsh.delete(gone)
        lsh.index([1, 2, 3, 4, 5], Y)  # upserts: new vectors, same ids
    for g, w in zip(tl.get_above_p_batch(Q, p=1.0, top_k=8), jl.get_above_p_batch(Q, p=1.0, top_k=8)):
        assert_scored_equal(g, w)
        assert not {i for i, _ in g} & set(gone)
    assert tl.compact() == jl._storage.compact() == len(gone)
    ids, _, _ = tl.serving_fn(top_k=8, mode="topp")(Q)
    assert not np.isin(ids, gone).any()
    assert_scored_equal(tl.get_above_p(Y[2], p=1.0)[:3], jl.get_above_p(Y[2], p=1.0)[:3])


def test_top_p_validation_and_empty_index(rng):
    tl = TorchLSHRS(device="cpu", **_kw())
    q = np.ones(DIM, np.float32)
    assert tl.query(q, top_p=0.5) == [] and tl.get_above_p(q) == []
    assert tl.query(q, top_k=None) == []
    assert tl.get_above_p_batch(np.ones((2, DIM), np.float32), p=0.5) == [[], []]
    X, _ = _data(rng)
    tl.index(list(range(len(X))), X)
    with pytest.raises(ValueError, match="top_p"):
        tl.query(X[0], top_p=1.5)
    with pytest.raises(ValueError, match="top_k"):
        tl.query(X[0], top_p=0.5, top_k=0)
    with pytest.raises(ValueError, match="top_p"):
        tl.get_above_p_batch(X[:2], p=0.0)
    with pytest.raises(ValueError, match="top_k"):
        tl.get_above_p_batch(X[:2], p=0.5, top_k=0)
    with pytest.raises(ValueError, match="wire_dtype"):
        tl.get_above_p_batch(X[:2], p=0.5, wire_dtype="fp8")
    with pytest.raises(ValueError, match="shape"):
        tl.get_above_p_batch(X[:2, :8], p=0.5)
    with pytest.raises(ValueError, match="wire_dtype"):
        tl.serving_fn(top_k=3, mode="topp", wire_dtype="fp8")
    with pytest.raises(ValueError, match="rerank_engine"):
        TorchLSHRS(device="cpu", **_kw(rerank_engine="nope"))
    assert tl._tpu_config["payload_dtype"] == "float32"
    assert TorchLSHRS(device="cpu", **_kw(payload_dtype="int8", rerank_candidates=77)
                      )._tpu_config["rerank_candidates"] == 77


def test_serving_topp_reads_one_device_tensor(rng, monkeypatch):
    """With the device hash the batch goes to the device once: the hash
    and the rerank read the same tensor."""
    _, tl, X, Q = _pair(rng, hash_mode="device")
    seen = []
    real = tl._storage._query_vectors

    def spy(qvecs, q):
        seen.append(qvecs)
        return real(qvecs, q)

    monkeypatch.setattr(tl._storage, "_query_vectors", spy)
    uploads = []
    real_from_numpy = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: uploads.append(a.shape) or real_from_numpy(a))
    tl.serving_fn(top_k=4, mode="topp")(Q)
    assert uploads == [Q.shape]
    assert len(seen) == 1 and isinstance(seen[0], torch.Tensor) and seen[0].dtype == torch.float32
