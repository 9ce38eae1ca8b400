"""``where=`` id filters: the port against the JAX package, and against
brute force over the admitted subset.

Both stores are fed the same signature words, so counts, distances and ids
must be ``array_equal``; top-p cosines agree within 1e-5 on graded-cosine
data (no two compared cosines within 1e-5). A filtered result must also
equal the unfiltered result of a store that holds only the admitted ids:
exact top-k over the subset, not post-filtering.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage import IdFilter as JaxFilter
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch import IdFilter
from lshrs_tpu_torch.storage import as_filter
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

NB, R, DIM, K = 8, 8, 32, 9
KW = dict(num_bands=NB, rows_per_band=R, dim=DIM, chunk_size=128, initial_capacity=256)
GAP = 1e-5


def _data(rng, clusters=40, members=16):
    """Graded-noise clusters (member k at 0.05 * (k + 1)); queries near
    the first 10 centres, one stored vector and one random vector."""
    c = rng.standard_normal((clusters, DIM)).astype(np.float32)
    steps = 0.05 * (1 + np.arange(members, dtype=np.float32))
    X = (c[:, None] + steps[None, :, None] * rng.standard_normal(
        (clusters, members, DIM)).astype(np.float32)).reshape(-1, DIM)
    Q = np.concatenate([
        c[:10] + 0.02 * rng.standard_normal((10, DIM)).astype(np.float32),
        X[5:6], rng.standard_normal((1, DIM)).astype(np.float32),
    ])
    ids = rng.permutation(5 * len(X))[: len(X)]
    return ids, X, Q


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=NB, rows_per_band=R, dim=DIM, seed=11)


def _stores(hasher, ids, X, **kw):
    kw = {**KW, **kw}
    js, ts = JaxStore(**kw), TorchStore(device="cpu", **kw)
    words = hasher.hash_batch_words_host(X)
    vecs = X if kw.get("store_vectors") else None
    for s in (js, ts):
        s.add_signature_batch(ids, words, vecs)
    return js, ts


def _filters(ids):
    """name -> (allowed, disallowed) over the stored ids."""
    srt = np.sort(ids)
    return {
        "allow": (srt[::3], None),
        "deny": (None, srt[::4]),
        "allow_minus_deny": (srt[: len(srt) // 2], srt[::5]),
        "empty_allow": ([], None),
        "allow_absent_ids": ([10**8, 10**8 + 1], None),
        "deny_everything": (None, srt),
    }


FILTER_NAMES = list(_filters(np.arange(10)))


def _pair_filter(spec):
    return JaxFilter(*spec), IdFilter(*spec)


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("spec", [
    ([3, 1, 2, 2], None), (None, [5]), ([1, 2, 3], [2]), ([], None), ([], [4]), (None, []),
])
def test_host_membership_matches(spec):
    jf, tf = _pair_filter(spec)
    probe = np.arange(-1, 8)
    np.testing.assert_array_equal(tf.admits(probe), jf.admits(probe))
    for a, b in ((tf.allowed, jf.allowed), (tf.disallowed, jf.disallowed)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32


def test_filter_validation_and_coercion():
    with pytest.raises(ValueError, match="requires allowed_ids"):
        IdFilter()
    with pytest.raises(ValueError, match="non-negative int32"):
        IdFilter(allowed_ids=[-1])
    with pytest.raises(ValueError, match="non-negative int32"):
        IdFilter(disallowed_ids=[2**31])
    assert as_filter(None) is None
    f = IdFilter([1])
    assert as_filter(f) is f
    g = as_filter([4, 2, 4])
    assert isinstance(g, IdFilter) and g.allowed.tolist() == [2, 4] and g.disallowed is None


@pytest.mark.parametrize("name", FILTER_NAMES)
def test_filtered_topk_counts_and_nnz_match(name, rng, hasher):
    ids, X, Q = _data(rng)
    js, ts = _stores(hasher, ids, X)
    jf, tf = _pair_filter(_filters(ids)[name])
    qw = hasher.hash_batch_words_host(Q)
    for k in (1, K, 100, 5000):
        _eq(ts.query_topk(qw, k, where=tf), js.query_topk(qw, k, where=jf))
    np.testing.assert_array_equal(
        ts.query_topk_ids(qw, K, where=tf).numpy(), np.asarray(js.query_topk_ids(qw, K, where=jf))
    )
    _eq(ts.query_counts(qw, where=tf), js.query_counts(qw, where=jf))
    np.testing.assert_array_equal(ts.query_nnz(qw, where=tf), js.query_nnz(qw, where=jf))
    counts, got_ids = ts.query_topk(qw, K, where=tf)
    assert tf.admits(got_ids[got_ids >= 0]).all()
    if name in ("empty_allow", "allow_absent_ids", "deny_everything"):
        assert (got_ids == -1).all() and (counts == 0).all()
        assert (ts.query_nnz(qw, where=tf) == 0).all()
    else:
        assert (counts[:, 0] > 0).any()


@pytest.mark.parametrize("storage", ["planes", "packed"])
@pytest.mark.parametrize("name", FILTER_NAMES)
def test_filtered_hamming_matches(name, storage, rng, hasher):
    ids, X, Q = _data(rng)
    js, ts = _stores(hasher, ids, X, enable_hamming=True, hamming_storage=storage)
    jf, tf = _pair_filter(_filters(ids)[name])
    qw = hasher.hash_batch_words_host(Q)
    for k in (1, K, 700):
        _eq(ts.query_hamming(qw, k, where=tf), js.query_hamming(qw, k, where=jf))
    got = ts.query_hamming_ids(qw, K, where=tf).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.query_hamming_ids(qw, K, where=jf)))
    assert tf.admits(got[got >= 0]).all()


@pytest.mark.parametrize("engine", ["collision", "planes", "packed"])
def test_filtered_equals_brute_force_over_the_admitted_subset(engine, rng, hasher):
    ids, X, Q = _data(rng)
    kw = {} if engine == "collision" else dict(enable_hamming=True, hamming_storage=engine)
    _, ts = _stores(hasher, ids, X, **kw)
    qw = hasher.hash_batch_words_host(Q)
    for name in ("allow", "deny", "allow_minus_deny"):
        tf = IdFilter(*_filters(ids)[name])
        keep = tf.admits(ids)
        assert 0 < keep.sum() < len(ids)
        _, sub = _stores(hasher, ids[keep], X[keep], **kw)
        for k in (3, 40):
            if engine == "collision":
                _eq(ts.query_topk(qw, k, where=tf), sub.query_topk(qw, k))
            else:
                _eq(ts.query_hamming(qw, k, where=tf), sub.query_hamming(qw, k))
        if engine == "collision":
            np.testing.assert_array_equal(ts.query_nnz(qw, where=tf), sub.query_nnz(qw))
            # post-filtering would differ: some unfiltered top-3 ids are inadmissible
            _, plain = ts.query_topk(qw, 3)
            assert not tf.admits(plain[plain >= 0]).all()


def test_allowlist_shorthand_and_dead_slots(rng, hasher):
    ids, X, Q = _data(rng)
    js, ts = _stores(hasher, ids, X)
    allow = np.sort(ids)[::2]
    for s in (js, ts):
        s.remove_indices(allow[:30].tolist())
    qw = hasher.hash_batch_words_host(Q)
    _eq(ts.query_topk(qw, K, where=allow), js.query_topk(qw, K, where=allow))
    _eq(ts.query_topk(qw, K, where=allow.tolist()), ts.query_topk(qw, K, where=IdFilter(allow)))
    _, got = ts.query_topk(qw, 50, where=allow)
    assert not np.isin(got, allow[:30]).any()  # deleted stays dead under an allowlist


def _cached_ids(flt, store):
    """The filtered id column ``flt`` holds for ``store``: the same tensor
    object as long as no query recomputed it."""
    generation, ids_f, _ = flt._cache[store]
    assert generation == store._generation
    return ids_f


def test_filter_state_is_cached_per_generation(rng, hasher):
    ids, X, Q = _data(rng)
    js, ts = _stores(hasher, ids, X, enable_hamming=True)
    srt = np.sort(ids)
    jf, tf = _pair_filter((srt[::2], srt[::7]))
    qw = hasher.hash_batch_words_host(Q)

    def check():
        _eq(ts.query_topk(qw, K, where=tf), js.query_topk(qw, K, where=jf))
        _eq(ts.query_hamming(qw, K, where=tf), js.query_hamming(qw, K, where=jf))
        np.testing.assert_array_equal(ts.query_nnz(qw, where=tf), js.query_nnz(qw, where=jf))

    check()
    state = _cached_ids(tf, ts)
    check()
    assert _cached_ids(tf, ts) is state  # six queries, one computation
    # append (admitted and inadmissible new ids), delete, overwrite, compact
    new_ids = np.array([srt[-1] + 1, srt[-1] + 2, srt[-1] + 3])
    tf2 = IdFilter(np.concatenate([srt[::2], new_ids[:2]]), srt[::7])
    jf2 = JaxFilter(np.concatenate([srt[::2], new_ids[:2]]), srt[::7])
    words = hasher.hash_batch_words_host(rng.standard_normal((3, DIM)).astype(np.float32))

    def recomputed():
        nonlocal state
        check()
        fresh = _cached_ids(tf, ts)
        changed, state = fresh is not state, fresh
        return changed

    for s in (js, ts):
        s.add_signature_batch(new_ids, words)
    assert recomputed()
    _eq(ts.query_topk(qw, 4, where=tf2), js.query_topk(qw, 4, where=jf2))
    _, got = ts.query_topk(words, 1, where=tf2)
    assert got[:2, 0].tolist() == new_ids[:2].tolist() and got[2, 0] != new_ids[2]
    for s in (js, ts):
        s.remove_indices(srt[:40:2].tolist())
    assert recomputed()
    for s in (js, ts):
        s.add_signature_batch(srt[100:103], words)  # overwrite: ids unchanged
    assert recomputed()
    for s in (js, ts):
        assert s.compact() == 20
    assert recomputed()
    assert not recomputed()
    for s in (js, ts):
        s.clear()
    c, i = ts.query_topk(qw, 3, where=tf)
    assert (c == 0).all() and (i == -1).all()


def test_one_filter_serves_two_stores(rng, hasher):
    ids, X, Q = _data(rng)
    js1, ts1 = _stores(hasher, ids, X)
    js2, ts2 = _stores(hasher, ids[::2] + 1, X[::2])
    srt = np.sort(ids)
    jf, tf = _pair_filter((np.concatenate([srt[::3], srt[::2] + 1]), None))
    qw = hasher.hash_batch_words_host(Q)
    for _ in range(2):
        _eq(ts1.query_topk(qw, K, where=tf), js1.query_topk(qw, K, where=jf))
        _eq(ts2.query_topk(qw, K, where=tf), js2.query_topk(qw, K, where=jf))
    assert len(tf._cache) == 2
    del ts2
    gc.collect()
    assert len(tf._cache) == 1  # weak keys: a dead store releases its entry
    # the cache is bounded
    extra = [_stores(hasher, ids[:64], X[:64])[1] for _ in range(6)]
    for s in extra:
        s.query_topk(qw, 2, where=tf)
    assert len(tf._cache) <= IdFilter._CACHE_MAX


@pytest.mark.parametrize("mode,wire", [
    ("collision", "words"), ("collision", "dense"), ("hamming", "words"), ("hamming", "dense"),
])
@pytest.mark.parametrize("storage", ["planes", "packed"])
def test_filtered_snapshot_query_fn_matches(mode, wire, storage, rng, hasher):
    ids, X, Q = _data(rng)
    js, ts = _stores(hasher, ids, X, enable_hamming=True, hamming_storage=storage)
    jf, tf = _pair_filter(_filters(ids)["allow_minus_deny"])
    sig = hasher.hash_batch_words_host(Q) if wire == "words" else hasher.hash_batch_dense_host(Q)
    want = np.asarray(js.snapshot_query_fn(K, wire=wire, mode=mode, where=jf)(sig))
    serve = ts.snapshot_query_fn(K, wire=wire, mode=mode, where=tf)
    got = serve(sig).numpy()
    np.testing.assert_array_equal(got, want)
    assert tf.admits(got[got >= 0]).all() and (got >= 0).any()
    state = _cached_ids(tf, ts)
    serve(sig)
    assert _cached_ids(tf, ts) is state
    # an allowlist shorthand is resolved once, at snapshot time
    allow = np.sort(ids)[::3]
    serve2 = ts.snapshot_query_fn(K, wire=wire, mode=mode, where=allow)
    np.testing.assert_array_equal(
        serve2(sig).numpy(),
        np.asarray(js.snapshot_query_fn(K, wire=wire, mode=mode, where=allow)(sig)),
    )
    ts.remove_indices([int(ids[0])])
    with pytest.raises(RuntimeError, match="stale"):
        serve(sig)


def _assert_topp_equal(got, want):
    (gi, gs, gn), (wi, ws, wn) = got, [np.asarray(a) for a in want]
    np.testing.assert_array_equal(np.asarray(gn), wn)
    np.testing.assert_array_equal(np.asarray(gi), wi)
    valid = wi >= 0
    if wi.ndim == 2 and wi.shape[1] > 1:
        d = np.abs(np.diff(np.where(valid, ws, np.nan), axis=1))
        assert (d[valid[:, 1:]] > GAP).all(), "near-tie in the compared cosines"
    np.testing.assert_allclose(np.asarray(gs)[valid], ws[valid], rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["full", "gather"])
@pytest.mark.parametrize("payload", ["float32", "int8"])
@pytest.mark.parametrize("name", ["allow", "allow_minus_deny", "empty_allow"])
def test_filtered_topp_matches(name, payload, engine, hasher):
    ids, X, Q = _data(np.random.default_rng(2024))
    Q = Q[:11]  # near-centre and stored queries: well separated cosines
    js, ts = _stores(hasher, ids, X, store_vectors=True, payload_dtype=payload,
                     rerank_engine=engine, rerank_candidates=64)
    jf, tf = _pair_filter(_filters(ids)[name])
    qw = hasher.hash_batch_words_host(Q)
    got = ts.query_topp_batch(qw, Q, 6, where=tf)
    _assert_topp_equal(got, js.query_topp_batch(qw, Q, 6, where=jf))
    assert tf.admits(got[0][got[0] >= 0]).all()
    for i in (0, 10):
        g, w = ts.query_topp(qw[i : i + 1], Q[i], 6, where=tf), js.query_topp(qw[i : i + 1], Q[i], 6, where=jf)
        _assert_topp_equal((g[0][None], g[1][None], np.asarray([g[2]])),
                           (w[0][None], w[1][None], np.asarray([w[2]])))
    for wire in ("words", "dense"):
        sig = qw if wire == "words" else hasher.hash_batch_dense_host(Q)
        serve = ts.snapshot_topp_fn(6, wire=wire, where=tf, batch_hint=len(Q))
        want = js.snapshot_topp_fn(6, wire=wire, where=jf, batch_hint=len(Q))(sig, Q)
        _assert_topp_equal([t.numpy() for t in serve(sig, Q)], want)
    if name == "empty_allow":
        assert (got[0] == -1).all() and (got[2] == 0).all()
    # gather == full under the same filter (the budget covers every query)
    other = ts.query_topp_batch(qw, Q, 6, where=tf, engine="full" if engine == "gather" else "gather")
    np.testing.assert_array_equal(other[0], got[0])
    np.testing.assert_array_equal(other[2], got[2])


# ---------------------------------------------------------------------------
# LSHRS entry points
# ---------------------------------------------------------------------------

def _lsh_pair(ids, X, **kw):
    base = dict(dim=DIM, num_perm=NB * R, num_bands=NB, rows_per_band=R, hash_mode="host",
                seed=11, chunk_size=128, initial_capacity=256)
    jl, tl = JaxLSHRS(**{**base, **kw}), TorchLSHRS(device="cpu", **{**base, **kw})
    for lsh in (jl, tl):
        lsh.index(ids.tolist(), X)
    return jl, tl


@pytest.mark.parametrize("engine", ["collision", "hamming"])
@pytest.mark.parametrize("name", ["allow", "deny", "allow_minus_deny", "empty_allow"])
def test_lshrs_filtered_topk_matches(name, engine, rng):
    ids, X, Q = _data(rng)
    jl, tl = _lsh_pair(ids, X, engine=engine)
    spec = _filters(ids)[name]
    jf, tf = _pair_filter(spec)
    assert tl.query_batch(Q, top_k=K, where=tf) == jl.query_batch(Q, top_k=K, where=jf)
    for q in Q[:4]:
        assert tl.query(q, top_k=K, where=tf) == jl.query(q, top_k=K, where=jf)
        assert tl.get_top_k(q, K, where=tf) == jl.query(q, top_k=K, where=jf)
        assert tl.query(q, top_k=None, where=tf) == jl.query(q, top_k=None, where=jf)
    if spec[0] is not None and spec[1] is None:  # the array shorthand
        assert tl.query_batch(Q, top_k=K, where=list(spec[0])) == jl.query_batch(Q, top_k=K, where=jf)
    got = tl.serving_fn(top_k=K, where=tf)(Q)
    np.testing.assert_array_equal(got, np.asarray(jl.serving_fn(top_k=K, where=jf)(Q)))
    assert tf.admits(got[got >= 0]).all()
    assert tl.stats()["counters"]["queries_served"] == jl.stats()["counters"]["queries_served"]


@pytest.mark.parametrize("storage", ["planes", "packed"])
def test_lshrs_filtered_query_hamming_matches(storage, rng):
    ids, X, Q = _data(rng)
    jl, tl = _lsh_pair(ids, X, engine="collision", enable_hamming=True, hamming_storage=storage)
    jf, tf = _pair_filter(_filters(ids)["allow_minus_deny"])
    got, want = tl.query_hamming_batch(Q, top_k=K, where=tf), jl.query_hamming_batch(Q, top_k=K, where=jf)
    assert [[i for i, _ in row] for row in got] == [[i for i, _ in row] for row in want]
    np.testing.assert_allclose([s for row in got for _, s in row], [s for row in want for _, s in row])
    assert tl.query_hamming(Q[1], top_k=K, where=tf) == got[1]
    assert tf.admits([i for row in got for i, _ in row]).all()
    np.testing.assert_array_equal(
        tl.serving_fn(top_k=K, mode="hamming", where=tf)(Q),
        np.asarray(jl.serving_fn(top_k=K, mode="hamming", where=jf)(Q)),
    )


def _assert_scored_equal(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    w = np.asarray([s for _, s in want], np.float64)
    assert (np.abs(np.diff(w)) > GAP).all(), "near-tie in the compared cosines"
    np.testing.assert_allclose([s for _, s in got], w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["full", "gather"])
@pytest.mark.parametrize("hash_mode", ["host", "device"])
def test_lshrs_filtered_top_p_matches(engine, hash_mode, rng):
    ids, X, Q = _data(rng)
    # the structured family hashes bit-identically on the device in both
    # packages, so the device hash mode compares across packages too
    jl, tl = _lsh_pair(ids, X, store_vectors=True, rerank_engine=engine, hash_mode=hash_mode,
                       hash_family="structured", rerank_candidates=128)
    jf, tf = _pair_filter(_filters(ids)["allow_minus_deny"])
    for g, w in zip(tl.get_above_p_batch(Q, p=0.6, where=tf), jl.get_above_p_batch(Q, p=0.6, where=jf)):
        _assert_scored_equal(g, w)
        assert tf.admits([i for i, _ in g]).all()
    for q in Q[:3]:
        _assert_scored_equal(tl.get_above_p(q, p=0.5, where=tf), jl.query(q, top_k=None, top_p=0.5, where=jf))
        _assert_scored_equal(tl.query(q, top_p=1.0, top_k=4, where=tf), jl.query(q, top_p=1.0, top_k=4, where=jf))
    got = tl.serving_fn(top_k=6, mode="topp", where=tf, batch_hint=len(Q))(Q)
    _assert_topp_equal(got, jl.serving_fn(top_k=6, mode="topp", where=jf, batch_hint=len(Q))(Q))


def test_lshrs_filtered_fetch_fn_path_matches(rng):
    ids, X, Q = _data(rng)
    table = {int(i): v for i, v in zip(ids, X)}
    fetch = lambda idx: np.stack([table[int(i)] for i in idx])  # noqa: E731
    jl, tl = _lsh_pair(ids, X, vector_fetch_fn=fetch)
    jf, tf = _pair_filter(_filters(ids)["allow"])
    for q in Q[:4]:
        _assert_scored_equal(tl.get_above_p(q, p=0.7, where=tf), jl.query(q, top_k=None, top_p=0.7, where=jf))
    for g, w in zip(tl.get_above_p_batch(Q[:4], p=0.7, where=tf), jl.get_above_p_batch(Q[:4], p=0.7, where=jf)):
        _assert_scored_equal(g, w)
