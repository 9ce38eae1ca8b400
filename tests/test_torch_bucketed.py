"""Bucketed query engine: the port against `lshrs_tpu` on the same words.

Mirrors `tests/test_bucketed.py` on the port's store (exact against the
scan engine, invalidation by every mutation, the overflow count, wide
bands, validation, the fall-through past the int32 packing), then holds
the port's `lshrs_tpu_torch.ops.bucketed` to the reference's: folded keys,
the sorted index (a stable sort, so the slots of a truncated run agree),
and ids, counts and overflow counts IDENTICAL to `lshrs_tpu`'s bucketed
store, a truncating ``bucket_cap=2`` included.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import bucketed as jbk
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.ops import bucketed as tbk
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

B, R, D = 4, 8, 32


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def make_pair(**kw):
    base = dict(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64)
    base.update(kw)
    return (
        TorchStore(query_mode="scan", device="cpu", **base),
        TorchStore(query_mode="bucket", device="cpu", **base),
    )


def _both(**kw):
    """A bucketed store of each package with the same arguments."""
    kw = {"num_bands": B, "rows_per_band": R, "chunk_size": 64, "initial_capacity": 64,
          "query_mode": "bucket", **kw}
    return JaxStore(**kw), TorchStore(device="cpu", **kw)


def _same(js, ts, qw, k):
    jc, ji = js.query_topk(qw, k)
    tc, ti = ts.query_topk(qw, k)
    np.testing.assert_array_equal(np.asarray(ji), ti)
    np.testing.assert_array_equal(np.asarray(jc), tc)
    assert js.stats()["bucket_overflows"] == ts.stats()["bucket_overflows"]


# -- mirrors of tests/test_bucketed.py -----------------------------------


def test_bucket_matches_scan_exactly(hasher, rng):
    scan, bucket = make_pair()
    n = 600
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(50_000)[:n]
    words = hasher.hash_batch_words_host(X)
    scan.add_signature_batch(ids, words)
    bucket.add_signature_batch(ids, words)
    qw = hasher.hash_batch_words_host(rng.standard_normal((15, D)).astype(np.float32))
    c1, i1 = scan.query_topk(qw, 20)
    c2, i2 = bucket.query_topk(qw, 20)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(i1, i2)
    assert bucket.stats()["bucket_overflows"] == 0
    assert bucket.stats()["query_mode"] == "bucket"


def test_bucket_index_invalidation_on_mutation(hasher, rng):
    _, bucket = make_pair()
    X = rng.standard_normal((50, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    bucket.add_signature_batch(np.arange(50), words)
    _, out = bucket.query_topk(words[3:4], 3)
    assert out[0][0] == 3
    # delete, then query again: the stale index must not resurrect id 3
    bucket.remove_indices([3])
    _, out = bucket.query_topk(words[3:4], 3)
    assert 3 not in out[0]
    # append after a query: new data must be visible
    x_new = rng.standard_normal((1, D)).astype(np.float32)
    bucket.add_signature_batch([777], hasher.hash_batch_words_host(x_new))
    _, out = bucket.query_topk(hasher.hash_batch_words_host(x_new), 1)
    assert out[0][0] == 777


def test_bucket_overflow_counted(hasher):
    # bucket_cap=2 with 8 identical signatures: every query overflows.
    bucket = TorchStore(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64,
                        query_mode="bucket", bucket_cap=2, device="cpu")
    words = hasher.hash_batch_words_host(np.ones((1, D), np.float32))
    bucket.add_signature_batch(np.arange(8), np.repeat(words, 8, axis=0))
    counts, _ = bucket.query_topk(words, 8)
    assert bucket.stats()["bucket_overflows"] > 0
    # truncated but still valid: the returned candidates have max counts
    assert all(c == B for c in counts[0][:2])


def test_bucket_wide_words(rng):
    # W = 2 (r = 40): folded 32-bit keys may collide; verification keeps
    # the results exact.
    h = LSHHasher(num_bands=3, rows_per_band=40, dim=D, seed=9)
    kw = dict(num_bands=3, rows_per_band=40, chunk_size=64, initial_capacity=64, device="cpu")
    scan = TorchStore(query_mode="scan", **kw)
    bucket = TorchStore(query_mode="bucket", **kw)
    X = rng.standard_normal((300, D)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    scan.add_signature_batch(np.arange(300), words)
    bucket.add_signature_batch(np.arange(300), words)
    qw = h.hash_batch_words_host(rng.standard_normal((8, D)).astype(np.float32))
    c1, i1 = scan.query_topk(qw, 10)
    c2, i2 = bucket.query_topk(qw, 10)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(i1, i2)


def test_bucket_mode_validation():
    with pytest.raises(ValueError, match="query_mode"):
        TorchStore(num_bands=B, rows_per_band=R, query_mode="sideways", device="cpu")
    with pytest.raises(ValueError, match="bucket_cap"):
        TorchStore(num_bands=B, rows_per_band=R, query_mode="bucket", bucket_cap=0,
                   device="cpu")


def test_bucket_falls_back_when_keys_would_overflow(hasher, rng, monkeypatch):
    """Past the int32 (count, tie) packing the bucket engine yields to the
    scan, whose chunked fallback answers there == the reference's chunked
    scan instead of corrupting keys; below it the scan answers the
    filtered and the multi-probe queries the bucket index cannot."""
    import lshrs_tpu.storage.device as jdevice_mod
    import lshrs_tpu_torch.storage.device as device_mod

    scan, bucket = make_pair()
    X = rng.standard_normal((200, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    scan.add_signature_batch(np.arange(200), words)
    bucket.add_signature_batch(np.arange(200), words)
    qw = hasher.hash_batch_words_host(rng.standard_normal((6, D)).astype(np.float32))
    called = []
    real = device_mod.bucketed_topk
    monkeypatch.setattr(device_mod, "bucketed_topk",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    allow = np.arange(0, 200, 3)
    np.testing.assert_array_equal(bucket.query_topk(qw, 10, where=allow)[1],
                                  scan.query_topk(qw, 10, where=allow)[1])
    probe = np.stack([words[:6], words[6:12]], axis=1)  # (Q, T=2, BW)
    np.testing.assert_array_equal(bucket.query_topk(probe, 10)[1], scan.query_topk(probe, 10)[1])
    assert not called
    ref, _ = _both()
    ref.add_signature_batch(np.arange(200), words)
    for mod in (device_mod, jdevice_mod):
        monkeypatch.setattr(mod, "supports_fast_path", lambda *a: False)
    got = bucket.query_topk(qw, 10)
    assert not called  # the bucket engine was gated off
    np.testing.assert_array_equal(got[1], np.asarray(ref.query_topk(qw, 10)[1]))
    np.testing.assert_array_equal(got[0], np.asarray(ref.query_topk(qw, 10)[0]))
    assert bucket._ranks is not None  # the chunked scan's ranks


# -- parity with lshrs_tpu ------------------------------------------------


@pytest.mark.parametrize("r", [8, 40, 64])
def test_fold_and_index_match_the_reference(r, rng):
    bands = 3
    w = -(-r // 32)
    sig = rng.integers(0, 2**32, size=(bands * w, 300), dtype=np.uint64).astype(np.uint32)
    sig[:, 100:110] = sig[:, 5:6]  # runs of equal keys: the stable order shows
    ids = np.arange(300, dtype=np.int32)
    ids[[7, 50, 299]] = -1
    jkeys = np.asarray(jbk.fold_band_keys(sig, num_bands=bands))
    tkeys = tbk.fold_band_keys(torch.from_numpy(sig.view(np.int32)), num_bands=bands)
    np.testing.assert_array_equal(tkeys.numpy(), jkeys.astype(np.int64))
    js, jo = jbk.build_bucket_index(sig, ids, num_bands=bands)
    ts, to = tbk.build_bucket_index(
        torch.from_numpy(sig.view(np.int32)), torch.from_numpy(ids), num_bands=bands
    )
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("cap", [2, 128])
def test_bucketed_store_matches_the_reference(cap, hasher, rng, monkeypatch):
    """Ids, counts and overflow counts identical to the reference's
    bucketed store; ``bucket_cap=2`` truncates (duplicated rows make long
    runs) and the truncated answers agree too."""
    js, ts = _both(bucket_cap=cap, initial_capacity=1024)
    X = rng.standard_normal((700, D)).astype(np.float32)
    X[600:] = X[:100]  # 100 exact duplicates: runs of length >= 2
    ids = rng.permutation(10_000)[:700]
    words = hasher.hash_batch_words_host(X)
    js.add_signature_batch(ids, words)
    ts.add_signature_batch(ids, words)
    qw = np.concatenate([words[:20], hasher.hash_batch_words_host(
        rng.standard_normal((20, D)).astype(np.float32))])
    for k in (1, 10, 50):
        _same(js, ts, qw, k)
    if cap == 2:
        assert ts.stats()["bucket_overflows"] > 0
    # the bucket engine's own result, without the store
    t = ts._bucket_index
    np.testing.assert_array_equal(np.asarray(js._bucket_index[1]), t[1].numpy())
    # queries in slices of 7 give the same answer
    qwt = torch.from_numpy(qw.view(np.int32))
    kw = dict(num_bands=B, k=10, bucket_cap=cap)
    whole = tbk.bucketed_topk(ts._sig_t, ts._ids, ts._tie, *t, qwt, **kw)
    monkeypatch.setattr(tbk, "_SLICE_BYTES", 7 * B * cap * tbk._BYTES_PER_CANDIDATE)
    assert tbk.bucketed_slice_queries(num_bands=B, bucket_cap=cap) == 7
    sliced = tbk.bucketed_topk(ts._sig_t, ts._ids, ts._tie, *t, qwt, **kw)
    for a, b in zip(whole, sliced):
        assert torch.equal(a, b)


def test_bucketed_invalidation_matches_the_reference(hasher, rng):
    """Every mutation rebuilds the index in both packages: upsert (the
    reference's `tests/test_sharding.py:234` case), delete, compact, grow,
    clear and load."""
    js, ts = _both(initial_capacity=64)
    X = rng.standard_normal((60, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    for st in (js, ts):
        st.add_signature_batch(np.arange(60), words)
    qw = words[:12]
    _same(js, ts, qw, 5)
    assert ts._bucket_index is not None
    new = hasher.hash_batch_words_host(rng.standard_normal((4, D)).astype(np.float32))
    steps = [
        lambda st: st.add_signature_batch([1, 2, 3, 4], new),  # upsert in place
        lambda st: st.remove_indices([5, 6, 7]),
        lambda st: st.compact(),
        lambda st: st.add_signature_batch(np.arange(100, 200), np.repeat(words[:1], 100, 0)),
        lambda st: st.load_state_arrays(js.state_arrays()),
        lambda st: st.clear(),
    ]
    for step in steps:
        for st in (js, ts):
            step(st)
        assert ts._bucket_index is None
        _same(js, ts, np.concatenate([qw, new]), 5)
    _, ids = ts.query_topk(new[:1], 3)
    assert (ids == -1).all()  # cleared


def test_bucket_level_api_matches_the_reference(hasher, rng):
    """`batch_add` stages band ops until a row is complete; `get_bucket`
    enumerates one band bucket; deletes drop staged ops."""
    js, ts = _both()
    X = rng.standard_normal((40, D)).astype(np.float32)
    sigs = hasher.hash_batch(X)
    ops = [(b, sig[b], i) for i, sig in enumerate(sigs) for b in range(B)]
    for st in (js, ts):
        st.batch_add(ops[: 4 * 30 + 2])  # id 30 has two of its four bands
        st.remove_indices([30])  # its staged ops go
        st.batch_add(ops[4 * 30 + 2 :])
        st.add_to_bucket(0, sigs[3][0], 999)  # an incomplete row: staged only
    assert len(ts) == len(js) == 39
    for b in range(B):
        for i in (0, 3, 17):
            assert ts.get_bucket(b, sigs[i][b]) == js.get_bucket(b, sigs[i][b])
    assert 30 not in ts.get_bucket(0, sigs[30][0])
    _same(js, ts, hasher.hash_batch_words_host(X[:10]), 5)
    with pytest.raises(ValueError, match="band_id"):
        ts.get_bucket(B, sigs[0][0])
    payload = TorchStore(num_bands=B, rows_per_band=R, dim=D, store_vectors=True, device="cpu")
    with pytest.raises(RuntimeError, match="payload"):
        payload.batch_add([(b, sigs[0][b], 0) for b in range(B)])


def test_lshrs_bucket_mode_matches_the_reference(rng):
    kw = dict(dim=D, num_perm=32, num_bands=B, rows_per_band=R, engine="collision",
              query_mode="bucket", bucket_cap=4, initial_capacity=256)
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    X = rng.standard_normal((200, D)).astype(np.float32)
    X[150:] = X[:50]
    for lsh in (jl, tl):
        lsh.index(np.arange(200), X)
    Q = np.concatenate([X[:8], rng.standard_normal((8, D)).astype(np.float32)])
    assert tl.query_batch(Q, top_k=6) == jl.query_batch(Q, top_k=6)
    np.testing.assert_array_equal(tl.serving_fn(top_k=6)(Q), np.asarray(jl.serving_fn(top_k=6)(Q)))
    assert [tl.get_top_k(q, topk=4) for q in Q] == [jl.get_top_k(q, topk=4) for q in Q]
    assert tl.stats()["index"]["bucket_overflows"] == jl.stats()["index"]["bucket_overflows"]
    assert tl.stats()["index"]["query_mode"] == "bucket"
