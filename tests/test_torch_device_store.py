"""DeviceStore parity: both packages' stores fed the same signature words."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

NB, R, DIM, K = 8, 8, 16, 7
KW = dict(num_bands=NB, rows_per_band=R, dim=DIM, chunk_size=128, initial_capacity=128)


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=NB, rows_per_band=R, dim=DIM, seed=11)


def _pair(**kw):
    kw = {**KW, **kw}
    return JaxStore(**kw), TorchStore(device="cpu", **kw)


def _data(rng, hasher, n, id_base=0):
    X = rng.standard_normal((n, DIM)).astype(np.float32)
    ids = id_base + rng.permutation(10 * n)[:n]
    return ids, X


def _queries(rng, hasher, X, q=24):
    qx = X[rng.integers(0, len(X), q)] + 0.3 * rng.standard_normal((q, DIM)).astype(np.float32)
    qx[0] = X[0]
    return hasher.hash_batch_words_host(qx)


def _assert_same_state(js, ts):
    assert ts._capacity == js._capacity and len(ts) == len(js)
    a, b = js.state_arrays(), ts.state_arrays()
    np.testing.assert_array_equal(b["ids"], a["ids"])
    np.testing.assert_array_equal(b["sig"], a["sig"])


def _assert_same_topk(js, ts, qwords, k=K):
    jc, ji = js.query_topk(qwords, k)
    tc, ti = ts.query_topk(qwords, k)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ti, ji)
    assert (tc[:, 0] > 0).any()


def _assert_same_hamming(js, ts, qwords, k=K):
    jh, ji = js.query_hamming(qwords, k)
    th, ti = ts.query_hamming(qwords, k)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("wire", ["words", "dense"])
def test_ingest_wires_match(wire, rng, hasher):
    js, ts = _pair()
    ids, X = _data(rng, hasher, 500)
    sig = hasher.hash_batch_words_host(X) if wire == "words" else hasher.hash_batch_dense_host(X)
    for lo in range(0, 500, 200):
        js.add_signature_batch(ids[lo : lo + 200], sig[lo : lo + 200])
        ts.add_signature_batch(ids[lo : lo + 200], sig[lo : lo + 200])
        _assert_same_state(js, ts)
    _assert_same_topk(js, ts, _queries(rng, hasher, X))


def test_capacity_grows_as_the_reference(rng, hasher):
    js, ts = _pair()
    base = 0
    for n in (1, 3, 100, 5, 300, 1000, 70, 129):
        ids, X = _data(rng, hasher, n, id_base=base)
        base += 10 * n
        words = hasher.hash_batch_words_host(X)
        js.add_signature_batch(ids, words)
        ts.add_signature_batch(ids, words)
        assert ts._capacity == js._capacity, n
    _assert_same_state(js, ts)


@pytest.mark.parametrize("dedupe", [True, False])
def test_upserts_and_duplicates_match(dedupe, rng, hasher):
    js, ts = _pair(dedupe=dedupe)
    ids, X = _data(rng, hasher, 300)
    words = hasher.hash_batch_words_host(X)
    for s in (js, ts):
        s.add_signature_batch(ids, words)
    # Re-ingest: new words for present ids, in-batch duplicates, new ids.
    X2 = rng.standard_normal((40, DIM)).astype(np.float32)
    ids2 = np.concatenate([ids[:20], ids[:5], 10**6 + np.arange(15)])
    words2 = hasher.hash_batch_words_host(X2)
    for s in (js, ts):
        s.add_signature_batch(ids2, words2)
    _assert_same_state(js, ts)
    _assert_same_topk(js, ts, np.concatenate([_queries(rng, hasher, X), words2[:8]]))


@pytest.mark.parametrize("mode", ["collision", "hamming"])
@pytest.mark.parametrize("wire", ["words", "dense"])
def test_queries_and_snapshots_match(mode, wire, rng, hasher):
    js, ts = _pair(enable_hamming=True)
    ids, X = _data(rng, hasher, 700)
    words = hasher.hash_batch_words_host(X)
    for s in (js, ts):
        s.add_signature_batch(ids, words)
    qx = X[:30] + 0.3 * rng.standard_normal((30, DIM)).astype(np.float32)
    qwords = hasher.hash_batch_words_host(qx)
    if mode == "collision":
        _assert_same_topk(js, ts, qwords)
    else:
        _assert_same_hamming(js, ts, qwords)
    q = qwords if wire == "words" else hasher.hash_batch_dense_host(qx)
    want = np.asarray(js.snapshot_query_fn(K, wire=wire, mode=mode)(q))
    got = ts.snapshot_query_fn(K, wire=wire, mode=mode)(q)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stale_snapshot_raises(rng, hasher):
    _, ts = _pair()
    ids, X = _data(rng, hasher, 100)
    words = hasher.hash_batch_words_host(X)
    ts.add_signature_batch(ids, words)
    serve = ts.snapshot_query_fn(K)
    serve(words[:3])
    ts.add_signature_batch([10**6], words[:1])
    with pytest.raises(RuntimeError, match="stale"):
        serve(words[:3])
    np.testing.assert_array_equal(ts.snapshot_query_fn(K)(words[:3])[:, 0].numpy(), ids[:3])


@pytest.mark.parametrize("n", [300, 5000])
def test_reference_state_loads_into_the_port(n, rng, hasher):
    js = JaxStore(enable_hamming=True, **KW)
    ids, X = _data(rng, hasher, n)
    js.add_signature_batch(ids, hasher.hash_batch_words_host(X))
    ts = TorchStore(enable_hamming=True, device="cpu", **KW)
    ts.load_state_arrays(js.state_arrays())
    _assert_same_state(js, ts)
    qwords = _queries(rng, hasher, X)
    _assert_same_topk(js, ts, qwords)
    _assert_same_hamming(js, ts, qwords)


def test_empty_store_and_unported_options(hasher, rng):
    _, ts = _pair(enable_hamming=True)
    q = hasher.hash_batch_words_host(rng.standard_normal((2, DIM)).astype(np.float32))
    c, i = ts.query_topk(q, 3)
    assert (c == 0).all() and (i == -1).all()
    h, i = ts.query_hamming(q, 3)
    assert (h == NB * R + 1).all() and (i == -1).all()
    with pytest.raises(RuntimeError, match="non-empty"):
        ts.snapshot_query_fn(3)
    c, i = ts.query_topk(q, 3, where=[1, 2])  # a filter on an empty store
    assert (c == 0).all() and (i == -1).all()
    with pytest.raises(NotImplementedError):
        ts.snapshot_query_fn(3, mode="asymmetric")
    with pytest.raises(NotImplementedError):
        TorchStore(query_mode="bucket", device="cpu", **KW)
    with pytest.raises(ValueError, match="hamming_storage"):
        TorchStore(hamming_storage="sparse", device="cpu", **KW)
    ts.remove_indices([1])  # an absent id: nothing to tombstone
    assert len(ts) == 0 and ts.stats()["tombstones"] == 0 and ts.compact() == 0
