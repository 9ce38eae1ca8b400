"""Delete and compact: the port's store and LSHRS against the JAX package.

Both packages get the same signature words and the same deletes; every
engine (collision counting, Hamming on bitplanes, Hamming on packed
words) must then return the reference's counts, distances and ids
exactly, before and after `compact`.
"""

from __future__ import annotations

import numpy as np
import pytest

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

NB, R, DIM, K = 8, 8, 16, 7
KW = dict(num_bands=NB, rows_per_band=R, dim=DIM, chunk_size=128, initial_capacity=128,
          enable_hamming=True)
STATS_KEYS = ("size", "alive", "tombstones", "capacity", "hamming_storage",
              "hamming_plane_bytes", "fast_path", "signature_bytes")


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=NB, rows_per_band=R, dim=DIM, seed=13)


def _filled_pair(rng, hasher, *, dedupe, storage):
    """Both stores, 700 rows in two batches; without dedupe the second
    batch repeats 30 ids of the first, so an id can own two slots."""
    js = JaxStore(dedupe=dedupe, hamming_storage=storage, **KW)
    ts = TorchStore(dedupe=dedupe, hamming_storage=storage, device="cpu", **KW)
    X = rng.standard_normal((700, DIM)).astype(np.float32)
    ids = rng.permutation(20_000)[:700]
    if not dedupe:
        ids[400:430] = ids[:30]
    words = hasher.hash_batch_words_host(X)
    for s in (js, ts):
        s.add_signature_batch(ids[:400], words[:400])
        s.add_signature_batch(ids[400:], words[400:])
    return js, ts, ids, X


def _assert_same(js, ts, qwords, deleted):
    jc, ji = js.query_topk(qwords, K)
    tc, ti = ts.query_topk(qwords, K)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(ti, ji)
    jh, jhi = js.query_hamming(qwords, K)
    th, thi = ts.query_hamming(qwords, K)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(thi, jhi)
    for mode in ("collision", "hamming"):
        got = ts.snapshot_query_fn(K, mode=mode)(qwords).numpy()
        np.testing.assert_array_equal(got, np.asarray(js.snapshot_query_fn(K, mode=mode)(qwords)))
        assert not np.isin(got, deleted).any(), mode
    assert not np.isin(ti, deleted).any() and not np.isin(thi, deleted).any()
    assert len(ts) == len(js)
    jst, tst = js.stats(), ts.stats()
    for key in STATS_KEYS:
        assert tst[key] == jst[key], key


@pytest.mark.parametrize("storage", ["planes", "packed"])
@pytest.mark.parametrize("dedupe", [True, False])
def test_delete_then_compact_matches_reference(dedupe, storage, rng, hasher):
    js, ts, ids, X = _filled_pair(rng, hasher, dedupe=dedupe, storage=storage)
    # Queries: some deleted rows themselves, some kept rows, some noise.
    qwords = hasher.hash_batch_words_host(
        np.concatenate([X[:12], X[500:506], rng.standard_normal((6, DIM)).astype(np.float32)])
    )
    deleted = np.concatenate([ids[:8], ids[500:503], ids[100:200:7]])
    to_delete = np.concatenate([deleted, deleted[:3], [10**6, 10**6 + 1]])  # repeats, absent
    for s in (js, ts):
        s.remove_indices(to_delete.tolist())
    assert ts.stats()["tombstones"] > 0
    _assert_same(js, ts, qwords, deleted)

    assert ts.compact() == js.compact() > 0
    assert ts.stats()["tombstones"] == 0
    _assert_same(js, ts, qwords, deleted)
    assert ts.compact() == js.compact() == 0


@pytest.mark.parametrize("storage", ["planes", "packed"])
def test_delete_everything_and_reinsert(storage, rng, hasher):
    js, ts, ids, X = _filled_pair(rng, hasher, dedupe=True, storage=storage)
    qwords = hasher.hash_batch_words_host(X[:10])
    for s in (js, ts):
        s.remove_indices(ids.tolist())
    assert len(ts) == 0
    _assert_same(js, ts, qwords, ids)
    # A deleted id comes back in a fresh slot.
    for s in (js, ts):
        s.add_signature_batch(ids[:5], hasher.hash_batch_words_host(X[:5]))
    _assert_same(js, ts, qwords, ids[5:])
    np.testing.assert_array_equal(ts.query_hamming(qwords[:5], 1)[1][:, 0], ids[:5])


def test_delete_makes_snapshots_stale(rng, hasher):
    _, ts, ids, X = _filled_pair(rng, hasher, dedupe=True, storage="packed")
    serve = ts.snapshot_query_fn(K, mode="hamming")
    ts.remove_indices([int(ids[0])])
    with pytest.raises(RuntimeError, match="stale"):
        serve(hasher.hash_batch_words_host(X[:2]))


def test_state_snapshot_is_not_changed_by_later_writes(rng, hasher):
    """On the CPU a snapshot must not alias the live tensors (the
    reference's arrays are immutable)."""
    _, ts, ids, X = _filled_pair(rng, hasher, dedupe=True, storage="planes")
    before = ts.state_arrays()
    saved = {k: v.copy() for k, v in before.items()}
    ts.remove_indices(ids[:50].tolist())
    ts.add_signature_batch(ids[100:120], hasher.hash_batch_words_host(X[:20]))  # overwrite
    for k in saved:
        np.testing.assert_array_equal(before[k], saved[k])


@pytest.mark.parametrize("storage", [None, "packed"])
def test_lshrs_delete_matches_reference(storage, rng):
    kw = dict(dim=DIM, num_perm=64, num_bands=8, rows_per_band=8, hash_mode="host", seed=4,
              chunk_size=128, initial_capacity=128, engine="hamming", hamming_storage=storage)
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    X = rng.standard_normal((500, DIM)).astype(np.float32)
    for lsh in (jl, tl):
        lsh.index(list(range(500)), X)
        lsh.delete(7)
        lsh.delete(np.arange(8, 9))
        lsh.delete([1, 2, 3, 3, 999])
    Q = X[:12] + 0.2 * rng.standard_normal((12, DIM)).astype(np.float32)
    assert tl.query_batch(Q, top_k=5) == jl.query_batch(Q, top_k=5)
    assert tl.query_hamming_batch(X[:10], top_k=4) == jl.query_hamming_batch(X[:10], top_k=4)
    np.testing.assert_array_equal(tl.serving_fn(top_k=6)(Q), np.asarray(jl.serving_fn(top_k=6)(Q)))
    ts, js = tl.stats(), jl.stats()
    assert ts["counters"] == js["counters"] and ts["counters"]["deletes"] == 7
    for key in STATS_KEYS:
        assert ts["index"][key] == js["index"][key], key
    assert not {1, 2, 3, 7, 8} & {i for row in tl.query_batch(X[:10], top_k=10) for i in row}
    assert tl.compact() == 5 and len(tl._storage) == 495
    np.testing.assert_array_equal(tl.serving_fn(top_k=1)(X[9:30])[:, 0], np.arange(9, 30))
