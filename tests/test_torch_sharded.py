"""Sharding: the port's ShardedDeviceStore against lshrs_tpu's on the same words.

The reference shards over 8 virtual CPU devices (tests/conftest.py); the
port over 8 copies of the CPU device (`make_mesh(devices=["cpu"] * 8)`).
Both place shard i at global slots [i*L, (i+1)*L). Collision, Hamming
(planes and packed), the top-p engines and asymmetric ranking return the
reference's ids (scores within 1e-5); the cascade matches the reference's
sharded cascade within its per-shard pools. Mirrors tests/test_sharding.py
and the sharded cases of test_cascade.py, test_asymmetric.py,
test_rerank_gather.py, test_itq.py, test_mips.py and test_fallback_paths.py.
"""

from __future__ import annotations

import logging

import numpy as np
import pytest
import torch

import lshrs_tpu_torch.parallel as tparallel
from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.parallel import ShardedDeviceStore as JaxSharded
from lshrs_tpu.parallel import make_mesh as jax_make_mesh
from lshrs_tpu.storage import IdFilter as JaxFilter
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch import IdFilter
from lshrs_tpu_torch.ops import asymmetric as tasym
from lshrs_tpu_torch.ops import hamming as tham
from lshrs_tpu_torch.ops import rerank as trerank
from lshrs_tpu_torch.ops import scan as tscan
from lshrs_tpu_torch.ops.asymmetric import QMAX4, pack_coords_int4_np, quantize_coords_np
from lshrs_tpu_torch.ops.group_max import asymmetric_shift
from lshrs_tpu_torch.parallel import SHARD_AXIS, ShardedDeviceStore, available_devices, make_mesh
from lshrs_tpu_torch.storage.device import DeviceStore

B, R, D = 4, 8, 32
P = B * R
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jmesh():
    return jax_make_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(8, devices=available_devices("cpu"))


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def _kw(**kw):
    return {"num_bands": B, "rows_per_band": R, "chunk_size": 64, "initial_capacity": 64, **kw}


def _trio(jmesh, tmesh, **kw):
    """(reference sharded, port sharded, port unsharded) stores."""
    kw = _kw(**kw)
    return JaxSharded(mesh=jmesh, **kw), ShardedDeviceStore(mesh=tmesh, **kw), DeviceStore(device="cpu", **kw)


def _load(stores, ids, words, vectors=None):
    for s in stores:
        s.add_signature_batch(ids, words, vectors)


def _same(first, *others):
    for other in others:
        for a, b in zip(first, other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_topp(first, *others):
    """Top-p results: ids and n equal, cosines of valid entries within 1e-5."""
    for other in others:
        ids, sims, n = (np.asarray(x) for x in first)
        np.testing.assert_array_equal(np.asarray(other[0]), ids)
        np.testing.assert_array_equal(np.asarray(other[2]), n)
        valid = ids >= 0
        np.testing.assert_allclose(np.asarray(other[1])[valid], sims[valid], rtol=1e-5, atol=1e-6)


def test_mesh_and_constructor(tmesh):
    assert tmesh.size == 8 and tmesh.axis_name == SHARD_AXIS == "shard"
    assert tmesh.devices == (torch.device("cpu"),) * 8
    assert make_mesh(2, devices=CPU8).devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="Requested 9 devices but only 8 available"):
        make_mesh(9, devices=available_devices("cpu"))
    with pytest.raises(ValueError, match="power-of-two"):
        ShardedDeviceStore(mesh=make_mesh(3, devices=CPU8), num_bands=B, rows_per_band=R)
    with pytest.raises(ValueError, match="device="):
        ShardedDeviceStore(mesh=tmesh, num_bands=B, rows_per_band=R, device="cpu")
    st = ShardedDeviceStore(mesh=tmesh, num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64)
    assert st.stats()["capacity"] == 8 * 64 and len(st._shards) == 8
    if not torch.cuda.is_available():
        assert available_devices("cuda") == []
        with pytest.raises(ValueError, match="at least one device"):
            make_mesh()


def test_sharded_matches_unsharded_exactly(jmesh, tmesh, hasher, rng):
    n = 600
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(50_000)[:n]
    words = hasher.hash_batch_words_host(X)
    js, ts, single = _trio(jmesh, tmesh, enable_hamming=True)
    _load((js, ts, single), ids, words)
    qw = hasher.hash_batch_words_host(rng.standard_normal((10, D)).astype(np.float32))
    _same(js.query_topk(qw, 25), ts.query_topk(qw, 25), single.query_topk(qw, 25))
    _same(js.query_hamming(qw, 25), ts.query_hamming(qw, 25), single.query_hamming(qw, 25))
    # Deeper than a shard (128 rows): the merge still returns the unsharded top-k.
    _same(single.query_topk(qw, 200), ts.query_topk(qw, 200))
    np.testing.assert_array_equal(
        ts.query_topk_ids(qw, 25).numpy(), single.query_topk_ids(qw, 25).numpy()
    )


def test_sharded_counts_match(jmesh, tmesh, hasher, rng):
    X = rng.standard_normal((200, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    js, ts, _ = _trio(jmesh, tmesh)
    _load((js, ts), np.arange(200), words)
    counts, ids = ts.query_counts(words[3:4])
    _same(js.query_counts(words[3:4]), (counts, ids))  # global slot layout
    alive = ids >= 0
    by_id = dict(zip(ids[alive].tolist(), counts[0][alive].tolist()))
    eq = (words == words[3][None, :]).reshape(200, B, -1).all(-1).sum(-1)
    assert all(by_id[i] == eq[i] for i in range(200))


def test_sharded_mutations_and_growth(jmesh, tmesh, hasher, rng):
    X = rng.standard_normal((100, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    js, ts, single = _trio(jmesh, tmesh)
    _load((js, ts, single), np.arange(100), words)
    for s in (js, ts, single):
        s.remove_indices([5])
    assert len(ts) == 99
    _, out = ts.query_topk(words[5:6], 3)
    assert 5 not in out[0]
    ts.clear()
    assert len(ts) == 0 and ts.stats()["size"] == 0
    ts.add_signature_batch(np.arange(100), words)
    ts.remove_indices([5])
    # growth across the shard-aligned capacity: every block re-splits
    before = ts.query_topk(words[:16], 5)
    X2 = rng.standard_normal((1000, D)).astype(np.float32)
    w2 = hasher.hash_batch_words_host(X2)
    _load((js, ts, single), np.arange(1000, 2000), w2)
    assert ts.stats()["capacity"] == js.stats()["capacity"] and ts.stats()["capacity"] % (8 * 64) == 0
    assert ts._local_rows() == ts.stats()["capacity"] // 8
    _, out = ts.query_topk(words[7:8], 1)
    assert out[0][0] == 7
    qw = np.concatenate([words[:16], w2[:16]])
    _same(js.query_topk(qw, 12), ts.query_topk(qw, 12), single.query_topk(qw, 12))
    after = ts.query_topk(words[:16], 5)
    assert (after[1][:, 0] == before[1][:, 0]).all()
    # upsert across shards
    _load((js, ts, single), [3, 1500], w2[:2])
    _same(js.query_topk(w2[:2], 4), ts.query_topk(w2[:2], 4), single.query_topk(w2[:2], 4))
    _same(js.state_arrays().values(), ts.state_arrays().values(), single.state_arrays().values())


def test_orchestrator_over_sharded_store(jmesh, tmesh, rng):
    X = rng.standard_normal((120, D)).astype(np.float32)
    kw = dict(num_bands=4, rows_per_band=4, chunk_size=64, initial_capacity=64)
    lsh = TorchLSHRS(dim=D, num_perm=16, num_bands=4, rows_per_band=4, hash_mode="host",
                     storage=ShardedDeviceStore(mesh=tmesh, **kw))
    jl = JaxLSHRS(dim=D, num_perm=16, num_bands=4, rows_per_band=4, hash_mode="host",
                  storage=JaxSharded(mesh=jmesh, **kw))
    ref = TorchLSHRS(dim=D, num_perm=16, num_bands=4, rows_per_band=4, hash_mode="host",
                     device="cpu", chunk_size=64, initial_capacity=64)
    for lx in (lsh, jl, ref):
        lx.index(list(range(120)), X)
    assert lsh.get_top_k(X[11], topk=3)[0] == 11
    assert lsh.stats()["backend"] == "device" and lsh.stats()["index"]["backend"] == "device-sharded"
    for q in rng.standard_normal((4, D)).astype(np.float32):
        assert lsh.query(q, top_k=None) == ref.query(q, top_k=None) == jl.query(q, top_k=None)
    Q = X[:20] + 0.3 * rng.standard_normal((20, D)).astype(np.float32)
    assert lsh.query_batch(Q, top_k=6) == jl.query_batch(Q, top_k=6)
    np.testing.assert_array_equal(lsh.serving_fn(top_k=7)(Q), np.asarray(jl.serving_fn(top_k=7)(Q)))


def test_orchestrator_shards_param(rng):
    lsh = TorchLSHRS(dim=D, num_perm=16, num_bands=4, rows_per_band=4, shards=8, chunk_size=64,
                     initial_capacity=64, device="cpu")
    assert lsh.stats()["index"]["n_shards"] == 8 and lsh._tpu_config["shards"] == 8
    assert lsh.stats()["index"]["rows_per_shard"] == 64
    X = rng.standard_normal((80, D)).astype(np.float32)
    lsh.index(list(range(80)), X)
    assert lsh.get_top_k(X[5], topk=1) == [5]
    with pytest.raises(ValueError, match="Requested 16 devices but only 8 available"):
        TorchLSHRS(dim=D, num_perm=16, num_bands=4, rows_per_band=4, shards=16, device="cpu")
    one = TorchLSHRS(dim=D, num_perm=16, num_bands=4, rows_per_band=4, shards=1, device="cpu")
    assert "n_shards" not in one.stats()["index"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax", "port_to_port"])
def test_sharded_checkpoints_load_both_ways(direction, tmp_path, rng):
    kw = dict(dim=D, num_perm=16, num_bands=4, rows_per_band=4, shards=8, chunk_size=64,
              initial_capacity=64, hash_mode="host", engine="collision")
    X = rng.standard_normal((50, D)).astype(np.float32)
    src = JaxLSHRS(**kw) if direction == "jax_to_port" else TorchLSHRS(device="cpu", **kw)
    src.index(list(range(50)), X)
    src.delete([10])
    src.save_to_disk(tmp_path / "m")
    if direction == "port_to_jax":
        back = JaxLSHRS.load_from_disk(tmp_path / "m")
    else:
        back = TorchLSHRS.load_from_disk(tmp_path / "m", device="cpu")
        assert isinstance(back._storage, ShardedDeviceStore)
    assert back.stats()["index"]["n_shards"] == 8
    for q in rng.standard_normal((3, D)).astype(np.float32):
        assert back.query(q, top_k=None) == src.query(q, top_k=None)
    assert back.query(X[10], top_k=3)[0] != 10


def test_sharded_load_downgrades_when_devices_scarce(tmp_path, rng, monkeypatch, caplog):
    lsh = TorchLSHRS(dim=D, num_perm=16, num_bands=4, rows_per_band=4, shards=8, chunk_size=64,
                     initial_capacity=64, device="cpu")
    X = rng.standard_normal((50, D)).astype(np.float32)
    lsh.index(list(range(50)), X)
    lsh.save_to_disk(tmp_path / "m")
    monkeypatch.setattr(tparallel, "available_devices", lambda device="cuda": [torch.device("cpu")])
    with caplog.at_level(logging.WARNING):
        back = TorchLSHRS.load_from_disk(tmp_path / "m", device="cpu")
    # the reference's documented downgrade: an unsharded store, the same results
    assert "restoring unsharded" in caplog.text
    assert "n_shards" not in back.stats()["index"]
    assert type(back._storage) is DeviceStore
    for q in rng.standard_normal((3, D)).astype(np.float32):
        assert lsh.query(q, top_k=None) == back.query(q, top_k=None)


def test_sharded_append_writes_in_place(tmesh, hasher, rng, monkeypatch):
    """Appends write each shard's rows in place: no re-split, no new
    tensors, every shard's tensors contiguous on its own device."""
    st = ShardedDeviceStore(mesh=tmesh, **_kw(initial_capacity=1024))
    calls = {"n": 0}
    orig = ShardedDeviceStore._grow

    def counting_grow(self, new_cap):
        calls["n"] += 1
        return orig(self, new_cap)

    monkeypatch.setattr(ShardedDeviceStore, "_grow", counting_grow)
    ptrs = [s._sig_t.data_ptr() for s in st._shards]
    X = rng.standard_normal((300, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    for j in range(0, 300, 50):  # crosses shard boundaries (128 rows each)
        st.add_signature_batch(np.arange(j, j + 50), words[j : j + 50])
    assert calls["n"] == 0 and [s._sig_t.data_ptr() for s in st._shards] == ptrs
    assert [s._size for s in st._shards] == [128, 128, 44, 0, 0, 0, 0, 0]
    for s in st._shards:
        for t in (s._sig_t, s._sig_rows, s._ids, s._tie):
            assert t.is_contiguous() and t.device == torch.device("cpu")
    _, out = st.query_topk(words[200:201], 1)
    assert out[0][0] == 200


def test_sharded_snapshot_query_fn_cross_shard_ties(jmesh, tmesh, hasher, rng):
    """The serving closure merges across shards: shard-local tie keys are
    distinct only within a shard, so (count desc, id asc) is the merge's."""
    js, ts, _ = _trio(jmesh, tmesh, initial_capacity=1024, enable_hamming=True)
    rows_per_shard = 1024 // 8
    X = rng.standard_normal((1, D)).astype(np.float32)
    w = hasher.hash_batch_words_host(X)
    filler = hasher.hash_batch_words_host(rng.standard_normal((rows_per_shard - 1, D)).astype(np.float32))
    for s in (js, ts):
        s.add_signature_batch(np.arange(1000, 1000 + rows_per_shard - 1), filler)
        s.add_signature_batch([163], w)
        s.add_signature_batch([63], w)
    assert ts._slot_of[163] // rows_per_shard != ts._slot_of[63] // rows_per_shard

    _, want = ts.query_topk(w, 2)
    got = ts.snapshot_query_fn(2, wire="words")(w).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [63, 163]
    np.testing.assert_array_equal(got, np.asarray(js.snapshot_query_fn(2, wire="words")(w)))
    assert ts.snapshot_query_fn(1, wire="words")(w).numpy()[0][0] == 63

    dense = hasher.hash_batch_dense_host(X)
    np.testing.assert_array_equal(ts.snapshot_query_fn(2, wire="dense")(dense).numpy(), want)
    got_h = ts.snapshot_query_fn(2, wire="dense", mode="hamming")(dense).numpy()
    assert got_h[0].tolist() == [63, 163]

    # dev_batch slices a batch without changing an id
    qw = np.concatenate([w, filler[:40]])
    full = ts.snapshot_query_fn(3)(qw).numpy()
    np.testing.assert_array_equal(ts.snapshot_query_fn(3, dev_batch=7)(qw).numpy(), full)
    np.testing.assert_array_equal(full, np.asarray(js.snapshot_query_fn(3, dev_batch=7)(qw)))
    with pytest.raises(ValueError, match="dev_batch"):
        ts.snapshot_query_fn(3, dev_batch=0)

    fn = ts.snapshot_query_fn(1, wire="words")
    ts.add_signature_batch([7], hasher.hash_batch_words_host(rng.standard_normal((1, D)).astype(np.float32)))
    with pytest.raises(RuntimeError, match="stale"):
        fn(w)


def test_bucket_index_invalidated_on_upsert(jmesh, tmesh, hasher, rng):
    """Upserting an id invalidates the sorted bucket index; a sharded store
    under query_mode="bucket" scans, as the reference's does."""
    st = DeviceStore(device="cpu", **_kw(initial_capacity=256, query_mode="bucket"))
    X = rng.standard_normal((20, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    st.add_signature_batch(np.arange(20), words)
    st.query_topk(words[:1], 1)  # builds the bucket index
    w_new = hasher.hash_batch_words_host(rng.standard_normal((1, D)).astype(np.float32))
    st.add_signature_batch([0], w_new)
    counts, out = st.query_topk(w_new, 1)
    assert out[0][0] == 0 and counts[0][0] == B

    js, ts, _ = _trio(jmesh, tmesh, query_mode="bucket")
    _load((js, ts), np.arange(20), words)
    _load((js, ts), [0], w_new)
    _same(js.query_topk(words[:5], 3), ts.query_topk(words[:5], 3))


def test_sharded_topp_rerank_matches_unsharded(jmesh, tmesh, hasher, rng):
    """The full top-p engine, shard by shard and merged by (cosine desc, id
    asc), equals the unsharded store and the reference's sharded store."""
    n = 400
    X = rng.standard_normal((n, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    js, ts, single = _trio(jmesh, tmesh, dim=D, store_vectors=True)
    _load((js, ts, single), np.arange(n), words, X)
    qv = X[:6]
    qw = hasher.hash_batch_words_host(qv)
    got = ts.query_topp_batch(qw, qv, 9)
    _same_topp(single.query_topp_batch(qw, qv, 9), got, js.query_topp_batch(qw, qv, 9))
    assert (got[0][:, 0] == np.arange(6)).all()
    one = ts.query_topp(qw[2:3], qv[2], 9)
    _same_topp(single.query_topp(qw[2:3], qv[2], 9), one, js.query_topp(qw[2:3], qv[2], 9))
    assert ts.stats()["rerank_engine"] == single.stats()["rerank_engine"] == "full"


def test_sharded_nnz_matches_unsharded(jmesh, tmesh, hasher, rng):
    X = rng.standard_normal((300, D)).astype(np.float32)
    X[150:200] = X[:50]  # shared signatures across shard boundaries
    words = hasher.hash_batch_words_host(X)
    js, ts, single = _trio(jmesh, tmesh)
    _load((js, ts, single), np.arange(300), words)
    qw = hasher.hash_batch_words_host(X[:7])
    want = single.query_nnz(qw)
    np.testing.assert_array_equal(ts.query_nnz(qw), want)
    np.testing.assert_array_equal(np.asarray(js.query_nnz(qw)), want)


@pytest.mark.parametrize("storage", ["planes", "packed"])
def test_sharded_hamming_group8_parity(storage, tmesh, hasher, rng):
    """Planes (B2's plain version) and packed words (B3's) per shard at
    group 8 and 1,024 rows per shard, exact ties across shards: == the
    unsharded port and the reference's unsharded store."""
    n = 900
    X = rng.standard_normal((n, D)).astype(np.float32)
    X[400:450] = X[:50]
    words = hasher.hash_batch_words_host(X)
    ids = rng.permutation(50_000)[:n]
    kw = _kw(chunk_size=1024, initial_capacity=8192, group_size=8, enable_hamming=True,
             hamming_storage=storage)
    ref, single = JaxStore(**kw), DeviceStore(device="cpu", **kw)
    ts = ShardedDeviceStore(mesh=tmesh, **kw)
    _load((ref, single, ts), ids, words)
    assert ts._local_rows() == 1024
    qw = hasher.hash_batch_words_host(X[:10])
    _same(ref.query_hamming(qw, 15), ts.query_hamming(qw, 15), single.query_hamming(qw, 15))
    planes = [s._planes for s in ts._shards]
    if storage == "planes":
        assert all(p is not None and p.shape == (1024, 32) for p in planes)
        assert ts.stats()["hamming_plane_bytes"] == single.stats()["hamming_plane_bytes"] == 8192 * 32
    else:
        assert all(p is None for p in planes) and ts.stats()["hamming_plane_bytes"] == 0


def test_sharded_snapshot_topp_fn_parity_and_staleness(jmesh, tmesh, hasher, rng):
    n = 300
    X = rng.standard_normal((n, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    js, ts, _ = _trio(jmesh, tmesh, dim=D, store_vectors=True)
    _load((js, ts), np.arange(n), words, X)
    qv = X[:5]
    qw = hasher.hash_batch_words_host(qv)
    want = ts.query_topp_batch(qw, qv, 7)
    serve = ts.snapshot_topp_fn(7, wire="words")
    _same_topp(want, serve(qw, qv), js.snapshot_topp_fn(7, wire="words")(qw, qv))
    assert (want[0][:, 0] == np.arange(5)).all()
    dense = hasher.hash_batch_dense_host(qv)
    _same_topp(want, ts.snapshot_topp_fn(7, wire="dense", dev_batch=2)(dense, qv))
    ts.add_signature_batch([999], words[:1], X[:1])
    with pytest.raises(RuntimeError, match="stale"):
        serve(qw, qv)


# -- the cascade (tests/test_cascade.py's sharded cases) --------------------

CB, CR = 8, 16  # 128 bits, a 32-bit prefix


@pytest.fixture
def chasher():
    return LSHHasher(num_bands=CB, rows_per_band=CR, dim=D, seed=42)


def _cascade_kw(cascade=32, refine=256, **kw):
    return dict(num_bands=CB, rows_per_band=CR, chunk_size=64, initial_capacity=512, group_size=8,
                enable_hamming=True, hamming_cascade=cascade, hamming_cascade_refine=refine, **kw)


@pytest.mark.parametrize("cascade,refine", [(32, 1 << 20), (64, 128)])
def test_sharded_cascade_matches_reference(cascade, refine, jmesh, tmesh, chasher, rng):
    """The port's sharded cascade == the reference's (per-shard pools). A
    pool covering each shard is the exact engine; partial pools agree with
    it near-completely (the union pool is 8x deeper)."""
    n = 2000 if refine < 1024 else 700
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(50_000)[:n]
    words = chasher.hash_batch_words_host(X)
    kw = _cascade_kw(cascade, refine)
    js, ts = JaxSharded(mesh=jmesh, **kw), ShardedDeviceStore(mesh=tmesh, **kw)
    exact = DeviceStore(device="cpu", num_bands=CB, rows_per_band=CR, chunk_size=64,
                        initial_capacity=256, group_size=8, enable_hamming=True)
    _load((js, ts, exact), ids, words)
    qw = chasher.hash_batch_words_host(rng.standard_normal((16, D)).astype(np.float32))
    got = ts.query_hamming(qw, 10)
    _same(js.query_hamming(qw, 10), got)
    want = exact.query_hamming(qw, 10)
    if refine >= n:
        _same(want, got)
    else:
        overlap = np.mean([len(set(want[1][q]) & set(got[1][q])) / 10 for q in range(16)])
        assert overlap >= 0.9, overlap
    rows = ts._local_rows()
    assert all(s._planes.shape == (rows, cascade) for s in ts._shards)  # prefix-only planes


def test_sharded_cascade_serving_closure_parity(tmesh, chasher, rng):
    cas = ShardedDeviceStore(mesh=tmesh, **_cascade_kw())
    X = rng.standard_normal((300, D)).astype(np.float32)
    words = chasher.hash_batch_words_host(X)
    cas.add_signature_batch(np.arange(300), words)
    _, expect = cas.query_hamming(words[:8], 5)
    serve = cas.snapshot_query_fn(5, mode="hamming")
    np.testing.assert_array_equal(serve(words[:8]).numpy(), expect)
    with pytest.raises(RuntimeError, match="asymmetric"):
        cas.snapshot_query_fn(5, mode="asymmetric")
    cas.add_signature_batch([999], words[:1])
    with pytest.raises(RuntimeError, match="stale"):
        serve(words[:8])


def test_sharded_cascade_mutations_and_growth(jmesh, tmesh, chasher, rng):
    kw = _cascade_kw()
    js, cas = JaxSharded(mesh=jmesh, **kw), ShardedDeviceStore(mesh=tmesh, **kw)
    X = rng.standard_normal((100, D)).astype(np.float32)
    words = chasher.hash_batch_words_host(X)
    _load((js, cas), np.arange(100), words)
    h, out = cas.query_hamming(words[5:6], 1)
    assert out[0][0] == 5 and h[0][0] == 0
    for s in (js, cas):
        s.remove_indices([5])
    _, out = cas.query_hamming(words[5:6], 3)
    assert 5 not in out[0]
    X2 = rng.standard_normal((900, D)).astype(np.float32)
    w2 = chasher.hash_batch_words_host(X2)
    _load((js, cas), np.arange(1000, 1900), w2)
    assert all(s._planes.shape[1] == 32 for s in cas._shards)
    h, out = cas.query_hamming(w2[:1], 1)
    assert out[0][0] == 1000 and h[0][0] == 0
    qw = np.concatenate([words[:8], w2[:8]])
    _same(js.query_hamming(qw, 6), cas.query_hamming(qw, 6))


def test_sharded_cascade_orchestrator(rng):
    lsh = TorchLSHRS(dim=D, num_perm=CB * CR, num_bands=CB, rows_per_band=CR, engine="hamming",
                     shards=8, chunk_size=64, initial_capacity=512, group_size=8,
                     hamming_cascade=32, hamming_cascade_refine=256, device="cpu")
    X = rng.standard_normal((200, D)).astype(np.float32)
    lsh.index(list(range(200)), X)
    assert lsh.query_hamming(X[42], top_k=5)[0][0] == 42
    assert lsh._storage.hamming_cascade == 32
    assert lsh.stats()["index"]["hamming_cascade"] == 32
    assert lsh.serving_fn(top_k=5)(X[:8])[0][0] == 0


# -- asymmetric ranking (tests/test_asymmetric.py's sharded cases) ----------


def test_sharded_asymmetric_matches_reference(jmesh, tmesh, hasher, rng):
    js, ts, single = _trio(jmesh, tmesh, enable_hamming=True)
    n = 200
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(9999)[:n]
    _load((js, ts, single), ids, hasher.hash_batch_words_host(X))
    # a shard's capacity is small enough for the exact (shift=0) regime
    assert asymmetric_shift(P, ts.stats()["capacity"] // 8) == 0
    qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(rng.standard_normal((3, D)).astype(np.float32)))
    got = ts.query_asymmetric(qi8, 5)
    _same(js.query_asymmetric(qi8, 5), got, single.query_asymmetric(qi8, 5))
    assert ts.query_asymmetric(qi8, 300)[1].shape == (3, 300)


@pytest.mark.parametrize("wire", ["words", "coords4"])
def test_sharded_snapshot_asymmetric_matches_single(wire, jmesh, tmesh, hasher, rng):
    js, ts, single = _trio(jmesh, tmesh, enable_hamming=True)
    n = 180
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(4000)[:n]
    _load((js, ts, single), ids, hasher.hash_batch_words_host(X))
    coords = hasher.hash_batch_coords_host(rng.standard_normal((5, D)).astype(np.float32))
    if wire == "coords4":
        q = pack_coords_int4_np(quantize_coords_np(coords, qmax=QMAX4)[0])
    else:
        q = quantize_coords_np(coords)[0]
    got = ts.snapshot_query_fn(6, mode="asymmetric", wire=wire)(q).numpy()
    np.testing.assert_array_equal(got, single.snapshot_query_fn(6, mode="asymmetric", wire=wire)(q).numpy())
    np.testing.assert_array_equal(got, np.asarray(js.snapshot_query_fn(6, mode="asymmetric", wire=wire)(q)))


# -- the gather engine, ITQ, MIPS, rehash (their files' sharded cases) ------


def test_sharded_gather_matches_unsharded_full(jmesh, tmesh, hasher, rng):
    """Per-shard gather (B1's plain version, the budget per shard) merged by
    cosine == the unsharded full engine on covered queries, and == the
    reference's sharded gather."""
    n = 600
    X = rng.standard_normal((n, D)).astype(np.float32)
    X[300:360] = X[:60] + 0.01 * rng.standard_normal((60, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    js, ts, single = _trio(jmesh, tmesh, dim=D, store_vectors=True, chunk_size=128,
                           initial_capacity=1024)
    _load((js, ts, single), np.arange(n), words, X)
    qv = X[:6]
    qw = hasher.hash_batch_words_host(qv)
    want = single.query_topp_batch(qw, qv, 16, engine="full")
    got = ts.query_topp_batch(qw, qv, 16, engine="gather", max_candidates=256)
    _same_topp(want, got, js.query_topp_batch(qw, qv, 16, engine="gather", max_candidates=256))
    assert ts.stats()["rerank_truncations"] == 0
    serve = ts.snapshot_topp_fn(16, engine="gather", max_candidates=256)
    _same_topp(want, serve(qw, qv))
    # a budget below the candidate sets: truncations counted, per shard
    _same_topp(js.query_topp_batch(qw, qv, 16, engine="gather", max_candidates=2),
               ts.query_topp_batch(qw, qv, 16, engine="gather", max_candidates=2))
    assert ts.stats()["rerank_truncations"] > 0
    ts.add_signature_batch([5000], words[:1], X[:1])
    with pytest.raises(RuntimeError, match="stale"):
        serve(qw, qv)


def _lowrank(rng, n, dim):
    basis = rng.standard_normal((6, dim)).astype(np.float32)
    return (rng.standard_normal((n, 6)).astype(np.float32) @ basis
            + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))


def test_retrain_sharded(rng):
    """Sharded stores retrain through the shard-local rehash: self-matches,
    and the very words of the unsharded store retrained the same way."""
    kw = dict(dim=32, store_vectors=True, num_perm=16, num_bands=4, rows_per_band=4,
              chunk_size=128, initial_capacity=512, device="cpu")
    lsh = TorchLSHRS(shards=4, **kw)
    single = TorchLSHRS(**kw)
    X = _lowrank(rng, 300, 32)
    for lx in (lsh, single):
        lx.index(list(range(300)), X)
        lx.retrain(iters=8)
    idx, count = lsh._ordered_candidates(X[9])[0]
    assert idx == 9 and count == 4
    _same(single._storage.state_arrays().values(), lsh._storage.state_arrays().values())
    np.testing.assert_allclose(lsh._storage.sample_payload_rows(64), single._storage.sample_payload_rows(64))


@pytest.mark.parametrize("family", ["structured", "gaussian"])
def test_sharded_rehash(family, jmesh, tmesh, rng):
    """A rehash rebuilds each shard's block from its payload: structured
    words == the reference's sharded rehash (the FWHT is bit-exact), and
    either family == the unsharded port."""
    X = rng.standard_normal((300, D)).astype(np.float32)
    kw = dict(dim=D, num_perm=P, num_bands=B, rows_per_band=R, store_vectors=True,
              chunk_size=64, initial_capacity=64, hash_mode="host", hash_family=family)
    lsh = TorchLSHRS(shards=8, device="cpu", **kw)
    single = TorchLSHRS(device="cpu", **kw)
    jl = JaxLSHRS(shards=8, **kw)
    lxs = (lsh, single, jl) if family == "structured" else (lsh, single)
    for lx in lxs:
        lx.index(list(range(300)), X)
        lx.delete([4])
        lx.rehash(num_bands=8, rows_per_band=4, hash_family="structured", seed=3)
    sa = lsh._storage.state_arrays()
    _same(single._storage.state_arrays().values(), sa.values())
    if family == "structured":
        np.testing.assert_array_equal(sa["sig"], jl._storage.state_arrays()["sig"])
    assert lsh.query(X[7], top_k=1) == [7] and lsh.query(X[4], top_k=1) != [4]
    assert lsh._storage.num_bands == 8 and all(s.num_bands == 8 for s in lsh._storage._shards)


def test_sharded_mips_matches_single(rng):
    """MIPS on 8 shards == the unsharded store and the reference's sharded
    store: ids equal, inner-product scores within 1e-5."""
    X = (rng.standard_normal((300, 16)) * rng.uniform(0.5, 2.0, (300, 1))).astype(np.float32)
    M = float(np.linalg.norm(X, axis=1).max())
    kw = dict(dim=16, similarity="dot", max_norm=M, num_perm=64, num_bands=8, rows_per_band=8,
              engine="collision", initial_capacity=1024, store_vectors=True, hash_mode="host")
    single = TorchLSHRS(device="cpu", **kw)
    sharded = TorchLSHRS(shards=8, device="cpu", **kw)
    jl = JaxLSHRS(shards=8, **kw)
    for lx in (single, sharded, jl):
        lx.index(np.arange(len(X)), X)
    for q in rng.standard_normal((4, 16)).astype(np.float32):
        r1, r2, r3 = single.get_above_p(q, p=1.0), sharded.get_above_p(q, p=1.0), jl.get_above_p(q, p=1.0)
        assert [i for i, _ in r1] == [i for i, _ in r2] == [i for i, _ in r3]
        for (_, s1), (_, s2), (_, s3) in zip(r1, r2, r3):
            assert s2 == pytest.approx(s1, rel=1e-5, abs=1e-6) == pytest.approx(s3, rel=1e-5, abs=1e-6)


def test_sharded_store_with_payload_rerank(tmesh, rng):
    store = ShardedDeviceStore(mesh=tmesh, num_bands=4, rows_per_band=8, dim=32,
                               store_vectors=True, chunk_size=64, initial_capacity=64)
    lsh = TorchLSHRS(dim=32, num_perm=32, num_bands=4, rows_per_band=8, storage=store)
    X = rng.standard_normal((100, 32)).astype(np.float32)
    lsh.index(list(range(100)), X)
    out = lsh.get_above_p(X[13], p=0.5)
    assert out[0][0] == 13 and abs(out[0][1] - 1.0) < 1e-4
    scores = [s for _, s in out]
    assert scores == sorted(scores, reverse=True)


# -- filters, reads, stats, the kernels' operands ------------------------------


def test_sharded_filters_match_reference_and_brute_force(jmesh, tmesh, hasher, rng):
    """where= on every mode: each shard masks its own tie column; == the
    reference's sharded store under the same filter and == an unsharded
    store holding only the admitted ids."""
    n = 500
    X = rng.standard_normal((n, D)).astype(np.float32)
    X[250:300] = X[:50]  # equal signatures in other shards
    words = hasher.hash_batch_words_host(X)
    ids = np.arange(n)
    allow, deny = ids[::3], [0, 3, 300]
    admitted = np.setdiff1d(allow, deny)
    js, ts, _ = _trio(jmesh, tmesh, dim=D, store_vectors=True, enable_hamming=True)
    _load((js, ts), ids, words, X)
    sub = DeviceStore(device="cpu", **_kw(dim=D, store_vectors=True, enable_hamming=True,
                                          initial_capacity=1024))
    sub.add_signature_batch(admitted, words[admitted], X[admitted])
    tf, jf = IdFilter(allowed_ids=allow, disallowed_ids=deny), JaxFilter(allowed_ids=allow, disallowed_ids=deny)
    qv = X[:6] + 0.1 * rng.standard_normal((6, D)).astype(np.float32)
    qw = hasher.hash_batch_words_host(qv)
    qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(qv))
    got = ts.query_topk(qw, 8, where=tf)
    _same(js.query_topk(qw, 8, where=jf), got, sub.query_topk(qw, 8))
    got = ts.query_hamming(qw, 8, where=tf)
    _same(js.query_hamming(qw, 8, where=jf), got, sub.query_hamming(qw, 8))
    _same(js.query_asymmetric(qi8, 8, where=jf), ts.query_asymmetric(qi8, 8, where=tf))
    assert np.isin(ts.query_asymmetric(qi8, 8, where=tf)[1], np.append(admitted, -1)).all()
    for eng in ("full", "gather"):
        _same_topp(js.query_topp_batch(qw, qv, 8, engine=eng, where=jf),
                   ts.query_topp_batch(qw, qv, 8, engine=eng, where=tf))
    np.testing.assert_array_equal(ts.query_nnz(qw, where=tf), sub.query_nnz(qw))
    # cached per generation, recomputed after a delete
    state = tf.device_state(ts)
    assert all(a is b for a, b in zip(tf.device_state(ts)[0], state[0]))
    ts.remove_indices([int(admitted[5])])
    assert tf.device_state(ts)[0][0] is not state[0][0]
    out = ts.snapshot_query_fn(8, where=tf)(qw).numpy()
    assert np.isin(out, np.append(np.setdiff1d(admitted, [admitted[5]]), -1)).all()


def test_sharded_reads_match_unsharded(tmesh, hasher, rng):
    """get_vectors, sample_payload_rows, get_bucket, compact and stats read
    across shards as the unsharded store reads its one block."""
    n = 300
    X = rng.standard_normal((n, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    kw = _kw(dim=D, store_vectors=True, payload_dtype="int8", enable_hamming=True)
    ts, single = ShardedDeviceStore(mesh=tmesh, **kw), DeviceStore(device="cpu", **kw)
    _load((ts, single), np.arange(n), words, X)
    for s in (ts, single):
        s.remove_indices([1, 150, 299])
        s.query_hamming(words[:2], 3)  # builds the bitplanes
    pick = [298, 0, 140, 7]
    np.testing.assert_array_equal(ts.get_vectors(pick), single.get_vectors(pick))
    with pytest.raises(KeyError):
        ts.get_vectors([150])
    np.testing.assert_array_equal(ts.sample_payload_rows(50), single.sample_payload_rows(50))
    band = words[10, 1].tobytes()[:1]
    assert ts.get_bucket(1, band) == single.get_bucket(1, band) and 10 in ts.get_bucket(1, band)
    a, b = ts.stats(), single.stats()
    for key in ("size", "alive", "tombstones", "capacity", "payload_bytes", "hamming_plane_bytes",
                "signature_bytes", "fast_path", "rerank_engine"):
        assert a[key] == b[key], key
    assert (a["backend"], a["n_shards"], a["rows_per_shard"]) == ("device-sharded", 8, 64)
    assert ts.compact() == single.compact() == 3
    _same(single.state_arrays().values(), ts.state_arrays().values())
    _same(single.query_topk(words[:9], 4), ts.query_topk(words[:9], 4))


def test_shard_tensors_handed_to_kernels_are_contiguous(tmesh, hasher, rng, monkeypatch):
    """Every per-shard operand a kernel wrapper receives is contiguous: the
    CUDA wrappers refuse strided views (kernel B2's TMA needs aligned rows),
    which the plain versions on the CPU would accept."""
    calls = {}

    def checked(name, fn):
        def wrapper(*args, **kwargs):
            for t in args:
                if isinstance(t, torch.Tensor):
                    assert t.is_contiguous(), f"{name}: a strided operand of shape {tuple(t.shape)}"
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)
        return wrapper

    for mod, name in [(tscan, "group_max_keys"), (trerank, "group_max_keys"),
                      (tham, "hamming_group_max_keys"), (tham, "hamming_packed_group_max_keys"),
                      (tasym, "hamming_group_max_keys")]:
        monkeypatch.setattr(mod, name, checked(name, getattr(mod, name)))
    X = rng.standard_normal((400, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    qw = words[:5]
    qi8, _ = quantize_coords_np(hasher.hash_batch_coords_host(X[:5]))
    for extra in (dict(), dict(hamming_storage="packed")):
        st = ShardedDeviceStore(mesh=tmesh, **_kw(dim=D, store_vectors=True, enable_hamming=True,
                                                  **extra))
        st.add_signature_batch(np.arange(400), words, X)
        st.query_topk(qw, 5)
        st.query_hamming(qw, 5)
        st.query_topp_batch(qw, X[:5], 5, engine="gather")
        if not extra:
            st.query_asymmetric(qi8, 5)
    cas = ShardedDeviceStore(mesh=tmesh, **_kw(enable_hamming=True, hamming_cascade=32,
                                               num_bands=4, rows_per_band=16))
    cw = LSHHasher(num_bands=4, rows_per_band=16, dim=D, seed=1).hash_batch_words_host(X)
    cas.add_signature_batch(np.arange(400), cw)
    cas.query_hamming(cw[:5], 5)
    assert set(calls) == {"group_max_keys", "hamming_group_max_keys", "hamming_packed_group_max_keys"}


def test_sharded_store_under_threads(tmesh, hasher, rng):
    """Appends, deletes and queries from more threads than cores, the
    switch interval shortened: the store's lock keeps every write (no lost
    update across shards) and every query sees a consistent store."""
    import sys
    import threading

    st = ShardedDeviceStore(mesh=tmesh, **_kw(initial_capacity=64))
    n_threads, per = 12, 40
    X = rng.standard_normal((n_threads * per, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    errors = []

    def work(t):
        try:
            for j in range(0, per, 8):
                lo = t * per + j
                st.add_signature_batch(np.arange(lo, lo + 8), words[lo : lo + 8])
                st.query_topk(words[lo : lo + 8], 3)
            st.remove_indices([t * per])
        except Exception as e:  # recorded and asserted below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(st) == n_threads * (per - 1) and st.stats()["tombstones"] == n_threads
    alive = np.setdiff1d(np.arange(n_threads * per), np.arange(0, n_threads * per, per))
    _, out = st.query_topk(words[alive], 1)
    assert (out[:, 0] == alive).all()
    state = st.state_arrays()
    assert sorted(state["ids"][state["ids"] >= 0].tolist()) == alive.tolist()
