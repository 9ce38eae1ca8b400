"""Bucket backends: the port's memory and Redis stores against the JAX
package's on the same seeded inputs.

``backend="memory"`` and ``backend="redis"`` (on a dict-backed fake
``redis`` module: sadd / smembers / srem / scan_iter / delete / pipeline,
no server) hash on the host with the same NumPy code in both packages, so
bucket contents, Redis key sets and every answer must be identical: top-k,
``top_k=None`` order, ``get_top_k``, ``query_batch``, top-p through
``vector_fetch_fn`` (scores within 1e-6), ``where=``, ``multiprobe``, delete
and clear. The memory backend is also held to the port's own device
backend under ``hash_mode="host"``. The reference's Redis pooling mocks and
buffer semantics are mirrored on the port.
"""

from __future__ import annotations

import fnmatch
import sys
import types
from unittest.mock import MagicMock

import numpy as np
import pytest

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.storage import DeviceStore, IdFilter, MemoryStorage

DIM = 24
KW = dict(dim=DIM, num_perm=32, num_bands=8, rows_per_band=4, seed=11)


class FakeRedisServer:
    """A Redis keyspace of sets: str keys, bytes members (as redis-py
    returns them without ``decode_responses``)."""

    def __init__(self):
        self.sets: dict[str, set[bytes]] = {}


class FakePipeline:
    def __init__(self, client):
        self.client = client
        self.calls = []

    def sadd(self, key, *members):
        self.calls.append(("sadd", key, members))

    def srem(self, key, *members):
        self.calls.append(("srem", key, members))

    def execute(self):
        out = [getattr(self.client, name)(key, *members) for name, key, members in self.calls]
        self.calls = []
        return out

    def reset(self):
        self.calls = []


class FakeRedis:
    def __init__(self, *, connection_pool):
        kw = connection_pool.kwargs
        self.pool = connection_pool
        self.server = connection_pool.module.servers.setdefault(
            (kw["host"], kw["port"], kw["db"]), FakeRedisServer()
        )

    @staticmethod
    def _key(key) -> str:
        return key.decode() if isinstance(key, bytes) else str(key)

    def sadd(self, key, *members):
        s = self.server.sets.setdefault(self._key(key), set())
        n = len(s)
        s.update(str(m).encode() for m in members)
        return len(s) - n

    def smembers(self, key):
        return set(self.server.sets.get(self._key(key), set()))

    def srem(self, key, *members):
        key = self._key(key)
        s = self.server.sets.get(key, set())
        n = len(s)
        s.difference_update(str(m).encode() for m in members)
        if not s:
            self.server.sets.pop(key, None)  # Redis drops an emptied set
        return n - len(s)

    def scan_iter(self, match="*", count=None):
        for key in sorted(self.server.sets):
            if fnmatch.fnmatchcase(key, match):
                yield key.encode()

    def delete(self, *keys):
        return sum(self.server.sets.pop(self._key(k), None) is not None for k in keys)

    def pipeline(self, transaction=True):
        return FakePipeline(self)


@pytest.fixture
def fake_redis(monkeypatch):
    """A dict-backed ``redis`` module; ``module.servers[(host, port, db)]``
    holds each keyspace."""
    mod = types.ModuleType("redis")
    mod.servers = {}

    class ConnectionPool:
        def __init__(self, **kwargs):
            self.kwargs = kwargs
            self.module = mod
            self.disconnected = 0

        def disconnect(self):
            self.disconnected += 1

    mod.ConnectionPool = ConnectionPool
    mod.Redis = FakeRedis
    monkeypatch.setitem(sys.modules, "redis", mod)
    return mod


def _data(n=300, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((12, DIM)).astype(np.float32)
    X = centers[rng.integers(0, 12, n)] + 0.5 * rng.standard_normal((n, DIM)).astype(np.float32)
    ids = (5 * np.arange(n) + 1).astype(np.int64)
    Q = X[rng.integers(0, n, 12)] + 0.3 * rng.standard_normal((12, DIM)).astype(np.float32)
    return X.astype(np.float32), ids, Q.astype(np.float32)


def _pair(backend, **kw):
    kw = {**KW, **kw}
    if backend == "redis":
        # One fake server per package (db 0 and 1) under the same prefix.
        return (JaxLSHRS(backend="redis", redis_db=0, **kw),
                TorchLSHRS(backend="redis", redis_db=1, device="cpu", **kw))
    return JaxLSHRS(backend=backend, **kw), TorchLSHRS(backend=backend, device="cpu", **kw)


def _contents(lsh):
    st = lsh._storage
    if isinstance(st, MemoryStorage) or type(st).__name__ == "MemoryStorage":
        return {k: set(v) for k, v in st.data.items() if v}
    kw = st._pool.kwargs
    return {k: set(v) for k, v in st._pool.module.servers[(kw["host"], kw["port"], kw["db"])]
            .sets.items()}


def _fetch(X, ids):
    pos = {int(i): j for j, i in enumerate(ids)}
    return lambda idx: X[[pos[int(i)] for i in idx]]


def _same_scored(got, want, tol=1e-6):
    assert [i for i, _ in got] == [i for i, _ in want]
    assert all(isinstance(s, float) for _, s in got)
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=tol, rtol=0)


BACKENDS = ["memory", "redis"]


@pytest.fixture(params=BACKENDS)
def backend(request, fake_redis):
    return request.param


@pytest.fixture
def built(backend):
    X, ids, Q = _data()
    jl, tl = _pair(backend, vector_fetch_fn=_fetch(X, ids))
    for lsh in (jl, tl):
        lsh.index(ids[:200], X[:200])
        for i in range(200, 230):  # buffered single ingests, then a flush
            lsh.ingest(int(ids[i]), X[i])
        lsh.flush()
    return jl, tl, X, ids, Q


def test_bucket_contents_and_keys_match(built):
    jl, tl, *_ = built
    got, want = _contents(tl), _contents(jl)
    assert got == want and len(got) > 8
    assert tl.stats()["backend"] == jl.stats()["backend"]
    assert tl.stats()["counters"] == jl.stats()["counters"]
    assert "index" not in tl.stats() and tl.stats()["device"] is None


def test_topk_and_enumeration_match(built):
    jl, tl, X, ids, Q = built
    for q in np.concatenate([Q, X[:4]]):
        assert tl.query(q, top_k=7) == jl.query(q, top_k=7)
        assert tl.query(q, top_k=None) == jl.query(q, top_k=None)
        assert tl.get_top_k(q, topk=3) == jl.get_top_k(q, topk=3)
    assert tl.query_batch(Q, top_k=6) == jl.query_batch(Q, top_k=6)
    assert tl.stats()["counters"]["queries_served"] == jl.stats()["counters"]["queries_served"]
    assert int(ids[2]) in tl.query(X[2], top_k=5)
    assert tl.query_batch(Q[:3], top_k=6) == [tl.query(q, top_k=6) for q in Q[:3]]
    with pytest.raises(ValueError, match="top_k"):
        tl.query_batch(Q[:2], top_k=0)
    with pytest.raises(ValueError, match="top_k"):
        tl.query(Q[0], top_k=0)


@pytest.mark.parametrize("p,top_k", [(0.3, None), (1.0, 5), (0.05, None)])
def test_topp_through_the_fetch_fn_matches(built, p, top_k):
    jl, tl, X, ids, Q = built
    for q in np.concatenate([Q[:6], X[:2]]):
        _same_scored(tl.query(q, top_p=p, top_k=top_k), jl.query(q, top_p=p, top_k=top_k))
        _same_scored(tl.get_above_p(q, p=p), jl.get_above_p(q, p=p))
    got = tl.get_above_p_batch(Q[:4], p=p, top_k=top_k)
    want = jl.get_above_p_batch(Q[:4], p=p, top_k=top_k)
    for g, w in zip(got, want):
        _same_scored(g, w)
    assert tl.get_above_p(X[1], p=0.2)[0][0] == int(ids[1])


def test_where_filters_match(built):
    jl, tl, X, ids, Q = built
    from lshrs_tpu.storage import IdFilter as JaxIdFilter

    rng = np.random.default_rng(5)
    kw = dict(allowed_ids=ids[rng.random(len(ids)) < 0.4], disallowed_ids=ids[:3])
    flt, jflt = IdFilter(**kw), JaxIdFilter(**kw)
    allow = ids[::3].tolist()
    for q in np.concatenate([Q, X[:3]]):
        got = tl.query(q, top_k=None, where=flt)
        assert got == jl.query(q, top_k=None, where=jflt)
        assert flt.admits(got).all()
        assert tl.query(q, top_k=5, where=allow) == jl.query(q, top_k=5, where=allow)
        _same_scored(tl.query(q, top_p=0.5, where=flt), jl.query(q, top_p=0.5, where=jflt))
    assert tl.query_batch(Q, top_k=4, where=flt) == jl.query_batch(Q, top_k=4, where=jflt)
    assert tl.query(X[0], top_k=3, where=[]) == []


@pytest.mark.parametrize("probes", [2, 4])
def test_multiprobe_matches(backend, probes):
    X, ids, Q = _data(seed=1)
    jl, tl = _pair(backend, multiprobe=probes, vector_fetch_fn=_fetch(X, ids))
    base_j, base_t = _pair(backend, redis_prefix="base")
    for lsh in (jl, tl, base_j, base_t):
        lsh.index(ids, X)
    for q in Q:
        got = tl.query(q, top_k=None)
        assert got == jl.query(q, top_k=None)
        assert tl.query(q, top_k=6) == jl.query(q, top_k=6)
        _same_scored(tl.query(q, top_p=0.4), jl.query(q, top_p=0.4))
        assert set(base_t.query(q, top_k=None)) <= set(got)  # probing only adds
    assert tl.query_batch(Q, top_k=5) == jl.query_batch(Q, top_k=5)
    assert tl.stats()["multiprobe"] == probes


def test_delete_and_clear_match(built):
    jl, tl, X, ids, Q = built
    gone = [int(i) for i in ids[:40:2]]
    for lsh in (jl, tl):
        lsh.delete(gone)
        lsh.delete(int(ids[41]))
    assert _contents(tl) == _contents(jl)
    gone.append(int(ids[41]))
    for q in np.concatenate([Q, X[:42]]):
        got = tl.query(q, top_k=None)
        assert got == jl.query(q, top_k=None)
        assert not set(got) & set(gone)
    assert tl.stats()["counters"]["deletes"] == jl.stats()["counters"]["deletes"] == 21
    for lsh in (jl, tl):
        lsh.ingest(7, X[0])  # buffered: clear flushes it first, then drops all
        lsh.clear()
    assert _contents(tl) == _contents(jl) == {}
    assert tl.query(X[0], top_k=None) == [] and tl.stats()["buffered_operations"] == 0


@pytest.mark.parametrize("call", [
    lambda lsh, x: lsh.query_hamming(x[0]),
    lambda lsh, x: lsh.query_hamming_batch(x),
    lambda lsh, x: lsh.query_asymmetric(x[0]),
    lambda lsh, x: lsh.query_asymmetric_batch(x),
    lambda lsh, x: lsh.serving_fn(top_k=3),
    lambda lsh, x: lsh.serving_fn(top_k=3, mode="topp", auto_refresh=True),
    lambda lsh, x: lsh.rehash(num_bands=4, rows_per_band=8),
    lambda lsh, x: lsh.retrain(),
], ids=["query_hamming", "query_hamming_batch", "query_asymmetric", "query_asymmetric_batch",
        "serving_fn", "serving_fn_topp", "rehash", "retrain"])
def test_device_only_entry_points_raise(backend, call):
    X, ids, _ = _data(40)
    jl, tl = _pair(backend)
    for lsh in (jl, tl):
        lsh.index(ids, X)
    with pytest.raises(RuntimeError) as want:
        call(jl, X[:2])
    with pytest.raises(RuntimeError) as got:
        call(tl, X[:2])
    assert str(got.value) == str(want.value)
    assert "device backend" in str(got.value)


def test_compact_and_cascade_need_the_device_backend(backend):
    jl, tl = _pair(backend)
    with pytest.raises(RuntimeError, match="compact requires the device backend"):
        tl.compact()
    for cls, kw in ((JaxLSHRS, {}), (TorchLSHRS, {"device": "cpu"})):
        with pytest.raises(ValueError, match="hamming_cascade applies to the device backend"):
            cls(backend=backend, hamming_cascade=16, **KW, **kw)
        with pytest.raises(ValueError, match="hamming_cascade applies to the device backend"):
            cls(storage=MemoryStorage(), hamming_cascade=16, **KW, **kw)


def test_bucket_backends_allocate_nothing_on_a_device(backend, monkeypatch):
    """No tensor is made anywhere: the hasher stays on the host (its device
    operand is never built) and the store holds Python sets."""
    import torch

    X, ids, Q = _data(50)
    for name in ("empty", "zeros", "full", "tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, lambda *a, **k: pytest.fail("a tensor was made"))
    tl = TorchLSHRS(backend=backend, **KW)  # device defaults to "cuda"
    tl.index(ids, X)
    tl.ingest(999, X[0])
    tl.query(Q[0], top_k=3)
    assert tl._hasher._proj_dev is None and tl.stats()["device"] is None
    assert tl.stats()["ranking"] == "collision"
    assert tl.stats()["engine_resolved"] is None


def test_memory_matches_the_device_backend(rng):
    """Mirror of tests/test_core.py::test_backends_agree_exactly: the port's
    device store under hash_mode="host" answers as the memory buckets."""
    X = rng.standard_normal((150, 32)).astype(np.float32)
    kw = dict(dim=32, num_bands=4, rows_per_band=4, num_perm=16, seed=42)
    a = TorchLSHRS(backend="memory", device="cpu", **kw)
    b = TorchLSHRS(hash_mode="host", engine="collision", chunk_size=128, initial_capacity=128,
                   device="cpu", **kw)
    a.index(list(range(150)), X)
    b.index(list(range(150)), X)
    for _ in range(10):
        q = rng.standard_normal(32).astype(np.float32)
        assert a.query(q, top_k=None) == b.query(q, top_k=None)
        assert a.get_top_k(q, topk=7) == b.get_top_k(q, topk=7)
    assert a.query_batch(X[:8], top_k=5) == b.query_batch(X[:8], top_k=5)


def test_custom_and_device_storage_arguments(rng):
    X = rng.standard_normal((60, DIM)).astype(np.float32)
    mem = MemoryStorage()
    jl, tl = JaxLSHRS(storage=MemoryStorage(), **KW), TorchLSHRS(storage=mem, **KW)
    for lsh in (jl, tl):
        lsh.index(list(range(60)), X)
    assert tl.stats()["backend"] == jl.stats()["backend"] == "custom"
    assert tl._storage is mem and mem.data == jl._storage.data
    store = DeviceStore(num_bands=8, rows_per_band=4, dim=DIM, store_vectors=True,
                        chunk_size=128, initial_capacity=128, device="cpu")
    dl = TorchLSHRS(storage=store, hash_mode="host", engine="collision", **KW)  # device="cuda"
    dl.index(list(range(60)), X)
    assert dl.stats()["backend"] == "device" and dl.stats()["device"] == "cpu"
    assert dl._hasher.device == store.device and dl._store_vectors
    assert dl.get_above_p(X[9], p=0.3)[0][0] == 9
    assert dl.query(X[3], top_k=None) == tl.query(X[3], top_k=None)


def test_mips_bucket_backend_matches(rng):
    """MIPS on the memory backend: the same candidates as the reference's
    memory backend and as the port's device backend (host hash)."""
    X = rng.standard_normal((200, DIM)).astype(np.float32)
    X *= (rng.uniform(0.5, 2.0, 200) / np.linalg.norm(X, axis=1))[:, None].astype(np.float32)
    kw = dict(dim=DIM, similarity="dot", max_norm=2.5, num_perm=64, num_bands=8,
              rows_per_band=8, vector_fetch_fn=lambda ids: X[list(ids)])
    jl = JaxLSHRS(backend="memory", **kw)
    tl = TorchLSHRS(backend="memory", device="cpu", **kw)
    dl = TorchLSHRS(hash_mode="host", engine="collision", device="cpu", **kw)
    for lsh in (jl, tl, dl):
        lsh.index(np.arange(200), X)
    for q in rng.standard_normal((5, DIM)).astype(np.float32):
        assert tl.query(q, top_k=None) == jl.query(q, top_k=None) == dl.query(q, top_k=None)
        _same_scored(tl.query(q, top_p=0.5), jl.query(q, top_p=0.5), tol=1e-5)


# ---------------------------------------------------------------------------
# Redis pooling, keys and pipelining (the reference's MagicMock suite)
# ---------------------------------------------------------------------------


@pytest.fixture
def mock_redis(monkeypatch):
    mod = types.ModuleType("redis")
    mod.ConnectionPool = MagicMock(name="ConnectionPool")
    mod.Redis = MagicMock(name="Redis")
    monkeypatch.setitem(sys.modules, "redis", mod)
    return mod


@pytest.fixture
def storage_cls():
    from lshrs_tpu_torch.storage import RedisStorage

    return RedisStorage


def test_redis_pool_configuration(mock_redis, storage_cls):
    storage_cls(host="redis.example", port=6380, db=3, password="pw", prefix="idx",
                max_connections=17, decode_responses=True)
    kwargs = mock_redis.ConnectionPool.call_args.kwargs
    assert kwargs == dict(host="redis.example", port=6380, db=3, password="pw",
                          decode_responses=True, max_connections=17,
                          socket_connect_timeout=5, socket_timeout=5, retry_on_timeout=True)
    pool = mock_redis.ConnectionPool.return_value
    assert mock_redis.Redis.call_args.kwargs["connection_pool"] is pool


def test_redis_close_disconnects_pool(mock_redis, storage_cls):
    st = storage_cls()
    st.close()
    mock_redis.ConnectionPool.return_value.disconnect.assert_called_once()
    assert st.client is mock_redis.Redis.return_value


def test_lshrs_passes_the_redis_arguments(mock_redis):
    TorchLSHRS(dim=8, num_perm=4, num_bands=2, rows_per_band=2, backend="redis",
               redis_host="h", redis_port=1, redis_db=2, redis_password="pw",
               redis_max_connections=7, redis_prefix="p", decode_responses=True)
    kwargs = mock_redis.ConnectionPool.call_args.kwargs
    assert (kwargs["host"], kwargs["port"], kwargs["db"], kwargs["password"],
            kwargs["max_connections"], kwargs["decode_responses"]) == ("h", 1, 2, "pw", 7, True)


def test_redis_missing_module_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "redis", None)
    with pytest.raises(ImportError, match="redis-py is required"):
        TorchLSHRS(dim=8, num_perm=4, num_bands=2, rows_per_band=2, backend="redis")


def test_redis_storage_resolves_lazily():
    import lshrs_tpu_torch.storage as st

    assert "RedisStorage" in st.__all__
    assert st.RedisStorage.__module__ == "lshrs_tpu_torch.storage.redis"
    with pytest.raises(AttributeError):
        st.NoSuchStorage  # noqa: B018


def test_redis_bucket_key_schema(mock_redis, storage_cls):
    from lshrs_tpu.storage.redis import RedisStorage as JaxRedisStorage

    st, ref = storage_cls(prefix="lsh"), JaxRedisStorage(prefix="lsh")
    assert st.bucket_key(3, b"\xab\xcd") == "lsh:3:bucket:abcd"
    for band, sig in ((0, b"\x00"), (15, b"\xff\x01"), (2, "text")):
        assert st.bucket_key(band, sig) == ref.bucket_key(band, sig)


def test_redis_batch_add_pipelines_one_round_trip(mock_redis, storage_cls):
    st = storage_cls(prefix="lsh")
    pipe = st._client.pipeline.return_value
    st.batch_add([(0, b"\x01", 10), (1, b"\x02", 10), (0, b"\x01", 11)])
    st._client.pipeline.assert_called_once_with(transaction=False)
    assert pipe.sadd.call_count == 3
    pipe.sadd.assert_any_call("lsh:0:bucket:01", 10)
    pipe.execute.assert_called_once()
    st.add_to_bucket(2, b"\x03", 4)
    st._client.sadd.assert_called_once_with("lsh:2:bucket:03", 4)


def test_redis_batch_add_empty_is_noop(mock_redis, storage_cls):
    st = storage_cls()
    st.batch_add([])
    st._client.pipeline.assert_not_called()


def test_redis_get_bucket_coerces_ints(mock_redis, storage_cls):
    st = storage_cls(prefix="lsh")
    st._client.smembers.return_value = {b"4", b"7"}
    assert st.get_bucket(0, b"\x01") == {4, 7}
    st._client.smembers.assert_called_once_with("lsh:0:bucket:01")


def test_redis_remove_indices_scans_and_srems(mock_redis, storage_cls):
    st = storage_cls(prefix="lsh")
    st._client.scan_iter.return_value = iter(["lsh:0:bucket:01", "lsh:1:bucket:02"])
    pipe = st._client.pipeline.return_value
    st.remove_indices([5, 6])
    st._client.scan_iter.assert_called_once_with(match="lsh:*:bucket:*", count=1000)
    assert pipe.srem.call_count == 2
    pipe.srem.assert_any_call("lsh:0:bucket:01", 5, 6)
    pipe.execute.assert_called_once()
    st.remove_indices([])
    assert st._client.scan_iter.call_count == 1  # nothing to remove: no scan


def test_redis_clear_deletes_prefix_keys(mock_redis, storage_cls):
    st = storage_cls(prefix="lsh")
    st._client.scan_iter.return_value = iter(["lsh:a", "lsh:b"])
    st.clear()
    st._client.scan_iter.assert_called_once_with(match="lsh:*", count=1000)
    st._client.delete.assert_called_once_with("lsh:a", "lsh:b")
    st._client.scan_iter.return_value = iter([])
    st.clear()
    st._client.delete.assert_called_once()  # no keys: no DEL


@pytest.mark.parametrize("fail", [False, True])
def test_redis_pipeline_contextmanager(mock_redis, storage_cls, fail):
    st = storage_cls()
    pipe = st._client.pipeline.return_value
    if fail:
        with pytest.raises(RuntimeError):
            with st.pipeline():
                raise RuntimeError("boom")
        pipe.execute.assert_not_called()
    else:
        with st.pipeline() as p:
            assert p is pipe
        pipe.execute.assert_called_once()
    pipe.reset.assert_called_once()


def test_redis_prefixes_keep_indexes_apart(fake_redis):
    X, ids, Q = _data(80)
    a = TorchLSHRS(backend="redis", redis_prefix="a", device="cpu", **KW)
    b = TorchLSHRS(backend="redis", redis_prefix="b", device="cpu", **KW)
    a.index(ids, X)
    b.index(ids[:10], X[:10])
    assert all(k.startswith(("a:", "b:")) for k in _contents(a))
    b.clear()
    assert _contents(a) and all(k.startswith("a:") for k in _contents(a))
    assert int(ids[20]) in a.query(X[20], top_k=5) and b.query(X[3], top_k=1) == []
    b.close()
    assert b._storage._pool.disconnected == 1


# ---------------------------------------------------------------------------
# buffer semantics (the reference's tests/test_buffer_semantics.py)
# ---------------------------------------------------------------------------


def _small(storage=None, buffer_size=100):
    return TorchLSHRS(dim=4, num_bands=2, rows_per_band=2, num_perm=4, buffer_size=buffer_size,
                      storage=storage or MemoryStorage())


def test_single_ingest_not_immediately_queryable():
    lsh = _small()
    vec = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    lsh.ingest(0, vec)
    assert len(lsh._storage.batches) == 0 and lsh.query(vec, top_k=1) == []
    lsh.flush()
    assert len(lsh._storage.batches) == 1 and lsh.query(vec, top_k=1) == [0]


def test_batch_index_auto_flushes():
    lsh = _small()
    vecs = np.eye(4, dtype=np.float32)
    lsh.index([0, 1, 2, 3], vecs)
    assert sum(len(b) for b in lsh._storage.batches) == 8  # 4 vectors * 2 bands
    assert lsh.query(vecs[0], top_k=1) == [0]


def test_buffer_flush_on_full():
    lsh = _small(buffer_size=4)  # 4 operations: the second vector flushes
    vec = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    lsh.ingest(0, vec)
    assert len(lsh._storage.batches) == 0 and lsh.stats()["buffered_operations"] == 2
    lsh.ingest(1, vec)
    assert len(lsh._storage.batches) == 1 and len(lsh._storage.batches[0]) == 4


def test_close_and_context_manager_flush():
    lsh = _small()
    lsh.ingest(0, np.ones(4, np.float32))
    lsh.close()
    assert len(lsh._storage.batches) == 1 and lsh._storage.close_called
    store = MemoryStorage()
    with _small(storage=store) as lsh:
        lsh.ingest(3, np.ones(4, np.float32))
    assert store.close_called and store.total_operations == 2


def test_flush_empty_buffer_is_noop():
    lsh = _small()
    lsh.flush()
    assert lsh._storage.batch_add_call_count == 0


def test_flush_failure_keeps_order_and_restores_buffer():
    failing = MemoryStorage(fail_on_flush=True)
    lsh = _small(storage=failing)
    lsh.ingest(0, np.array([1, 0, 0, 0], np.float32))
    lsh.ingest(1, np.array([0, 1, 0, 0], np.float32))
    with pytest.raises(ConnectionError):
        lsh.flush()
    assert lsh.stats()["buffered_operations"] == 4
    failing._fail_on_flush = False
    lsh.flush()
    assert [op[2] for op in failing.all_operations] == [0, 0, 1, 1]
    assert lsh.stats()["buffered_operations"] == 0


def test_bucket_operations_match_the_reference():
    """The flushed BucketOperation tuples are the reference's, in order."""
    X, ids, _ = _data(30)
    from lshrs_tpu.storage.memory import MemoryStorage as JaxMemoryStorage

    ref, port = JaxMemoryStorage(), MemoryStorage()
    jl, tl = JaxLSHRS(storage=ref, **KW), TorchLSHRS(storage=port, **KW)
    for lsh in (jl, tl):
        lsh.index(ids[:20], X[:20])
        for i in range(20, 30):
            lsh.ingest(int(ids[i]), X[i])
        lsh.flush()
    assert port.all_operations == ref.all_operations
    assert [len(b) for b in port.batches] == [len(b) for b in ref.batches]
    assert all(isinstance(op[1], bytes) for op in port.all_operations)
