"""Persistence of the connection settings and of bucket backends, against
the JAX package.

The Redis password is redacted in ``metadata.json`` and kept by pickling;
``load_from_disk`` takes a ``redis_config=`` override and a ``storage=``;
a ``"custom"`` store restores onto a memory store; the instance's own
``redis_*`` settings (not defaults) are written, so checkpoints of memory,
Redis and device instances with a non-default ``redis_prefix`` cross the
two packages both ways. Redis runs on a dict-backed fake ``redis`` module.
"""

from __future__ import annotations

import fnmatch
import json
import pickle
import sys
import types

import numpy as np
import pytest

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.storage.memory import MemoryStorage as JaxMemoryStorage
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.storage import DeviceStore, MemoryStorage

DIM = 16
KW = dict(dim=DIM, num_perm=32, num_bands=8, rows_per_band=4, seed=7)
REDIS = dict(redis_host="cache.example", redis_port=6390, redis_db=2, redis_password="hunter2",
             redis_prefix="idx", redis_max_connections=9, decode_responses=False)


class _FakeRedis:
    def __init__(self, *, connection_pool):
        kw = connection_pool.kwargs
        self.sets = connection_pool.servers.setdefault((kw["host"], kw["port"], kw["db"]), {})

    def sadd(self, key, *members):
        self.sets.setdefault(key, set()).update(str(m).encode() for m in members)

    def smembers(self, key):
        return set(self.sets.get(key, set()))

    def srem(self, key, *members):
        key = key.decode() if isinstance(key, bytes) else key
        self.sets.get(key, set()).difference_update(str(m).encode() for m in members)

    def scan_iter(self, match="*", count=None):
        return [k.encode() for k in sorted(self.sets) if fnmatch.fnmatchcase(k, match)]

    def delete(self, *keys):
        for k in keys:
            self.sets.pop(k.decode() if isinstance(k, bytes) else k, None)

    def pipeline(self, transaction=True):
        client, calls = self, []

        class _Pipe:
            def sadd(self, *a):
                calls.append(("sadd", a))

            def srem(self, *a):
                calls.append(("srem", a))

            def execute(self):
                for name, a in calls:
                    getattr(client, name)(*a)
                calls.clear()

            def reset(self):
                calls.clear()

        return _Pipe()


@pytest.fixture
def fake_redis(monkeypatch):
    mod = types.ModuleType("redis")
    mod.servers = {}

    class ConnectionPool:
        def __init__(self, **kwargs):
            self.kwargs, self.servers = kwargs, mod.servers

        def disconnect(self):
            pass

    mod.ConnectionPool, mod.Redis = ConnectionPool, _FakeRedis
    monkeypatch.setitem(sys.modules, "redis", mod)
    return mod


def _data(n=80, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, DIM)).astype(np.float32)


def _make(cls, backend, **kw):
    kw = {**KW, **REDIS, **kw}
    if cls is TorchLSHRS:
        kw["device"] = "cpu"
    if backend == "device":
        kw.update(hash_mode="host", engine="collision", chunk_size=128, initial_capacity=128)
    return cls(backend=backend, **kw)


@pytest.mark.parametrize("backend", ["device", "memory", "redis"])
def test_password_redacted_in_metadata(backend, tmp_path, fake_redis):
    lsh = _make(TorchLSHRS, backend)
    lsh.index(list(range(20)), _data(20))
    lsh.save_to_disk(tmp_path / "m")
    raw = (tmp_path / "m" / "metadata.json").read_text()
    assert "hunter2" not in raw
    meta = json.loads(raw)
    assert meta["redis_config"] == {"host": "cache.example", "port": 6390, "db": 2,
                                    "password": "<REDACTED>", "prefix": "idx",
                                    "decode_responses": False, "max_connections": 9}
    assert meta["tpu_config"]["backend"] == backend
    # A bucket store's contents live outside the process: no index.npz.
    assert (tmp_path / "m" / "index.npz").exists() == (backend == "device")
    assert lsh._redis_config["password"] == "hunter2"  # the instance keeps it


@pytest.mark.parametrize("backend", ["device", "memory"])
def test_load_redis_config_override(backend, tmp_path):
    lsh = _make(TorchLSHRS, backend)
    lsh.save_to_disk(tmp_path / "m")
    back = TorchLSHRS.load_from_disk(tmp_path / "m", device="cpu",
                                     redis_config={"password": "secret", "prefix": "other"})
    assert back._redis_config == {**lsh._redis_config, "password": "secret", "prefix": "other"}
    assert back.stats()["redis_prefix"] == "other"
    plain = TorchLSHRS.load_from_disk(tmp_path / "m", device="cpu")
    assert plain._redis_config["password"] == "<REDACTED>"  # must be supplied again


def test_redis_checkpoint_reconnects_to_its_keys(tmp_path, fake_redis):
    X = _data()
    lsh = _make(TorchLSHRS, "redis")
    lsh.index(list(range(80)), X)
    lsh.save_to_disk(tmp_path / "m")
    back = TorchLSHRS.load_from_disk(tmp_path / "m", redis_config={"password": "hunter2"})
    assert back.stats()["backend"] == "redis" and back._storage.prefix == "idx"
    pool = back._storage._pool.kwargs
    assert (pool["host"], pool["port"], pool["db"], pool["password"], pool["max_connections"]) == (
        "cache.example", 6390, 2, "hunter2", 9)
    for q in X[:5]:
        assert back.query(q, top_k=None) == lsh.query(q, top_k=None)


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
@pytest.mark.parametrize("backend", ["device", "memory", "redis"])
def test_checkpoints_cross_packages_with_their_redis_settings(backend, direction, tmp_path,
                                                              fake_redis):
    X = _data()
    src_cls, dst_cls = ((TorchLSHRS, JaxLSHRS) if direction == "port_to_reference"
                        else (JaxLSHRS, TorchLSHRS))
    src = _make(src_cls, backend)
    src.index(list(range(80)), X)
    src.save_to_disk(tmp_path / "a")
    kw = {"device": "cpu"} if dst_cls is TorchLSHRS else {}
    back = dst_cls.load_from_disk(tmp_path / "a", redis_config={"password": "hunter2"}, **kw)
    assert back._redis_config == src._redis_config
    assert back.stats()["backend"] == backend and back.stats()["redis_prefix"] == "idx"
    for key in ("num_bands", "rows_per_band", "similarity_threshold", "buffer_size"):
        assert back.stats()[key] == src.stats()[key]
    if backend == "memory":  # buckets lived in the source process
        assert back.query(X[0], top_k=None) == []
        back.index(list(range(80)), X)
    for q in X[:6]:
        assert back.query(q, top_k=None) == src.query(q, top_k=None)
    # and once more through the destination's own save
    back.save_to_disk(tmp_path / "b")
    meta = json.loads((tmp_path / "b" / "metadata.json").read_text())
    assert meta["redis_config"]["prefix"] == "idx"
    assert meta["redis_config"]["password"] == "<REDACTED>"


def test_save_load_save_keeps_a_device_redis_prefix(tmp_path):
    """The device backend records redis_* as the reference does (it used to
    write the defaults, so one load and save lost ``prefix: "idx"``)."""
    lsh = TorchLSHRS(dim=32, redis_prefix="idx", device="cpu")
    assert lsh.stats()["redis_prefix"] == "idx" and lsh.stats()["backend"] == "device"
    lsh.save_to_disk(tmp_path / "a")
    TorchLSHRS.load_from_disk(tmp_path / "a", device="cpu").save_to_disk(tmp_path / "b")
    for d in ("a", "b"):
        meta = json.loads((tmp_path / d / "metadata.json").read_text())
        assert meta["redis_config"]["prefix"] == "idx"
    ref = JaxLSHRS(dim=32, redis_prefix="idx")
    ref.save_to_disk(tmp_path / "r")
    want = json.loads((tmp_path / "r" / "metadata.json").read_text())["redis_config"]
    assert want == json.loads((tmp_path / "b" / "metadata.json").read_text())["redis_config"]


@pytest.mark.parametrize("cls", [JaxLSHRS, TorchLSHRS])
def test_custom_checkpoint_restores_onto_memory(cls, tmp_path):
    kw = {"device": "cpu"} if cls is TorchLSHRS else {}
    X = _data(30)
    store = MemoryStorage() if cls is TorchLSHRS else JaxMemoryStorage()
    lsh = cls(storage=store, **KW, **kw)
    lsh.index(list(range(30)), X)
    assert lsh.stats()["backend"] == "custom"
    lsh.save_to_disk(tmp_path / "m")
    assert json.loads((tmp_path / "m" / "metadata.json").read_text())["tpu_config"][
        "backend"] == "custom"
    back = TorchLSHRS.load_from_disk(tmp_path / "m", device="cpu")
    assert back.stats()["backend"] == "memory" and isinstance(back._storage, MemoryStorage)
    mine = MemoryStorage()
    again = TorchLSHRS.load_from_disk(tmp_path / "m", storage=mine, device="cpu")
    assert again._storage is mine and again.stats()["backend"] == "custom"
    again.index(list(range(30)), X)
    assert again.query(X[4], top_k=None) == lsh.query(X[4], top_k=None)
    if cls is TorchLSHRS:  # pickling downgrades a custom store the same way
        assert pickle.loads(pickle.dumps(lsh)).stats()["backend"] == "memory"


def test_load_with_a_device_storage(tmp_path):
    """storage= on load: a device checkpoint's index.npz is read into the
    given store, on that store's device."""
    X = _data()
    src = _make(TorchLSHRS, "device", store_vectors=True)
    src.index(list(range(80)), X)
    src.save_to_disk(tmp_path / "m")
    store = DeviceStore(num_bands=8, rows_per_band=4, dim=DIM, store_vectors=True,
                        chunk_size=128, initial_capacity=128, device="cpu")
    back = TorchLSHRS.load_from_disk(tmp_path / "m", storage=store)  # device="cuda" unused
    assert back._storage is store and back._hasher.device == store.device
    assert back.stats()["index"]["alive"] == 80
    for q in X[:5]:
        assert back.query(q, top_k=None) == src.query(q, top_k=None)
        assert back.get_above_p(q, p=0.5) == src.get_above_p(q, p=0.5)


@pytest.mark.parametrize("backend", ["device", "memory", "redis"])
def test_pickle_keeps_the_password(backend, fake_redis):
    X = _data(40)
    lsh = _make(TorchLSHRS, backend)
    lsh.index(list(range(40)), X)
    state = lsh.__getstate__()
    assert state["redis_config"]["password"] == "hunter2"
    clone = pickle.loads(pickle.dumps(lsh))
    assert clone._redis_config == lsh._redis_config
    assert clone.stats()["backend"] == backend
    if backend != "memory":  # device: the index rides along; redis: the keys live on
        assert clone.query(X[3], top_k=None) == lsh.query(X[3], top_k=None)
    assert clone._vector_fetch_fn is None


def test_save_flushes_the_bucket_buffer(tmp_path):
    lsh = _make(TorchLSHRS, "memory")
    lsh.ingest(0, _data(1)[0])
    assert lsh.stats()["buffered_operations"] == 8
    lsh.save_to_disk(tmp_path / "m")
    assert lsh.stats()["buffered_operations"] == 0
    assert lsh._storage.total_operations == 8
