"""Bulk ingestion: the port's loaders, prefetch and create_signatures
against the JAX package's on the same seeded inputs.

Both packages' NumPy, Parquet and Postgres loaders must yield identical
batches and raise the same errors; ``create_signatures`` must build the
same store (``state_arrays()`` bit for bit under ``hash_mode="host"``,
where both hash with the same NumPy code) and answer the same ids, with
the prefetch thread on and off and the two-stage pipeline forced on and
off through ``os.sched_getaffinity``. Postgres runs against a fake
``psycopg`` module (no server); Parquet needs ``pyarrow``. Every wait on a
thread is bounded.
"""

from __future__ import annotations

import os
import sys
import threading
import types

import numpy as np
import pytest

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.io import numpy_io as j_numpy
from lshrs_tpu.io import parquet as j_parquet
from lshrs_tpu.io import postgres as j_postgres
from lshrs_tpu.io import prefetch as j_prefetch
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch import io as t_io
from lshrs_tpu_torch.io import numpy_io as t_numpy
from lshrs_tpu_torch.io import parquet as t_parquet
from lshrs_tpu_torch.io import postgres as t_postgres
from lshrs_tpu_torch.io import prefetch as t_prefetch

DIM = 16
KW = dict(dim=DIM, num_perm=32, num_bands=8, rows_per_band=4, hash_mode="host", seed=5,
          chunk_size=128, initial_capacity=128, engine="collision")
WAIT_S = 10.0


def _pair(**kw):
    kw = {**KW, **kw}
    return JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)


def _data(n=60, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, DIM)).astype(np.float32)
    return X, (7 * np.arange(n) + 3).astype(np.int64)


def _same_batches(got, want):
    assert len(got) == len(want)
    for (gi, gx), (wi, wx) in zip(got, want):
        assert gi == wi and all(type(i) is int for i in gi)
        assert gx.dtype == wx.dtype == np.float32
        np.testing.assert_array_equal(gx, wx)


def _same_error(fn_j, fn_t, exc):
    with pytest.raises(exc) as want:
        fn_j()
    with pytest.raises(exc) as got:
        fn_t()
    assert str(got.value) == str(want.value)


def _same_index(jl, tl, X, qseed=9):
    a, b = jl._storage.state_arrays(), tl._storage.state_arrays()
    np.testing.assert_array_equal(b["ids"], a["ids"])
    np.testing.assert_array_equal(b["sig"], a["sig"])
    Q = X[:6] + 0.3 * np.random.default_rng(qseed).standard_normal((6, DIM)).astype(np.float32)
    for q in Q:
        assert tl.query(q, top_k=5) == jl.query(q, top_k=5)
        assert tl.query(q, top_k=None) == jl.query(q, top_k=None)
    js, ts = jl.stats(), tl.stats()
    assert ts["counters"] == js["counters"]
    assert ts["index"]["alive"] == js["index"]["alive"]


# ---------------------------------------------------------------------------
# fakes: psycopg (the reference's fixture) and a Parquet file
# ---------------------------------------------------------------------------


class FakeCursor:
    def __init__(self, rows):
        self._rows = list(rows)
        self._pos = 0
        self.executed = None
        self.itersize = None

    def execute(self, query, params=None):
        self.executed = (query, params)

    def fetchmany(self, n):
        out = self._rows[self._pos : self._pos + n]
        self._pos += n
        return out

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class FakeConnection:
    def __init__(self, rows):
        self.rows = rows
        self.closed = False
        self.autocommit = False
        self.cursors = []

    def cursor(self, name=None):
        cur = FakeCursor(self.rows)
        self.cursors.append(cur)
        return cur

    def close(self):
        self.closed = True


@pytest.fixture
def fake_psycopg(monkeypatch):
    mod = types.ModuleType("psycopg")
    sql_mod = types.ModuleType("psycopg.sql")

    class _Frag:
        def __init__(self, text):
            self.text = text

        def format(self, **kw):
            out = self.text
            for key, val in kw.items():
                out = out.replace("{%s}" % key, val.text if isinstance(val, _Frag) else str(val))
            return _Frag(out)

        def as_string(self, *_):
            return self.text

    sql_mod.SQL = _Frag
    sql_mod.Identifier = lambda s: _Frag(f'"{s}"')
    sql_mod.Literal = lambda v: _Frag(repr(v))
    mod.sql = sql_mod
    mod.connect = lambda dsn: FakeConnection([])
    monkeypatch.setitem(sys.modules, "psycopg", mod)
    monkeypatch.setitem(sys.modules, "psycopg.sql", sql_mod)
    return mod


def _rows(X, ids, encode=lambda v: v.tobytes()):
    return [(int(i), encode(x)) for i, x in zip(ids, X)]


def _write_parquet(path, X, ids):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    table = pa.table({
        "index": pa.array([int(i) for i in ids], type=pa.int64()),
        "vector": pa.array([row.tolist() for row in X]),
    })
    pq.write_table(table, path)
    return path


# ---------------------------------------------------------------------------
# the NumPy loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["arrays", "source_array", "indices", "npy", "npz", "npz_keys",
                                  "npz_no_ids"])
@pytest.mark.parametrize("batch_size", [4, 25, 100])
def test_numpy_loaders_yield_identical_batches(case, batch_size, tmp_path):
    X, ids = _data(25)
    if case == "arrays":
        kw = dict(vectors=X)
    elif case == "source_array":
        kw = dict(source=X.astype(np.float64))
    elif case == "indices":
        kw = dict(vectors=X, indices=list(ids))
    elif case == "npy":
        np.save(tmp_path / "x.npy", X)
        kw = dict(source=str(tmp_path / "x.npy"))
    elif case == "npz":
        np.savez(tmp_path / "x.npz", vectors=X, indices=ids)
        kw = dict(source=tmp_path / "x.npz")
    elif case == "npz_keys":
        np.savez(tmp_path / "x.npz", emb=X, key=ids)
        kw = dict(source=tmp_path / "x.npz", vector_key="emb", index_key="key")
    else:
        np.savez(tmp_path / "x.npz", vectors=X)
        kw = dict(source=tmp_path / "x.npz")
    got = list(t_numpy.iter_numpy_vectors(batch_size=batch_size, **kw))
    want = list(j_numpy.iter_numpy_vectors(batch_size=batch_size, **kw))
    _same_batches(got, want)
    assert [len(b[0]) for b in got] == [min(batch_size, 25 - i) for i in range(0, 25, batch_size)]
    assert t_numpy.DEFAULT_NUMPY_BATCH_SIZE == j_numpy.DEFAULT_NUMPY_BATCH_SIZE == 65_536


@pytest.mark.parametrize("case,exc", [
    ("batch_size", ValueError),
    ("no_source", ValueError),
    ("missing_file", FileNotFoundError),
    ("missing_key", ValueError),
    ("one_d", ValueError),
    ("ids_mismatch", ValueError),
])
def test_numpy_loader_errors_match(case, exc, tmp_path):
    X, _ = _data(5)
    np.savez(tmp_path / "x.npz", other=X)
    kw = {
        "batch_size": dict(vectors=X, batch_size=0),
        "no_source": {},
        "missing_file": dict(source=tmp_path / "nope.npy"),
        "missing_key": dict(source=tmp_path / "x.npz"),
        "one_d": dict(vectors=X[0]),
        "ids_mismatch": dict(vectors=X, indices=[1, 2]),
    }[case]
    _same_error(lambda: list(j_numpy.iter_numpy_vectors(**kw)),
                lambda: list(t_numpy.iter_numpy_vectors(**kw)), exc)


# ---------------------------------------------------------------------------
# the Parquet loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [7, 10, 25, 1000])
def test_parquet_loaders_yield_identical_batches(batch_size, tmp_path):
    X, ids = _data(25)
    path = _write_parquet(tmp_path / "v.parquet", X, ids)
    got = list(t_parquet.iter_parquet_vectors(path, batch_size=batch_size))
    want = list(j_parquet.iter_parquet_vectors(path, batch_size=batch_size))
    _same_batches(got, want)
    assert [i for b in got for i in b[0]] == ids.tolist()
    np.testing.assert_array_equal(np.concatenate([b[1] for b in got]), X)


def test_parquet_loader_column_names_and_tilde(tmp_path, monkeypatch):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    X, ids = _data(9)
    pq.write_table(pa.table({"id": pa.array(ids.tolist(), type=pa.int64()),
                             "emb": pa.array([r.tolist() for r in X])}), tmp_path / "c.parquet")
    monkeypatch.setenv("HOME", str(tmp_path))
    kw = dict(index_column="id", vector_column="emb", batch_size=4)
    got = list(t_parquet.iter_parquet_vectors("~/c.parquet", **kw))
    _same_batches(got, list(j_parquet.iter_parquet_vectors("~/c.parquet", **kw)))


@pytest.mark.parametrize("case,exc", [
    ("missing_file", FileNotFoundError),
    ("missing_column", ValueError),
    ("batch_size", ValueError),
    ("ragged_rows", ValueError),
    ("empty_row", ValueError),
    ("ragged_batches", ValueError),
])
def test_parquet_loader_errors_match(case, exc, tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    X, ids = _data(8)
    path = _write_parquet(tmp_path / "v.parquet", X, ids)
    rows = {"ragged_rows": [[1.0, 2.0], [1.0]], "empty_row": [[1.0], []],
            "ragged_batches": [[1.0, 2.0], [1.0, 2.0], [3.0]]}.get(case)
    if rows is not None:
        pq.write_table(pa.table({"index": pa.array(range(len(rows)), type=pa.int64()),
                                 "vector": pa.array(rows)}), path)
    kw = {
        "missing_file": dict(source=tmp_path / "nope.parquet"),
        "missing_column": dict(source=path, vector_column="embedding"),
        "batch_size": dict(source=path, batch_size=0),
    }.get(case, dict(source=path, batch_size=2))
    _same_error(lambda: list(j_parquet.iter_parquet_vectors(**kw)),
                lambda: list(t_parquet.iter_parquet_vectors(**kw)), exc)


def test_parquet_coerce_vectors_matches():
    rows = [[1.5, -2.0, 3.25], (0.0, 1.0, 2.0), np.arange(3)]
    np.testing.assert_array_equal(t_parquet._coerce_vectors(rows), j_parquet._coerce_vectors(rows))
    assert t_parquet._coerce_vectors([]).shape == j_parquet._coerce_vectors([]).shape == (0, 0)
    _same_error(lambda: j_parquet._coerce_vectors([[1.0], [1.0, 2.0]]),
                lambda: t_parquet._coerce_vectors([[1.0], [1.0, 2.0]]), ValueError)


# ---------------------------------------------------------------------------
# the Postgres loader (fake psycopg)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encode", ["bytes", "braces", "brackets", "list"])
@pytest.mark.parametrize("batch_size", [10, 25, 100])
def test_postgres_loaders_yield_identical_batches(encode, batch_size, fake_psycopg):
    X, ids = _data(25)
    fn = {"bytes": lambda v: v.tobytes(),
          "braces": lambda v: "{" + ",".join(repr(float(a)) for a in v) + "}",
          "brackets": lambda v: "[" + ",".join(repr(float(a)) for a in v) + "]",
          "list": lambda v: v.tolist()}[encode]
    rows = _rows(X, ids, fn)
    conns = []

    def factory():
        conns.append(FakeConnection(rows))
        return conns[-1]

    got = list(t_postgres.iter_postgres_vectors(connection_factory=factory, batch_size=batch_size))
    want = list(j_postgres.iter_postgres_vectors(connection_factory=factory, batch_size=batch_size))
    _same_batches(got, want)
    np.testing.assert_array_equal(np.concatenate([b[1] for b in got]), X)
    assert not any(c.closed for c in conns)  # the caller owns factory connections
    assert conns[0].cursors[0].itersize == conns[1].cursors[0].itersize == batch_size
    assert conns[0].cursors[0].executed[0].text == conns[1].cursors[0].executed[0].text


@pytest.mark.parametrize("kw", [
    dict(),
    dict(table="emb", index_column="pk", vector_column="v"),
    dict(where_clause="pk > 3", order_by="pk DESC", limit=7),
])
def test_postgres_query_text_matches(kw, fake_psycopg):
    texts = []
    for mod in (j_postgres, t_postgres):
        conn = FakeConnection([])
        list(mod.iter_postgres_vectors(connection_factory=lambda: conn, **kw))
        query, params = conn.cursors[0].executed
        texts.append((query.text, params))
    assert texts[0] == texts[1]
    assert texts[1][0].startswith('SELECT "')


def test_postgres_owned_connection_and_fetch_query(fake_psycopg):
    X, ids = _data(3, seed=4)
    for mod in (j_postgres, t_postgres):
        conn = FakeConnection(_rows(X, ids))
        fake_psycopg.connect = lambda dsn: conn
        batches = list(mod.iter_postgres_vectors(dsn="postgres://x", batch_size=2))
        assert [b[0] for b in batches] == [ids[:2].tolist(), ids[2:].tolist()]
        assert conn.closed and conn.autocommit  # a dsn connection is the loader's own
        conn = FakeConnection(_rows(X, ids))
        list(mod.iter_postgres_vectors(connection_factory=lambda: conn,
                                       fetch_query="SELECT id, v FROM t WHERE id > %s",
                                       params=[5]))
        assert conn.cursors[0].executed == ("SELECT id, v FROM t WHERE id > %s", [5])


@pytest.mark.parametrize("case", ["no_connection", "params_without_query", "batch_size",
                                  "ragged"])
def test_postgres_loader_errors_match(case, fake_psycopg):
    X, ids = _data(3)
    rows = _rows(X[:2], ids[:2]) + _rows(X[2:, :6], ids[2:])
    kw = {
        "no_connection": {},
        "params_without_query": dict(dsn="x", params=[1]),
        "batch_size": dict(dsn="x", batch_size=0),
        "ragged": dict(connection_factory=lambda: FakeConnection(rows), batch_size=10),
    }[case]
    _same_error(lambda: list(j_postgres.iter_postgres_vectors(**kw)),
                lambda: list(t_postgres.iter_postgres_vectors(**kw)), ValueError)


def test_postgres_missing_psycopg_raises_import_error(monkeypatch):
    monkeypatch.setitem(sys.modules, "psycopg", None)
    with pytest.raises(ImportError, match="psycopg is required"):
        list(t_postgres.iter_postgres_vectors(dsn="x"))


def test_postgres_coerce_vector_matches():
    raw = np.array([1.5, -2.0, 3.25], np.float32)
    for value in (raw.tobytes(), memoryview(raw.tobytes()), bytearray(raw.tobytes()),
                  "{1.5,-2.0,3.25}", " [1.5,-2.0,3.25] ", [1.5, -2.0, 3.25], raw.astype(np.float64)):
        got, want = t_postgres._coerce_vector(value), j_postgres._coerce_vector(value)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, raw)
    _same_error(lambda: j_postgres._coerce_vector("{}"),
                lambda: t_postgres._coerce_vector("{}"), ValueError)


def test_io_package_exports_match():
    import lshrs_tpu.io as j_io

    assert t_io.__all__ == j_io.__all__
    for name in t_io.__all__:
        got, want = getattr(t_io, name), getattr(j_io, name)
        if isinstance(want, int):
            assert got == want, name
        else:
            assert got.__module__.startswith("lshrs_tpu_torch.io."), name
            assert got.__name__ == want.__name__


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

PREFETCH = [pytest.param(j_prefetch, id="jax"), pytest.param(t_prefetch, id="torch")]


@pytest.mark.parametrize("mod", PREFETCH)
@pytest.mark.parametrize("depth", [1, 3, 64])
def test_prefetch_preserves_order_and_content(mod, depth):
    src = [([i], np.full((1, 4), i, np.float32)) for i in range(20)]
    out = list(mod.prefetch_batches(iter(src), depth=depth))
    assert [o[0] for o in out] == [[i] for i in range(20)]
    assert all(o[1] is s[1] for o, s in zip(out, src))  # passed through, not copied


@pytest.mark.parametrize("mod", PREFETCH)
def test_prefetch_error_at_the_failing_batch(mod):
    def gen():
        yield 1
        yield 2
        raise RuntimeError("boom")

    it = mod.prefetch_batches(gen(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


@pytest.mark.parametrize("mod", PREFETCH)
@pytest.mark.parametrize("depth", [0, -1])
def test_prefetch_depth_validation(mod, depth):
    with pytest.raises(ValueError, match="depth must be greater than zero"):
        list(mod.prefetch_batches([1], depth=depth))


@pytest.mark.parametrize("mod", PREFETCH)
def test_prefetch_producer_runs_ahead_bounded_by_depth(mod):
    produced = []
    drained = threading.Event()

    def gen():
        for i in range(5):
            produced.append(i)
            yield i
        drained.set()

    it = mod.prefetch_batches(gen(), depth=10)
    assert next(it) == 0
    assert drained.wait(timeout=WAIT_S)  # a deep queue drains the source
    assert produced == list(range(5))
    assert list(it) == [1, 2, 3, 4]

    # depth 1: one batch in the queue, one held by the blocked producer.
    produced.clear()
    gate = threading.Event()

    def slow():
        for i in range(10):
            produced.append(i)
            if i == 3:
                gate.set()
            yield i

    it = mod.prefetch_batches(slow(), depth=1)
    assert next(it) == 0
    assert not gate.wait(timeout=0.3)
    assert len(produced) <= 3
    assert list(it) == list(range(1, 10))


@pytest.mark.parametrize("mod", PREFETCH)
def test_prefetch_producer_is_a_daemon_when_the_consumer_stops(mod):
    before = set(threading.enumerate())
    it = mod.prefetch_batches(iter(range(1000)), depth=1)
    assert next(it) == 0
    started = [t for t in threading.enumerate() if t not in before]
    assert started and all(t.daemon for t in started)
    del it  # the producer stays blocked on its queue; a daemon never holds the process


# ---------------------------------------------------------------------------
# create_signatures
# ---------------------------------------------------------------------------


def _loader_kwargs(fmt, tmp_path, X, ids, batch):
    if fmt == "numpy":
        return dict(vectors=X, indices=ids, batch_size=batch)
    if fmt == "arrays":
        return dict(source=X, batch_size=batch)
    if fmt == "npy":
        np.save(tmp_path / "x.npy", X)
        return dict(source=tmp_path / "x.npy", batch_size=batch)
    if fmt == "npz":
        np.savez(tmp_path / "x.npz", vectors=X, indices=ids)
        return dict(source=tmp_path / "x.npz", batch_size=batch)
    if fmt == "parquet":
        return dict(source=_write_parquet(tmp_path / "x.parquet", X, ids), batch_size=batch)
    rows = _rows(X, ids)
    return dict(connection_factory=lambda: FakeConnection(rows), batch_size=batch)


@pytest.mark.parametrize("cpus", [1, 4], ids=["serial", "pipelined"])
@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("fmt", ["numpy", "npy", "npz", "parquet", "pg"])
def test_create_signatures_matches_the_reference(fmt, prefetch, cpus, tmp_path, fake_psycopg,
                                                 monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)), raising=False)
    X, ids = _data()
    kw = _loader_kwargs(fmt, tmp_path, X, ids, batch=16)
    jl, tl = _pair()
    threads = []
    prepare = TorchLSHRS._prepare_index_batch

    def recording(self, *a):
        threads.append(threading.get_ident())
        return prepare(self, *a)

    monkeypatch.setattr(TorchLSHRS, "_prepare_index_batch", recording)
    jl.create_signatures(format=fmt, prefetch=prefetch, **kw)
    tl.create_signatures(format=fmt, prefetch=prefetch, **kw)
    _same_index(jl, tl, X)
    assert tl.stats()["index"]["alive"] == 60
    assert tl.stats()["counters"]["flushes"] == 4  # one per batch
    want_ids = list(range(60)) if fmt == "npy" else ids.tolist()
    assert sorted(tl._storage.state_arrays()["ids"].tolist()) == want_ids
    assert tl.get_top_k(X[17], topk=1) == [want_ids[17]]
    # The pipeline prepares every batch on its worker; the serial loop on
    # this thread.
    main = threading.get_ident()
    assert len(threads) == 4
    assert all((t != main) == (cpus > 1) for t in threads)


@pytest.mark.parametrize("cpus", [1, 4], ids=["serial", "pipelined"])
@pytest.mark.parametrize("hash_family", ["gaussian", "structured"])
def test_create_signatures_equals_index_of_the_same_batches(hash_family, cpus, monkeypatch):
    """The device hash (plain torch on the CPU here) gives the same store
    through create_signatures as through index() of identical batches."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)), raising=False)
    X, ids = _data(70)
    kw = {**KW, "hash_mode": "device", "hash_family": hash_family, "store_vectors": True}
    a, b = TorchLSHRS(device="cpu", **kw), TorchLSHRS(device="cpu", **kw)
    a.create_signatures(format="arrays", vectors=X, indices=ids, batch_size=32)
    for lo in range(0, 70, 32):
        b.index(ids[lo : lo + 32], X[lo : lo + 32])
    sa, sb = a._storage.state_arrays(), b._storage.state_arrays()
    assert set(sa) == set(sb)
    for key in sa:
        np.testing.assert_array_equal(sa[key], sb[key])
    assert a.stats()["counters"] == b.stats()["counters"]
    assert a.serving_fn(top_k=3)(X[:5])[:, 0].tolist() == ids[:5].tolist()


@pytest.mark.parametrize("cpus", [1, 4], ids=["serial", "pipelined"])
def test_create_signatures_bad_batch_commits_the_batches_before(cpus, monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)), raising=False)
    X, _ = _data(24)
    X[12] = 0.0  # a zero vector in the second batch
    for lsh in _pair():
        with pytest.raises(ValueError, match="zero vector"):
            lsh.create_signatures(format="numpy", vectors=X, batch_size=8, prefetch=0)
        assert lsh.stats()["index"]["alive"] == 8


@pytest.mark.parametrize("cpus", [1, 4], ids=["serial", "pipelined"])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_create_signatures_loader_failure_keeps_the_prepared_batch(prefetch, cpus, monkeypatch):
    """A loader that dies mid-stream: every batch it yielded is committed
    (the pipeline's prepared batch included) and its error propagates."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)), raising=False)
    X, ids = _data(24)

    def dying_loader(**_):
        yield ids[:8].tolist(), X[:8]
        yield ids[8:16].tolist(), X[8:16]
        raise ConnectionError("source died")

    got = []
    for lsh in _pair():
        lsh._resolve_loader = lambda fmt: dying_loader
        with pytest.raises(ConnectionError, match="source died"):
            lsh.create_signatures(format="numpy", prefetch=prefetch)
        got.append(lsh)
    _same_index(*got, X)
    assert got[1].stats()["index"]["alive"] == 16


@pytest.mark.parametrize("alias,name", [
    ("postgres", "iter_postgres_vectors"), ("pg", "iter_postgres_vectors"),
    ("PostgreS", "iter_postgres_vectors"), ("parquet", "iter_parquet_vectors"),
    ("pq", "iter_parquet_vectors"), ("numpy", "iter_numpy_vectors"),
    ("npy", "iter_numpy_vectors"), ("NPZ", "iter_numpy_vectors"),
    ("arrays", "iter_numpy_vectors"),
])
def test_resolve_loader_aliases(alias, name):
    tl = TorchLSHRS(device="cpu", **KW)
    jl = JaxLSHRS(**KW)
    got = tl._resolve_loader(alias)
    assert got is getattr(t_io, name)
    assert got.__name__ == jl._resolve_loader(alias).__name__


@pytest.mark.parametrize("backend", ["device", "memory"])
def test_resolve_loader_rejects_csv(backend):
    kw = {**KW, "backend": backend}
    _same_error(lambda: JaxLSHRS(**kw)._resolve_loader("csv"),
                lambda: TorchLSHRS(device="cpu", **kw)._resolve_loader("csv"), ValueError)
    with pytest.raises(ValueError, match="Unsupported signature creation format 'csv'"):
        TorchLSHRS(device="cpu", **kw).create_signatures(format="csv")


@pytest.mark.parametrize("cpus", [1, 4], ids=["serial", "pipelined"])
def test_create_signatures_on_a_bucket_backend_runs_the_serial_loop(cpus, monkeypatch):
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)), raising=False)
    X, ids = _data(40)
    kw = {**KW, "backend": "memory"}
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    for lsh in (jl, tl):
        lsh.create_signatures(format="numpy", vectors=X, indices=ids, batch_size=16)
    assert tl._storage.data == jl._storage.data
    assert tl._storage.batch_add_call_count == jl._storage.batch_add_call_count == 3
    for q in X[:5]:
        assert tl.query(q, top_k=4) == jl.query(q, top_k=4)
    assert tl.stats()["counters"] == jl.stats()["counters"]


def test_create_signatures_without_sched_getaffinity(monkeypatch):
    """Where the affinity mask is unknown (not Linux), the CPU count decides."""
    monkeypatch.delattr(os, "sched_getaffinity", raising=False)
    monkeypatch.setattr(os, "cpu_count", lambda: 2)
    X, ids = _data(20)
    tl = TorchLSHRS(device="cpu", **KW)
    tl.create_signatures(format="numpy", vectors=X, indices=ids, batch_size=8, prefetch=0)
    assert tl.stats()["index"]["alive"] == 20
    assert tl.get_top_k(X[4], topk=1) == [int(ids[4])]
