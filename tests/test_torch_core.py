"""LSHRS end to end: the port against the JAX package on the same data."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher as JaxHasher
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.hash.hasher import LSHHasher as TorchHasher
from lshrs_tpu_torch.ops.bitpack import words_to_numpy

REPO = Path(__file__).resolve().parents[1]


def _pair(**kw):
    return JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)


def _clustered(rng, n, dim, centers=40):
    c = rng.standard_normal((centers, dim)).astype(np.float32)
    return (c[rng.integers(0, centers, n)] + 0.4 * rng.standard_normal((n, dim))).astype(np.float32)


def _check_queries(jl, tl, X, Q):
    for i in (0, 7, 19):
        assert tl.query(X[i], top_k=8) == jl.query(X[i], top_k=8)
        assert tl.get_top_k(Q[i], topk=5) == jl.get_top_k(Q[i], topk=5)
    assert tl.query_batch(Q, top_k=6) == jl.query_batch(Q, top_k=6)
    np.testing.assert_array_equal(tl.serving_fn(top_k=9)(Q), np.asarray(jl.serving_fn(top_k=9)(Q)))


def test_collision_engine_matches(rng):
    kw = dict(dim=32, num_perm=64, num_bands=8, rows_per_band=8, hash_mode="host",
              seed=7, chunk_size=128, initial_capacity=128)
    jl, tl = _pair(**kw)
    X = _clustered(rng, 900, 32)
    for lo in range(0, 800, 300):  # batched index, growing the store
        ids = list(range(lo, min(lo + 300, 800)))
        jl.index(ids, X[lo : lo + 300][: len(ids)])
        tl.index(ids, X[lo : lo + 300][: len(ids)])
    for i in range(800, 900):  # buffered single ingests, then a flush
        jl.ingest(i, X[i])
        tl.ingest(i, X[i])
    jl.flush()
    tl.flush()
    Q = X[:40] + 0.2 * rng.standard_normal((40, 32)).astype(np.float32)
    _check_queries(jl, tl, X, Q)
    js, ts = jl.stats(), tl.stats()
    for key in ("ranking", "engine_resolved", "num_bands", "rows_per_band"):
        assert ts[key] == js[key], key
    assert ts["counters"] == {k: js["counters"][k] for k in ts["counters"]}
    assert ts["index"]["capacity"] == js["index"]["capacity"]
    assert ts["ranking"] == "collision"


def test_auto_switch_to_hamming_matches(rng):
    kw = dict(dim=24, num_perm=16, num_bands=4, rows_per_band=4, hash_mode="host",
              seed=3, initial_capacity=1 << 19)
    jl, tl = _pair(**kw)
    X = _clustered(rng, 400, 24)
    jl.index(list(range(400)), X)
    tl.index(list(range(400)), X)
    Q = X[:20] + 0.2 * rng.standard_normal((20, 24)).astype(np.float32)
    _check_queries(jl, tl, X, Q)
    assert tl.stats()["engine_resolved"] == jl.stats()["engine_resolved"] == "hamming"


def test_device_hash_bits_agree_up_to_rounding(rng):
    dim, nb, r = 48, 8, 16
    jh = JaxHasher(num_bands=nb, rows_per_band=r, dim=dim, seed=9)
    th = TorchHasher(num_bands=nb, rows_per_band=r, dim=dim, seed=9, device="cpu")
    np.testing.assert_array_equal(th.projection_matrix, jh.projection_matrix)
    X = rng.standard_normal((2000, dim)).astype(np.float32)
    got = words_to_numpy(th.hash_batch_words(X))
    want = np.asarray(jh.hash_batch_words(X))
    np.testing.assert_array_equal(th.hash_batch_words_host(X), jh.hash_batch_words_host(X))
    np.testing.assert_array_equal(th.hash_batch_dense_host(X), jh.hash_batch_dense_host(X))
    # Bits may differ only at projections within rounding of zero.
    differ = np.unpackbits((got ^ want).view(np.uint8), bitorder="little").reshape(2000, nb, 32)
    differ = differ[:, :, :r].reshape(2000, nb * r).astype(bool)
    coords = X.astype(np.float64) @ jh.projection_matrix.T.astype(np.float64)
    bound = 1e-5 * np.linalg.norm(X, axis=1)[:, None] * np.linalg.norm(jh.projection_matrix, axis=1)[None, :]
    assert (np.abs(coords[differ]) < bound[differ]).all()


@pytest.mark.parametrize("engine", ["collision", "hamming"])
def test_device_hash_serving_self_matches(engine, rng):
    tl = TorchLSHRS(dim=32, num_perm=128, num_bands=16, rows_per_band=8, engine=engine,
                    device="cpu", chunk_size=128, initial_capacity=128)
    X = rng.standard_normal((600, 32)).astype(np.float32)
    tl.index(np.arange(600), X)
    out = tl.serving_fn(top_k=5)(X[:100])
    assert out.shape == (100, 5) and out.dtype == np.int32
    np.testing.assert_array_equal(out[:, 0], np.arange(100))
    assert tl.query_batch(X[:100], top_k=5) == [[i for i in row if i >= 0] for row in out.tolist()]
    assert tl.stats()["ranking"] == engine
    assert tl.stats()["counters"]["queries_served"] == 200


# No argument is left unported: each of these, set to anything but its
# default, constructs as the reference does. Sharding (item 7) was the last;
# item 6 brought the bucket backends, storage= and the Redis connection
# arguments, recorded for every backend as the reference does.
PORTED_ARGUMENTS = [
    dict(shards=2),
    dict(backend="memory"),
    dict(redis_host="cache"),
    dict(redis_port=6380),
    dict(redis_db=1),
    dict(redis_password="secret"),
    dict(redis_prefix="idx"),
    dict(redis_max_connections=8),
    dict(decode_responses=True),
]


def test_unported_paths_raise(rng):
    for kw in PORTED_ARGUMENTS:
        (key, value), = kw.items()
        tl = TorchLSHRS(dim=8, device="cpu", **kw)
        jl = JaxLSHRS(dim=8, **kw)
        assert tl._redis_config == jl._redis_config
        assert tl.stats()["backend"] == jl.stats()["backend"]
    with pytest.raises(AttributeError):  # not a storage: the reference fails alike
        TorchLSHRS(dim=8, device="cpu", storage=object())
    with pytest.raises(ValueError, match="query_mode"):
        TorchLSHRS(dim=8, query_mode="sorted", device="cpu")
    with pytest.raises(ValueError, match="max_norm"):
        TorchLSHRS(dim=8, similarity="dot", device="cpu")
    with pytest.raises(ValueError, match="multiprobe must be <= rows_per_band"):
        TorchLSHRS(dim=8, num_perm=16, num_bands=4, rows_per_band=4, multiprobe=5, device="cpu")
    with pytest.raises(ValueError, match="hash_family"):
        TorchLSHRS(dim=8, hash_family="minhash", device="cpu")
    tl = TorchLSHRS(dim=8, num_perm=16, num_bands=4, rows_per_band=4, store_vectors=True,
                    device="cpu")
    x = rng.standard_normal(8).astype(np.float32)
    tl.index([0], x[None, :])
    # Options ported since answer instead of raising: filters, asymmetric
    # serving, auto-refreshing serving, the bucketed engine and MIPS.
    assert tl.serving_fn(top_k=3, auto_refresh=True)(x[None, :])[0, 0] == 0
    for kw in (dict(query_mode="bucket", bucket_cap=64), dict(similarity="dot", max_norm=5.0),
               dict(max_norm=5.0)):
        other = TorchLSHRS(dim=8, num_perm=16, num_bands=4, rows_per_band=4, device="cpu", **kw)
        other.index([0], x[None, :] / np.linalg.norm(x))
        assert other.query(x, top_k=3) == [0]
    assert tl.serving_fn(top_k=3, mode="asymmetric")(x[None, :])[0, 0] == 0
    assert tl.serving_fn(top_k=3, mode="asymmetric", coords_wire="int4")(x[None, :])[0, 0] == 0
    assert tl.query(x, where=[0]) == [0] and tl.query(x, where=[1]) == []
    assert [i for i, _ in tl.query(x, top_p=0.5, where=[0])] == [0]
    with pytest.raises(ValueError, match="zero vector"):
        tl.index([1], np.zeros((1, 8), np.float32))


def test_every_reference_argument_is_accepted():
    """The port's constructor and serving_fn take every argument of the
    reference's, so code written for the reference fails with
    NotImplementedError, never TypeError."""
    import inspect

    for name in ("__init__", "serving_fn"):
        ref = set(inspect.signature(getattr(JaxLSHRS, name)).parameters)
        port = set(inspect.signature(getattr(TorchLSHRS, name)).parameters)
        assert ref - port == set(), name


def test_import_leaves_jax_out():
    code = (
        "import sys, lshrs_tpu_torch; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'lshrs_tpu.'))"
        " or m == 'lshrs_tpu']; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
