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


def test_unported_paths_raise(rng):
    with pytest.raises(NotImplementedError):
        TorchLSHRS(dim=8, backend="memory", device="cpu")
    with pytest.raises(NotImplementedError):
        TorchLSHRS(dim=8, shards=2, device="cpu")
    with pytest.raises(NotImplementedError):
        TorchLSHRS(dim=8, similarity="dot", device="cpu")
    with pytest.raises(ValueError, match="multiprobe must be <= rows_per_band"):
        TorchLSHRS(dim=8, num_perm=16, num_bands=4, rows_per_band=4, multiprobe=5, device="cpu")
    with pytest.raises(ValueError, match="hash_family"):
        TorchLSHRS(dim=8, hash_family="minhash", device="cpu")
    tl = TorchLSHRS(dim=8, num_perm=16, num_bands=4, rows_per_band=4, store_vectors=True,
                    device="cpu")
    x = rng.standard_normal(8).astype(np.float32)
    tl.index([0], x[None, :])
    with pytest.raises(NotImplementedError):
        tl.serving_fn(top_k=3, mode="asymmetric")
    # Options ported since: filters answer instead of raising.
    assert tl.query(x, where=[0]) == [0] and tl.query(x, where=[1]) == []
    assert [i for i, _ in tl.query(x, top_p=0.5, where=[0])] == [0]
    with pytest.raises(ValueError, match="zero vector"):
        tl.index([1], np.zeros((1, 8), np.float32))


def test_import_leaves_jax_out():
    code = (
        "import sys, lshrs_tpu_torch; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'lshrs_tpu.'))"
        " or m == 'lshrs_tpu']; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
