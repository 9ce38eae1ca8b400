"""MIPS (maximum inner-product search, ``similarity="dot"``): the port
against `lshrs_tpu`.

Stored vectors gain the coordinate ``sqrt(max_norm^2 - |x|^2)``, queries a
0, so the cosine stages rank by inner product and scores scale back to
inner products. Mirrors `tests/test_mips.py` (less the bucket-backend and
sharded cases, ROADMAP Queue A items 6 and 7), then holds the port to the
reference: the augmented rows and the hasher geometry (``dim + 1``), ids
identical and scores within 1e-5 on every entry point (top-k, Hamming,
asymmetric, top-p single, batch and serving, the host fetch path), and
checkpoints both ways. The cross-package cases hash with the structured
family or the host sgemm, whose words are bit-identical in both packages.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu_torch import LSHRS

DIM = 24


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(99)


@pytest.fixture
def data(rng):
    X = rng.standard_normal((600, DIM)).astype(np.float32)
    X *= rng.uniform(0.4, 1.8, (600, 1)).astype(np.float32)
    M = float(np.linalg.norm(X, axis=1).max()) * 1.001
    return X, M


def make_mips(data, cls=LSHRS, **kw):
    X, M = data
    kw.setdefault("num_perm", 64)
    kw.setdefault("num_bands", 8)
    kw.setdefault("rows_per_band", 8)
    kw.setdefault("engine", "collision")
    kw.setdefault("initial_capacity", 1024)
    if cls is LSHRS:
        kw["device"] = "cpu"
    lsh = cls(dim=DIM, similarity="dot", max_norm=M, **kw)
    lsh.index(np.arange(len(X)), X)
    return lsh


# -- mirrors of tests/test_mips.py -----------------------------------------


def test_validation():
    with pytest.raises(ValueError, match="max_norm"):
        LSHRS(dim=DIM, similarity="dot", device="cpu")
    with pytest.raises(ValueError, match="max_norm"):
        LSHRS(dim=DIM, similarity="dot", max_norm=0.0, device="cpu")
    with pytest.raises(ValueError, match="similarity"):
        LSHRS(dim=DIM, similarity="euclidean", device="cpu")


def test_over_norm_vectors_rejected(data, rng):
    X, M = data
    lsh = make_mips(data)
    big = rng.standard_normal((1, DIM)).astype(np.float32)
    big *= (2.0 * M) / np.linalg.norm(big)
    with pytest.raises(ValueError, match="max_norm"):
        lsh.index([10_000], big)
    with pytest.raises(ValueError, match="max_norm"):
        lsh.ingest(10_001, big[0])


def test_topp_scores_are_exact_inner_products(data, rng):
    X, M = data
    lsh = make_mips(data, store_vectors=True)
    for q in rng.standard_normal((5, DIM)).astype(np.float32):
        dots = X @ q
        res = lsh.get_above_p(q, p=1.0)
        assert res, "empty candidate set"
        ids = [i for i, _ in res]
        assert ids == sorted(ids, key=lambda i: (-dots[i], i))
        for i, s in res:
            assert s == pytest.approx(float(dots[i]), rel=1e-4, abs=1e-4)


def test_topp_fetch_fn_path_matches_resident(data, rng):
    """Host (vector_fetch_fn) rerank == device resident-payload rerank."""
    X, M = data
    resident = make_mips(data, store_vectors=True)
    fetched = make_mips(data, vector_fetch_fn=lambda ids: X[list(ids)])
    for q in rng.standard_normal((3, DIM)).astype(np.float32):
        r1 = resident.get_above_p(q, p=0.5)
        r2 = fetched.get_above_p(q, p=0.5)
        assert [i for i, _ in r1] == [i for i, _ in r2]
        for (_, s1), (_, s2) in zip(r1, r2):
            assert s1 == pytest.approx(s2, rel=1e-4, abs=1e-4)


def test_batched_topp_matches_single(data, rng):
    lsh = make_mips(data, store_vectors=True)
    queries = rng.standard_normal((6, DIM)).astype(np.float32)
    batch = lsh.get_above_p_batch(queries, p=1.0)
    for qi, q in enumerate(queries):
        single = lsh.get_above_p(q, p=1.0)
        assert [i for i, _ in batch[qi]] == [i for i, _ in single]
        for (_, sb), (_, ss) in zip(batch[qi], single):
            assert sb == pytest.approx(ss, rel=1e-4, abs=1e-4)


def test_hamming_and_asymmetric_estimate_dots(data, rng):
    """Estimator modes return inner-product-scaled estimates in dot mode."""
    X, M = data
    lsh = make_mips(data, num_perm=256, num_bands=16, rows_per_band=16, enable_hamming=True)
    q = rng.standard_normal(DIM).astype(np.float32)
    dots = X @ q
    top = lsh.query_hamming(q, top_k=5)
    for i, est in top:
        assert abs(est - dots[i]) < 0.6 * M * np.linalg.norm(q)
    for i, est in lsh.query_asymmetric(q, top_k=5):
        assert abs(est - dots[i]) < 0.6 * M * np.linalg.norm(q)
    hb = lsh.query_hamming_batch(q[None, :], top_k=5)[0]
    assert [i for i, _ in hb] == [i for i, _ in top]


def test_mips_recall_with_rich_banding(rng):
    """End-to-end recall: the probing rerank finds most of the true top-10."""
    dim, n = 32, 6000
    centers = rng.standard_normal((60, dim)).astype(np.float32) * 2
    X = np.repeat(centers, 100, axis=0) + 0.4 * rng.standard_normal((n, dim)).astype(np.float32)
    X *= rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
    M = float(np.linalg.norm(X, axis=1).max()) * 1.001
    lsh = LSHRS(dim=dim, num_perm=256, num_bands=32, rows_per_band=8, similarity="dot",
                max_norm=M, store_vectors=True, engine="collision", multiprobe=2,
                initial_capacity=8192, device="cpu")
    lsh.index(np.arange(n), X)
    hits = tot = 0
    for q in rng.standard_normal((24, dim)).astype(np.float32):
        oracle = set(np.argsort(-(X @ q))[:10].tolist())
        got = set(i for i, _ in lsh.get_above_p(q, p=1.0)[:10])
        hits += len(got & oracle)
        tot += 10
    assert hits / tot > 0.5, f"MIPS recall@10 {hits / tot:.3f}"


def test_serving_fn_topp_rescales(data, rng):
    X, M = data
    lsh = make_mips(data, store_vectors=True)
    serve = lsh.serving_fn(top_k=8, mode="topp")
    queries = rng.standard_normal((4, DIM)).astype(np.float32)
    ids, sims, n = serve(queries)
    for qi, q in enumerate(queries):
        dots = X @ q
        for j in range(min(8, int(n[qi]))):
            i = int(ids[qi, j])
            if i < 0:
                break
            assert sims[qi, j] == pytest.approx(float(dots[i]), rel=1e-4, abs=1e-4)


def test_persistence_roundtrip(data, rng, tmp_path):
    lsh = make_mips(data, store_vectors=True)
    q = rng.standard_normal(DIM).astype(np.float32)
    want = lsh.get_above_p(q, p=1.0)[:10]
    lsh.save_to_disk(tmp_path / "mips")
    restored = LSHRS.load_from_disk(tmp_path / "mips", device="cpu")
    assert restored._similarity == "dot"
    assert restored._max_norm == pytest.approx(data[1])
    assert restored.stats()["similarity"] == "dot"
    assert [i for i, _ in restored.get_above_p(q, p=1.0)[:10]] == [i for i, _ in want]
    clone = pickle.loads(pickle.dumps(lsh))
    assert [i for i, _ in clone.get_above_p(q, p=1.0)[:10]] == [i for i, _ in want]


# -- parity with lshrs_tpu --------------------------------------------------

PARITY = [
    dict(hash_family="structured"),
    dict(hash_mode="host"),
    dict(hash_family="structured", multiprobe=2),
]


def _same_scored(got, want, tol=1e-5):
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a == pytest.approx(b, rel=tol, abs=tol)


def test_augmented_store_matches_the_reference(data):
    jl = make_mips(data, JaxLSHRS, store_vectors=True, hash_family="structured")
    tl = make_mips(data, store_vectors=True, hash_family="structured")
    assert tl._hash_dim == jl._hash_dim == DIM + 1
    assert tl._config == jl._config and tl._config["max_norm"] == data[1]
    js, ts = jl._storage.state_arrays(), tl._storage.state_arrays()
    np.testing.assert_array_equal(ts["sig"], js["sig"])
    np.testing.assert_array_equal(ts["payload"], js["payload"])
    X, M = data
    np.testing.assert_array_equal(tl._augment_data(X), jl._augment_data(X))
    np.testing.assert_array_equal(tl._augment_query(X), jl._augment_query(X))
    np.testing.assert_array_equal(tl._score_scale(X), jl._score_scale(X))


@pytest.mark.parametrize("kw", PARITY)
def test_mips_entry_points_match_the_reference(kw, data, rng):
    """Top-k, top-p (single, batch, serving) and candidate enumeration:
    ids identical, inner-product scores within 1e-5."""
    jl = make_mips(data, JaxLSHRS, store_vectors=True, **kw)
    tl = make_mips(data, store_vectors=True, **kw)
    Q = rng.standard_normal((12, DIM)).astype(np.float32)
    assert tl.query_batch(Q, top_k=7) == jl.query_batch(Q, top_k=7)
    np.testing.assert_array_equal(tl.serving_fn(top_k=7)(Q), np.asarray(jl.serving_fn(top_k=7)(Q)))
    for q in Q[:2]:
        assert tl.query(q, top_k=None) == jl.query(q, top_k=None)
        _same_scored(tl.get_above_p(q, p=0.5), jl.get_above_p(q, p=0.5))
    for g, w in zip(tl.get_above_p_batch(Q, p=0.5, top_k=6),
                    jl.get_above_p_batch(Q, p=0.5, top_k=6)):
        _same_scored(g, w)
    ti, ts, tn = tl.serving_fn(top_k=6, mode="topp")(Q)
    ji, js, jn = (np.asarray(a) for a in jl.serving_fn(top_k=6, mode="topp")(Q))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_allclose(ts, js, rtol=1e-5, atol=1e-5)


def test_mips_fetch_path_matches_the_reference(data, rng):
    X, _ = data
    fetch = lambda ids: X[list(ids)]  # noqa: E731
    jl = make_mips(data, JaxLSHRS, vector_fetch_fn=fetch, hash_family="structured")
    tl = make_mips(data, vector_fetch_fn=fetch, hash_family="structured")
    for q in rng.standard_normal((4, DIM)).astype(np.float32):
        _same_scored(tl.get_above_p(q, p=0.7), jl.get_above_p(q, p=0.7))


def test_mips_estimators_match_the_reference(data, rng):
    """Hamming and asymmetric estimates on the inner-product scale."""
    kw = dict(num_perm=128, num_bands=8, rows_per_band=16, enable_hamming=True,
              hash_family="structured")
    jl, tl = make_mips(data, JaxLSHRS, **kw), make_mips(data, **kw)
    Q = rng.standard_normal((6, DIM)).astype(np.float32)
    for g, w in zip(tl.query_hamming_batch(Q, top_k=5), jl.query_hamming_batch(Q, top_k=5)):
        _same_scored(g, w)
    for g, w in zip(tl.query_asymmetric_batch(Q, top_k=5),
                    jl.query_asymmetric_batch(Q, top_k=5)):
        _same_scored(g, w)
    np.testing.assert_array_equal(tl.serving_fn(top_k=5, mode="asymmetric")(Q),
                                  np.asarray(jl.serving_fn(top_k=5, mode="asymmetric")(Q)))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mips_checkpoint_crosses_packages(direction, data, rng, tmp_path):
    """A MIPS index (``max_norm``, the dim + 1 payload) saved by either
    package loads in the other and serves the same ids and scores."""
    cls = JaxLSHRS if direction == "jax_to_port" else LSHRS
    src = make_mips(data, cls, store_vectors=True, hash_family="structured",
                    query_mode="bucket")
    src.save_to_disk(tmp_path / "ckpt")
    if direction == "jax_to_port":
        back = LSHRS.load_from_disk(tmp_path / "ckpt", device="cpu")
    else:
        back = JaxLSHRS.load_from_disk(tmp_path / "ckpt")
    assert back._config == src._config and back._max_norm == data[1]
    assert back.stats()["index"]["query_mode"] == "bucket"
    Q = rng.standard_normal((8, DIM)).astype(np.float32)
    assert back.query_batch(Q, top_k=5) == src.query_batch(Q, top_k=5)
    for g, w in zip(back.get_above_p_batch(Q, p=0.5, top_k=5),
                    src.get_above_p_batch(Q, p=0.5, top_k=5)):
        _same_scored(g, w)
