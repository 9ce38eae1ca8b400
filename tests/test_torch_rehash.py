"""In-place retuning (`LSHRS.rehash` / `DeviceStore.rehash`): the port
against `lshrs_tpu`.

Mirrors `tests/test_rehash.py` (less the sharded case, ROADMAP Queue A
item 7) on the port, then holds it to the reference: structured and
cross-polytope rehash words bit-exact across the packages (their FWHT
order is fixed), gaussian rehash words equal to a fresh build of the port
(BLAS rounding may flip near-zero projections between the packages, so
queries are compared on shared words), int8 payloads hashed as their raw
integers, the packed storage, the cascade and the bucket index after a
rehash, the banding-derived state, and ``serving_fn(auto_refresh=True)``
as in `tests/test_core.py`.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher as JaxHasher
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS
from lshrs_tpu_torch.hash.hasher import LSHHasher
from lshrs_tpu_torch.ops.bitpack import words_to_numpy
from lshrs_tpu_torch.storage.device import DeviceStore


def _device_lsh(rng, n=300, dim=32, **kw):
    kw.setdefault("num_perm", 16)
    kw.setdefault("num_bands", 4)
    kw.setdefault("rows_per_band", 4)
    lsh = LSHRS(dim=dim, store_vectors=True, seed=42, chunk_size=128, initial_capacity=128,
                device="cpu", **kw)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    lsh.index(list(range(n)), X)
    return lsh, X


def _words(store, n):
    return words_to_numpy(store._sig_rows[:n])


# -- mirrors of tests/test_rehash.py ---------------------------------------


def test_store_rehash_matches_fresh_build(rng):
    """f32 payload: rehashed signatures are bit-identical to a fresh
    device build under the new hasher."""
    dim, n = 32, 257  # an odd count leaves pad slots
    old = LSHHasher(num_bands=4, rows_per_band=4, dim=dim, seed=1, device="cpu")
    new = LSHHasher(num_bands=8, rows_per_band=4, dim=dim, seed=9, device="cpu")
    X = rng.standard_normal((n, dim)).astype(np.float32)
    kw = dict(rows_per_band=4, dim=dim, store_vectors=True, chunk_size=128,
              initial_capacity=512, dedupe=False, device="cpu")
    st = DeviceStore(num_bands=4, **kw)
    st.add_vectors_batch(np.arange(n), X, old.device_projection())
    st.rehash(new.device_projection(), num_bands=8, rows_per_band=4)
    assert st.num_bands == 8 and st.words == new.num_bands
    fresh = DeviceStore(num_bands=8, **kw)
    fresh.add_vectors_batch(np.arange(n), X, new.device_projection())
    np.testing.assert_array_equal(_words(st, n), _words(fresh, n))
    assert torch.equal(st._sig_t[:, :n], fresh._sig_t[:, :n])
    qw = new.hash_batch_words(X[:16])
    for a, b in zip(st.query_topk(qw, 5), fresh.query_topk(qw, 5)):
        np.testing.assert_array_equal(a, b)


def test_store_rehash_requires_payload():
    st = DeviceStore(num_bands=4, rows_per_band=4, chunk_size=128, initial_capacity=128,
                     device="cpu")
    h = LSHHasher(num_bands=4, rows_per_band=4, dim=16, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="store_vectors"):
        st.rehash(h.device_projection(), num_bands=4, rows_per_band=4)


def test_lshrs_rehash_autotunes_banding(rng):
    lsh, X = _device_lsh(rng, num_perm=64, num_bands=None, rows_per_band=None,
                         similarity_threshold=0.5)
    before = (lsh._config["num_bands"], lsh._config["rows_per_band"])
    lsh.rehash(similarity_threshold=0.9)
    after = (lsh._config["num_bands"], lsh._config["rows_per_band"])
    assert before != after
    assert lsh._config["num_bands"] * lsh._config["rows_per_band"] == 64
    assert lsh.stats()["num_bands"] == lsh._config["num_bands"]
    assert lsh.get_top_k(X[17], topk=1)[0] == 17
    res = lsh.get_above_p(X[17], p=0.1)
    assert res[0][0] == 17 and res[0][1] > 0.9999


def test_lshrs_rehash_explicit_banding_and_seed(rng):
    lsh, X = _device_lsh(rng)
    sig_before = _words(lsh._storage, 10).copy()
    lsh.rehash(num_bands=4, rows_per_band=4, seed=77)
    assert not np.array_equal(sig_before, _words(lsh._storage, 10))  # new projections
    assert lsh._config["seed"] == 77
    assert lsh.get_top_k(X[3], topk=1)[0] == 3


def test_lshrs_rehash_validation(rng):
    lsh, _ = _device_lsh(rng)
    with pytest.raises(ValueError, match="both num_bands and rows_per_band"):
        lsh.rehash(num_bands=8)
    with pytest.raises(ValueError, match="must equal num_perm"):
        lsh.rehash(num_perm=32, num_bands=4, rows_per_band=4)
    mem = LSHRS(dim=8, num_perm=16, backend="memory", device="cpu")
    with pytest.raises(RuntimeError, match="device backend"):
        mem.rehash(similarity_threshold=0.9)
    no_payload = LSHRS(dim=8, num_perm=16, chunk_size=128, initial_capacity=128, device="cpu")
    with pytest.raises(RuntimeError, match="store_vectors"):
        no_payload.rehash(similarity_threshold=0.9)


def test_rehash_host_hash_mode_keeps_one_path(rng):
    """hash_mode='host' + gaussian rebuilds through the host hasher, so
    stored and query signatures stay on one hash path."""
    lsh, X = _device_lsh(rng, hash_mode="host")
    lsh.rehash(num_bands=8, rows_per_band=2, seed=5)
    idx, count = lsh._ordered_candidates(X[9])[0]
    assert idx == 9 and count == 8  # all 8 bands collide
    np.testing.assert_array_equal(
        _words(lsh._storage, 300), lsh._hasher.hash_batch_words_host(X)
    )


def test_rehash_preserves_deletes_and_ids(rng):
    lsh, X = _device_lsh(rng)
    lsh.delete([5, 6])
    alive_before = lsh.stats()["index"]["alive"]
    lsh.rehash(seed=3)
    assert lsh.stats()["index"]["alive"] == alive_before
    assert 5 not in [i for i, _ in lsh.get_above_p(X[5], p=1.0)]


def test_rehash_int8_payload_self_match(rng):
    lsh, X = _device_lsh(rng, payload_dtype="int8")
    lsh.rehash(seed=11)
    assert lsh.get_top_k(X[21], topk=1)[0] == 21


def test_rehash_hamming_planes_rebuild(rng):
    lsh, X = _device_lsh(rng, enable_hamming=True)
    lsh.query_hamming(X[2], top_k=1)  # materialize the planes
    assert lsh._storage._planes is not None
    lsh.rehash(seed=8)
    assert lsh._storage._planes is None  # dropped, rebuilt lazily
    assert lsh.query_hamming(X[2], top_k=1)[0][0] == 2


def test_rehash_staleness_guard(rng):
    lsh, X = _device_lsh(rng)
    fn = lsh.serving_fn(1)
    lsh.rehash(seed=123)
    with pytest.raises(RuntimeError, match="stale"):
        fn(X[:4])


def test_rehash_persistence_roundtrip(rng, tmp_path):
    lsh, X = _device_lsh(rng)
    lsh.rehash(num_bands=8, rows_per_band=2, seed=55)
    before = lsh.get_above_p(X[4], p=0.5)
    lsh.save_to_disk(tmp_path / "idx")
    re = LSHRS.load_from_disk(tmp_path / "idx", device="cpu")
    assert re._config["num_bands"] == 8 and re._config["seed"] == 55
    assert [i for i, _ in re.get_above_p(X[4], p=0.5)] == [i for i, _ in before]


# -- parity with lshrs_tpu --------------------------------------------------


def _pair_lsh(rng, n=300, dim=32, **kw):
    base = dict(dim=dim, num_perm=16, num_bands=4, rows_per_band=4, store_vectors=True,
                seed=42, chunk_size=128, initial_capacity=512, engine="collision")
    base.update(kw)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    out = []
    for lsh in (JaxLSHRS(**base), LSHRS(device="cpu", **base)):
        lsh.index(list(range(n)), X)
        out.append(lsh)
    return (*out, X)


@pytest.mark.parametrize("family,bands,rows", [
    ("structured", 8, 4), ("crosspolytope", 8, 4), ("structured", 4, 8),
])
@pytest.mark.parametrize("payload_dtype", ["float32", "int8", "bfloat16"])
def test_fwht_family_rehash_words_match_the_reference(family, bands, rows, payload_dtype, rng):
    """Structured and cross-polytope rehash words are bit-exact across the
    packages, on every payload dtype (int8 rows hash as raw integers, bf16
    rows upcast), and so are the queries through them."""
    jl, tl, X = _pair_lsh(rng, payload_dtype=payload_dtype)
    for lsh in (jl, tl):
        lsh.delete([3, 4])
        lsh.rehash(num_bands=bands, rows_per_band=rows, seed=7, hash_family=family)
    n = 300
    np.testing.assert_array_equal(_words(tl._storage, n), np.asarray(jl._storage._sig_rows[:n]))
    assert tl._storage._refine_narrow_r == jl._storage._refine_narrow_r
    assert tl.query_batch(X[:20], top_k=5) == jl.query_batch(X[:20], top_k=5)
    want = jl.get_above_p_batch(X[:6], p=0.5, top_k=5)
    got = tl.get_above_p_batch(X[:6], p=0.5, top_k=5)
    assert [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]
    assert tl.stats()["hash_family"] == family


def test_int8_rehash_hashes_the_raw_integers(rng):
    """An int8 payload rehashes its stored integers, not the dequantised
    rows: the words equal the new hasher's words of ``payload.float()``."""
    lsh, X = _device_lsh(rng, payload_dtype="int8")
    lsh.rehash(num_bands=8, rows_per_band=2, seed=31)
    store = lsh._storage
    raw = store._payload[:300].to(torch.float32)
    np.testing.assert_array_equal(
        _words(store, 300), words_to_numpy(lsh._hasher.hash_batch_words(raw))
    )


def test_gaussian_rehash_queries_match_the_reference_on_shared_words(rng):
    """Gaussian rehash: the port's words equal its own fresh build (above);
    fed to the reference's store, the same words give the same answers."""
    _, tl, X = _pair_lsh(rng)
    tl.rehash(num_bands=8, rows_per_band=2, seed=19)
    js = JaxStore(num_bands=8, rows_per_band=2, chunk_size=128, initial_capacity=512)
    js.add_signature_batch(np.arange(300), _words(tl._storage, 300))
    qw = tl._hasher.hash_batch_words_host(X[:30])
    jc, ji = js.query_topk(qw, 6)
    tc, ti = tl._storage.query_topk(qw, 6)
    np.testing.assert_array_equal(np.asarray(ji), ti)
    np.testing.assert_array_equal(np.asarray(jc), tc)
    jh = JaxHasher(num_bands=8, rows_per_band=2, dim=32, seed=19)
    np.testing.assert_array_equal(tl._hasher.projection_matrix, jh.projection_matrix)


@pytest.mark.parametrize("storage", ["planes", "packed"])
def test_hamming_after_rehash_matches_the_reference(storage, rng):
    jl, tl, X = _pair_lsh(rng, num_perm=64, num_bands=4, rows_per_band=16, engine="hamming",
                          hamming_storage=storage, hash_family="structured")
    for lsh in (jl, tl):
        lsh.query_hamming_batch(X[:2], top_k=3)  # planes built before the rehash
        lsh.rehash(num_bands=8, rows_per_band=8, seed=3)
    np.testing.assert_array_equal(_words(tl._storage, 300), np.asarray(jl._storage._sig_rows[:300]))
    assert tl.query_hamming_batch(X[:25], top_k=6) == jl.query_hamming_batch(X[:25], top_k=6)
    np.testing.assert_array_equal(tl.serving_fn(top_k=6)(X[:25]),
                                  np.asarray(jl.serving_fn(top_k=6)(X[:25])))


def test_cascade_after_rehash_matches_the_reference(rng):
    jl, tl, X = _pair_lsh(rng, num_perm=128, num_bands=8, rows_per_band=16, engine="hamming",
                          hash_family="structured", hamming_cascade=32,
                          hamming_cascade_refine=64, group_size=8)
    for lsh in (jl, tl):
        lsh.query_hamming_batch(X[:2], top_k=3)
        lsh.rehash(num_bands=16, rows_per_band=8, seed=4)
    assert tl._storage._planes is None
    assert tl.query_hamming_batch(X[:25], top_k=6) == jl.query_hamming_batch(X[:25], top_k=6)
    assert tl._storage._planes.shape[1] == 32  # the prefix, rebuilt
    with pytest.raises(ValueError, match="hamming_cascade"):
        tl.rehash(num_bands=4, rows_per_band=8)  # 32 bits: no prefix left


def test_rehash_drops_the_bucket_index_and_moves_the_banding(rng):
    """A rehash from 8 x 16 to 16 x 8 changes the word layout, the narrow
    refine width and the bucket index; answers equal the reference's."""
    jl, tl, X = _pair_lsh(rng, num_perm=128, num_bands=8, rows_per_band=16,
                          hash_family="structured", query_mode="bucket")
    for lsh in (jl, tl):
        lsh.query_batch(X[:4], top_k=3)  # builds the bucket index
    assert tl._storage._bucket_index is not None and tl._storage._refine_narrow_r == 16
    for lsh in (jl, tl):
        lsh.rehash(num_bands=16, rows_per_band=8, seed=2)
    store = tl._storage
    assert store._bucket_index is None and store._refine is None
    assert (store.words, store._refine_narrow_r) == (16, 8)
    assert tl.query_batch(X[:30], top_k=8) == jl.query_batch(X[:30], top_k=8)
    assert tl.stats()["index"]["bucket_overflows"] == jl.stats()["index"]["bucket_overflows"]


def test_rehash_past_64_bands_meets_the_item_8_raise(rng):
    """128 bands x 1 row: where the port used to raise, both packages now
    fall back to their chunked collision cores, with equal answers."""
    jl, tl, X = _pair_lsh(rng, num_perm=128, num_bands=16, rows_per_band=8,
                          hash_family="structured")
    for lsh in (jl, tl):
        lsh.rehash(num_bands=128, rows_per_band=1, seed=5)
    assert not tl._storage._use_grouped() and tl._storage.words == 128
    assert tl.query_batch(X[:12], top_k=6) == jl.query_batch(X[:12], top_k=6)
    assert tl.query_batch(X[:2], top_k=3)[0][0] == 0


def test_rehash_rules(rng):
    lsh, _ = _device_lsh(rng, enable_hamming=True)
    with pytest.raises(ValueError, match="cross-polytope boundary"):
        lsh.rehash(hash_family="crosspolytope")
    with pytest.raises(ValueError, match="retrain"):
        lsh.rehash(hash_family="learned")
    with pytest.raises(ValueError, match="hash_family"):
        lsh.rehash(hash_family="minhash")
    mp, _ = _device_lsh(rng, multiprobe=4)
    with pytest.raises(ValueError, match="multiprobe must be <= rows_per_band"):
        mp.rehash(num_bands=8, rows_per_band=2)
    cp, X = _device_lsh(rng, num_perm=64, num_bands=16, rows_per_band=4, engine="collision",
                        hash_family="crosspolytope")
    cp.rehash(hash_family="gaussian", num_bands=8, rows_per_band=8)
    assert cp.get_top_k(X[7], topk=1) == [7]
    assert cp.stats()["hash_family"] == "gaussian"


def test_serving_fn_auto_refresh(rng):
    """auto_refresh=True serves through mutations (the reference's
    `tests/test_core.py` case), a rehash among them."""
    lsh = LSHRS(dim=16, num_perm=32, num_bands=4, rows_per_band=8, engine="collision",
                initial_capacity=256, store_vectors=True, device="cpu")
    X = rng.standard_normal((120, 16)).astype(np.float32)
    lsh.index(np.arange(120), X)
    serve = lsh.serving_fn(top_k=3, auto_refresh=True)
    assert serve(X[:4])[:, 0].tolist() == [0, 1, 2, 3]
    Y = rng.standard_normal((4, 16)).astype(np.float32)
    lsh.index([500, 501, 502, 503], Y)
    assert serve(Y)[:, 0].tolist() == [500, 501, 502, 503]
    strict = lsh.serving_fn(top_k=3)
    lsh.delete([500])
    with pytest.raises(RuntimeError, match="stale"):
        strict(Y)
    assert serve(X[:2])[:, 0].tolist() == [0, 1]
    lsh.rehash(num_bands=8, rows_per_band=4, hash_family="structured")
    np.testing.assert_array_equal(serve(X[:40]), lsh.serving_fn(top_k=3)(X[:40]))
    topp = lsh.serving_fn(top_k=3, mode="topp", auto_refresh=True)
    first = topp(X[:5])
    lsh.delete([1])
    ids, _, _ = topp(X[:5])
    assert 1 not in ids and ids[0, 0] == 0 and first[0][1, 0] == 1
    with pytest.raises(ValueError, match="shape"):  # not a stale error: raised
        serve(np.ones((2, 5), np.float32))
    evens = np.arange(0, 120, 2)  # a filter rides through the refreshes
    filtered = lsh.serving_fn(top_k=3, auto_refresh=True, where=evens)
    filtered(X[:8])
    lsh.delete([2])
    lsh.rehash(num_bands=4, rows_per_band=8)
    got = filtered(X[:8])
    np.testing.assert_array_equal(got, lsh.serving_fn(top_k=3, where=evens)(X[:8]))
    assert np.isin(got[got >= 0], evens).all() and 2 not in got


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_rehashed_checkpoint_crosses_packages(direction, rng, tmp_path):
    """An index rehashed to another family and banding, saved by either
    package, loads in the other with the same words and answers."""
    jl, tl, X = _pair_lsh(rng, engine="auto")
    src = jl if direction == "jax_to_port" else tl
    src.delete([8, 9])
    src.rehash(num_bands=8, rows_per_band=2, seed=13, hash_family="structured")
    src.save_to_disk(tmp_path / "ckpt")
    if direction == "jax_to_port":
        back = LSHRS.load_from_disk(tmp_path / "ckpt", device="cpu")
    else:
        back = JaxLSHRS.load_from_disk(tmp_path / "ckpt")
    assert back._config == src._config and back._tpu_config["hash_family"] == "structured"
    np.testing.assert_array_equal(np.asarray(back._hasher.diagonals), np.asarray(src._hasher.diagonals))
    assert back.query_batch(X[:30], top_k=5) == src.query_batch(X[:30], top_k=5)
    want = src.get_above_p_batch(X[:5], p=0.5, top_k=5)
    got = back.get_above_p_batch(X[:5], p=0.5, top_k=5)
    assert [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]
