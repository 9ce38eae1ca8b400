"""Hamming refinement cascade: the port against `lshrs_tpu` on the same
words.

Contract (`lshrs_tpu_torch.ops.hamming.hamming_topk_cascade_core`): the
exact (hamming asc, id asc) top-k within the refined pool, equal to the
full-width exact ranking when the pool covers the store. The port selects
its pool exactly; the reference's `approx_max_k` is exact on the CPU, so
ids and distances must be IDENTICAL to the reference's — through the
store, its serving closure, filters, mutations, the int64 refine past the
int32 ceiling, a forced coarse tie shift, `LSHRS` and checkpoints written
by either package.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import hamming as jham
from lshrs_tpu.storage import IdFilter as JaxFilter
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch import IdFilter
from lshrs_tpu_torch.ops import hamming as tham
from lshrs_tpu_torch.ops.group_max import key_scale
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

B, R, D = 8, 16, 32
P = B * R  # 128 bits; prefix 32
KW = dict(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=256, group_size=8,
          enable_hamming=True)


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def _pair(cascade=32, refine=256, **kw):
    kw = {**KW, "hamming_cascade": cascade, "hamming_cascade_refine": refine, **kw}
    return JaxStore(**kw), TorchStore(device="cpu", **kw)


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def bits_of(words):
    n = words.shape[0]
    out = np.zeros((n, P), np.int32)
    for j in range(P):
        out[:, j] = (words[:, j // R] >> (j % R)) & 1
    return out


def _load(stores, ids, words):
    for s in stores:
        s.add_signature_batch(ids, words)


def test_cascade_coarse_scale_matches_reference():
    for p_pre in (32, 64, 96, 128, 224):
        for logc in range(10, 31):
            got = tham.cascade_coarse_scale(p_pre, 1 << logc)
            assert got == jham.cascade_coarse_scale(p_pre, 1 << logc)
            assert (p_pre + 2) * got[0] < 2**31 and got[0] == key_scale(1 << logc) >> got[1]
    assert tham.cascade_coarse_scale(128, 1 << 23) == (1 << 23, 0)  # 130 * 2**23 < 2**31
    assert tham.cascade_coarse_scale(128, 1 << 24) == (1 << 23, 1)


@pytest.mark.parametrize("refine,cascade", [(1 << 20, 32), (128, 32), (512, 64), (24, 96)])
def test_cascade_matches_reference(refine, cascade, hasher, rng):
    """Full pool (== the exact engine), deep and shallow pools, prefix
    widths 32 / 64 / 96: identical ids and distances."""
    n = 700
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(50_000)[:n]
    words = hasher.hash_batch_words_host(X)
    js, ts = _pair(cascade=cascade, refine=refine)
    _load((js, ts), ids, words)
    qw = hasher.hash_batch_words_host(
        np.concatenate([X[:8] + 0.05 * rng.standard_normal((8, D)).astype(np.float32),
                        rng.standard_normal((8, D)).astype(np.float32)])
    )
    got = ts.query_hamming(qw, 12)
    _same(got, js.query_hamming(qw, 12))
    if refine >= n:
        exact = TorchStore(device="cpu", **KW)
        exact.add_signature_batch(ids, words)
        _same(got, exact.query_hamming(qw, 12))
    # distances are the true full-width Hammings, in (hamming, id) order
    xb, qb = bits_of(words), bits_of(qw)
    pos = {int(i): s for s, i in enumerate(ids)}
    for q in range(16):
        for h, i in zip(*[g[q] for g in got]):
            if i >= 0:
                assert h == np.abs(xb[pos[int(i)]] - qb[q]).sum()
        pairs = list(zip(got[0][q].tolist(), got[1][q].tolist()))
        assert pairs == sorted(pairs)


def test_cascade_agreement_statistical(hasher, rng):
    n = 2000
    X = rng.standard_normal((n, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    exact = TorchStore(device="cpu", **KW)
    exact.add_signature_batch(np.arange(n), words)
    js, ts = _pair(cascade=64, refine=512)
    _load((js, ts), np.arange(n), words)
    qw = hasher.hash_batch_words_host(rng.standard_normal((32, D)).astype(np.float32))
    _, i0 = exact.query_hamming(qw, 10)
    got = ts.query_hamming(qw, 10)
    _same(got, js.query_hamming(qw, 10))
    overlap = np.mean([len(set(i0[q]) & set(got[1][q])) / 10 for q in range(32)])
    assert overlap >= 0.9, overlap


def test_cascade_prefix_planes_memory(hasher, rng):
    js, ts = _pair()
    words = hasher.hash_batch_words_host(rng.standard_normal((100, D)).astype(np.float32))
    _load((js, ts), np.arange(100), words)
    ts.query_hamming(words[:1], 1)  # materialises the planes
    assert ts._planes.shape == (ts._capacity, 32) and ts._planes.is_contiguous()
    st = ts.stats()
    assert st["hamming_cascade"] == 32 == js.stats()["hamming_cascade"]
    assert st["hamming_plane_bytes"] == ts._capacity * 32
    js.query_hamming(words[:1], 1)
    assert st["hamming_plane_bytes"] == js.stats()["hamming_plane_bytes"]


def test_cascade_after_mutations(hasher, rng):
    """Prefix planes stay in step through delete, upsert, growth, compact."""
    js, ts = _pair()
    X = rng.standard_normal((100, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    _load((js, ts), np.arange(100), words)
    h, out = ts.query_hamming(words[5:6], 1)
    assert out[0][0] == 5 and h[0][0] == 0
    q = hasher.hash_batch_words_host(rng.standard_normal((6, D)).astype(np.float32))
    for s in (js, ts):
        s.remove_indices([5, 17])
    assert 5 not in ts.query_hamming(words[5:6], 3)[1][0]
    _same(ts.query_hamming(q, 5), js.query_hamming(q, 5))
    w_new = hasher.hash_batch_words_host(rng.standard_normal((1, D)).astype(np.float32))
    _load((js, ts), [7], w_new)
    h, out = ts.query_hamming(w_new, 1)
    assert out[0][0] == 7 and h[0][0] == 0
    X2 = rng.standard_normal((400, D)).astype(np.float32)
    _load((js, ts), np.arange(1000, 1400), hasher.hash_batch_words_host(X2))
    assert ts._planes.shape[1] == 32 and ts._capacity == js._capacity
    _same(ts.query_hamming(q, 5), js.query_hamming(q, 5))
    for s in (js, ts):
        s.compact()
    _same(ts.query_hamming(q, 5), js.query_hamming(q, 5))


def test_cascade_where_filter(hasher, rng):
    n = 600
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(9000)[:n]
    words = hasher.hash_batch_words_host(X)
    js, ts = _pair(refine=64)
    _load((js, ts), ids, words)
    allow = ids[rng.random(n) < 0.4]
    flt, jflt = (F(allowed_ids=allow, disallowed_ids=allow[:3]) for F in (IdFilter, JaxFilter))
    qw = hasher.hash_batch_words_host(X[:10] + 0.1 * rng.standard_normal((10, D)).astype(np.float32))
    got = ts.query_hamming(qw, 8, where=flt)
    _same(got, js.query_hamming(qw, 8, where=jflt))
    assert flt.admits(got[1][got[1] >= 0]).all()
    np.testing.assert_array_equal(
        ts.snapshot_query_fn(8, mode="hamming", where=flt)(qw).numpy(), got[1])


def test_cascade_serving_closure_parity(hasher, rng):
    js, ts = _pair()
    words = hasher.hash_batch_words_host(rng.standard_normal((300, D)).astype(np.float32))
    _load((js, ts), np.arange(300), words)
    _, expect = ts.query_hamming(words[:8], 5)
    serve = ts.snapshot_query_fn(5, mode="hamming")
    got = serve(words[:8]).numpy()
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(got, np.asarray(js.snapshot_query_fn(5, mode="hamming")(words[:8])))
    ts.add_signature_batch([999], words[:1])
    with pytest.raises(RuntimeError, match="stale"):
        serve(words[:8])


def test_cascade_query_slices(hasher, rng, monkeypatch):
    """Query slices of a cascade batch change nothing: the store cuts 13
    queries into slices of 5, 5 and 3, one coarse pass and refine each."""
    js, ts = _pair(refine=64)
    words = hasher.hash_batch_words_host(rng.standard_normal((500, D)).astype(np.float32))
    _load((js, ts), np.arange(500), words)
    qw = hasher.hash_batch_words_host(rng.standard_normal((13, D)).astype(np.float32))
    want = js.query_hamming(qw, 6)
    ts._ensure_ranks()
    nw = ts._refine_rows().shape[1] // 8 - 2
    per_query = 4 * (ts._capacity // 8) + 8 * 8 * 8 * nw  # keys + a pool of 8 groups of 8
    monkeypatch.setattr(tham, "_CASCADE_SLICE_BYTES", 5 * per_query + 1)
    assert tham.cascade_slice_queries(ts._capacity, group=8, pool_groups=8, words=nw) == 5
    sizes = []
    core = tham.hamming_topk_cascade_core

    def counting(planes, tie, qbits, qwords, *a, **kw):
        sizes.append(qwords.shape[0])
        return core(planes, tie, qbits, qwords, *a, **kw)

    monkeypatch.setattr("lshrs_tpu_torch.storage.device.hamming_topk_cascade_core", counting)
    _same(ts.query_hamming(qw, 6), want)
    assert sizes == [5, 5, 3]


def _prepared(hasher, rng, n=512):
    X = rng.standard_normal((n // 2, D)).astype(np.float32)
    half = hasher.hash_batch_words_host(X)
    words = np.concatenate([half, half])  # duplicated signatures: id ties
    js, ts = _pair(refine=n, initial_capacity=n)
    _load((js, ts), np.arange(n, dtype=np.int32), words)
    for s in (js, ts):
        s._ensure_ranks()
        s._ensure_planes()
    qw = hasher.hash_batch_words_host(rng.standard_normal((8, D)).astype(np.float32))
    return js, ts, qw


def _torch_core(ts, qw, **kw):
    qt = torch.from_numpy(qw.view(np.int32))
    return tham.hamming_topk_cascade_core(
        ts._planes, ts._tie, ts._planes_rows(qt), qt, None,
        sig_t=ts._sig_t, ids=ts._ids, group=8, **kw)


def _jax_core(js, qw, **kw):
    import jax.numpy as jnp

    qbits = jham.unpack_bitplanes(jnp.asarray(qw), num_bands=B, rows_per_band=R)[:, :32]
    return jham.hamming_topk_cascade_core(
        js._planes, js._sig_t, js._ids, js._tie, qbits, jnp.asarray(qw),
        chunk=64, group=8, **kw)


def test_cascade_int64_refine_past_the_ceiling(hasher, rng):
    """A num_perm past the int32 key ceiling ((p + 2) * key_scale(C) >=
    2**31) takes the int64 refine key: the same order as below it, as the
    reference's two-key selector, and as a lexsort oracle."""
    js, ts, qw = _prepared(hasher, rng)
    big_p = 1 << 22
    assert (big_p + 2) * key_scale(512) >= 2**31
    kw = dict(k=10, refine_groups=16)
    h_big, i_big = _torch_core(ts, qw, num_perm=big_p, **kw)
    h_ref, i_ref = _torch_core(ts, qw, num_perm=P, **kw)
    assert torch.equal(i_big, i_ref) and torch.equal(h_big, h_ref)  # true popcounts
    _same((h_big, i_big), _jax_core(js, qw, num_perm=big_p, **kw))
    _same((h_ref, i_ref), _jax_core(js, qw, num_perm=P, **kw))
    # lexsort oracle over the pool: every slot of the top-16 coarse groups
    words = np.asarray(ts._sig_rows).view(np.uint32)
    xb, qb = bits_of(words), bits_of(qw)
    for q in range(8):
        pairs = list(zip(h_ref[q].tolist(), i_ref[q].tolist()))
        assert pairs == sorted(pairs)
        for h, i in pairs:
            assert h == np.abs(xb[i] - qb[q]).sum()


def test_cascade_tie_shift_full_pool(hasher, rng, monkeypatch):
    """A coarse tie shift (forced by inflating key_scale, as at 2**24 slots
    with a 128-bit prefix) with a full pool: the exact full-width top-k,
    the same as the reference's under the same patch."""
    js, ts, qw = _prepared(hasher, rng)
    kw = dict(num_perm=P, k=10, refine_groups=512)
    want = _torch_core(ts, qw, **kw)
    real = key_scale
    inflate = lambda c: max(real(c), 1 << 26)  # noqa: E731
    monkeypatch.setattr(tham, "key_scale", inflate)
    monkeypatch.setattr(jham, "key_scale", inflate)
    assert tham.cascade_coarse_scale(32, 512)[1] > 0
    got = _torch_core(ts, qw, **kw)
    _same(got, want)
    _same(got, _jax_core(js, qw, **kw))


def test_cascade_validation():
    for kw, exc, match in (
        (dict(hamming_cascade=33), ValueError, "multiple of 32"),
        (dict(hamming_cascade=P), ValueError, "below num_perm"),
        (dict(hamming_cascade=32, enable_hamming=False), ValueError, "enable_hamming"),
        (dict(hamming_cascade=32, hamming_storage="packed"), ValueError, "enable_hamming"),
        (dict(hamming_cascade=32, hamming_cascade_refine=0), ValueError, "greater than zero"),
    ):
        with pytest.raises(exc, match=match):
            TorchStore(device="cpu", **{**KW, **kw})
        with pytest.raises(exc, match=match):
            JaxStore(**{**KW, **kw})
    with pytest.raises(ValueError, match="enable_hamming"):
        TorchLSHRS(dim=D, num_perm=P, num_bands=B, rows_per_band=R, engine="collision",
                   hamming_cascade=32, device="cpu")


def test_cascade_rejects_asymmetric(hasher, rng):
    js, ts = _pair()
    words = hasher.hash_batch_words_host(rng.standard_normal((50, D)).astype(np.float32))
    _load((js, ts), np.arange(50), words)
    qc = np.zeros((1, P), np.int8)
    with pytest.raises(RuntimeError, match="asymmetric"):
        ts.query_asymmetric(qc, 3)
    with pytest.raises(RuntimeError, match="asymmetric"):
        ts.snapshot_query_fn(3, mode="asymmetric")


LSH_KW = dict(dim=D, num_perm=P, num_bands=B, rows_per_band=R, engine="hamming", chunk_size=64,
              initial_capacity=256, group_size=8, hamming_cascade=32,
              hamming_cascade_refine=256, hash_mode="host")


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_cascade_orchestrator_and_persistence(writer, tmp_path, rng):
    """Both packages serve the same ids; a checkpoint written by either
    package restores the cascade in the other (and pickles)."""
    jl, tl = JaxLSHRS(**LSH_KW), TorchLSHRS(device="cpu", **LSH_KW)
    X = rng.standard_normal((300, D)).astype(np.float32)
    for lsh in (jl, tl):
        lsh.index(list(range(300)), X)
    Q = X[:10] + 0.2 * rng.standard_normal((10, D)).astype(np.float32)
    out = tl.query_hamming(X[42], top_k=5)
    assert out[0][0] == 42 and out == jl.query_hamming(X[42], top_k=5)
    assert tl.query_batch(Q, top_k=6) == jl.query_batch(Q, top_k=6)
    np.testing.assert_array_equal(tl.serving_fn(top_k=6)(Q), np.asarray(jl.serving_fn(top_k=6)(Q)))
    src = tl if writer == "torch" else jl
    src.save_to_disk(tmp_path / "idx")
    for cls, kw in ((TorchLSHRS, {"device": "cpu"}), (JaxLSHRS, {})):
        back = cls.load_from_disk(tmp_path / "idx", **kw)
        assert back._tpu_config["hamming_cascade"] == 32
        assert back._tpu_config["hamming_cascade_refine"] == 256
        assert back._storage.hamming_cascade == 32
        assert back.query_hamming(X[42], top_k=5) == out
        assert back.query_batch(Q, top_k=6) == tl.query_batch(Q, top_k=6)
    clone = pickle.loads(pickle.dumps(tl))
    assert clone._storage.hamming_cascade == 32 and clone.stats()["index"]["hamming_cascade"] == 32
    assert clone.query_hamming(X[42], top_k=5) == out
