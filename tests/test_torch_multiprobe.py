"""Multi-probe querying: the port against the JAX package.

With ``multiprobe=T`` a query carries T probe signatures per band and a
band counts when it matches ANY of them. Both stores are fed the same
probe words, so counts and ids must be ``array_equal``; top-p cosines
agree within 1e-5 on graded-cosine data. The structured and cross-polytope
families hash bit-identically on host and device in both packages, so the
``LSHRS``-level cases run both hash modes across packages; the gaussian
family runs the host mode.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest
import torch

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage import IdFilter as JaxFilter
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch import IdFilter
from lshrs_tpu_torch.ops.group_max import band_counts_t, group_max_keys, key_scale
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

DIM, K, GAP = 32, 9, 1e-5
# (family, num_bands, rows_per_band)
BANDINGS = [("gaussian", 8, 8), ("structured", 8, 8), ("crosspolytope", 8, 6), ("gaussian", 4, 40)]


def _data(rng, clusters=40, members=16, noise=0.08):
    c = rng.standard_normal((clusters, DIM)).astype(np.float32)
    steps = noise * (1 + np.arange(members, dtype=np.float32))
    X = (c[:, None] + steps[None, :, None] * rng.standard_normal(
        (clusters, members, DIM)).astype(np.float32)).reshape(-1, DIM)
    Q = np.concatenate([
        c[:10] + 0.1 * rng.standard_normal((10, DIM)).astype(np.float32), X[5:6],
    ])
    return rng.permutation(5 * len(X))[: len(X)], X, Q


def _stores(family, nb, r, ids, X, **kw):
    h = LSHHasher(num_bands=nb, rows_per_band=r, dim=DIM, seed=11, hash_family=family)
    kw = dict(num_bands=nb, rows_per_band=r, dim=DIM, chunk_size=128, initial_capacity=256, **kw)
    js, ts = JaxStore(**kw), TorchStore(device="cpu", **kw)
    words = h.hash_batch_words_host(X)
    for s in (js, ts):
        s.add_signature_batch(ids, words, X if kw.get("store_vectors") else None)
    return h, js, ts


def _eq(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("probes", [2, 4])
@pytest.mark.parametrize("family,nb,r", BANDINGS)
def test_probed_topk_counts_and_nnz_match(family, nb, r, probes, rng):
    ids, X, Q = _data(rng)
    h, js, ts = _stores(family, nb, r, ids, X)
    pw = h.hash_batch_probe_words_host(Q, probes)
    assert pw.shape == (len(Q), probes, js.words)
    for k in (1, K, 300):
        _eq(ts.query_topk(pw, k), js.query_topk(pw, k))
    np.testing.assert_array_equal(ts.query_topk_ids(pw, K).numpy(), np.asarray(js.query_topk_ids(pw, K)))
    _eq(ts.query_counts(pw), js.query_counts(pw))
    np.testing.assert_array_equal(ts.query_nnz(pw), js.query_nnz(pw))
    # probing only adds matches: every slot's count grows or stays
    c1, _ = ts.query_counts(pw[:, 0])
    ct, _ = ts.query_counts(pw)
    assert (ct >= c1).all() and (ct > c1).any() and ct.max() <= nb
    # a torch tensor of probe words is taken as it is
    _eq(ts.query_topk(torch.from_numpy(pw.view(np.int32)), K), js.query_topk(pw, K))
    # probes and a filter together
    spec = (np.sort(ids)[::2], np.sort(ids)[::5])
    _eq(ts.query_topk(pw, K, where=IdFilter(*spec)), js.query_topk(pw, K, where=JaxFilter(*spec)))


@pytest.mark.parametrize("probes", [2, 3])
@pytest.mark.parametrize("wire", ["words", "flat", "dense"])
def test_probed_snapshot_query_fn_matches(wire, probes, rng):
    ids, X, Q = _data(rng)
    h, js, ts = _stores("structured", 8, 8, ids, X, enable_hamming=True)
    if wire == "dense":
        sig = h.hash_batch_probe_dense_host(Q, probes)
        assert sig.shape == (len(Q), probes, 8) and sig.dtype == np.uint8
    else:
        sig = h.hash_batch_probe_words_host(Q, probes)
        if wire == "flat":
            sig = sig.reshape(len(Q), -1)
    w = "dense" if wire == "dense" else "words"
    want = np.asarray(js.snapshot_query_fn(K, wire=w, probes=probes)(sig))
    np.testing.assert_array_equal(ts.snapshot_query_fn(K, wire=w, probes=probes)(sig).numpy(), want)
    np.testing.assert_array_equal(
        want, js.query_topk(h.hash_batch_probe_words_host(Q, probes), K)[1]
    )
    with pytest.raises(ValueError, match="collision counting only"):
        ts.snapshot_query_fn(K, mode="hamming", probes=probes)
    with pytest.raises(ValueError, match="probes must be >= 1"):
        ts.snapshot_query_fn(K, probes=0)
    with pytest.raises(ValueError, match="words per"):
        ts.snapshot_query_fn(K, probes=probes)(h.hash_batch_words_host(Q))


def test_hamming_takes_no_probe_axis(rng):
    ids, X, Q = _data(rng)
    h, _, ts = _stores("gaussian", 8, 8, ids, X, enable_hamming=True)
    with pytest.raises(ValueError, match="collision counting only"):
        ts.query_hamming(h.hash_batch_probe_words_host(Q, 2), 3)
    with pytest.raises(ValueError, match="query words must have shape"):
        ts.query_topk(np.zeros((2, 3, 5), np.uint32), 3)


def _assert_topp_equal(got, want):
    (gi, gs, gn), (wi, ws, wn) = got, [np.asarray(a) for a in want]
    np.testing.assert_array_equal(np.asarray(gn), wn)
    np.testing.assert_array_equal(np.asarray(gi), wi)
    valid = wi >= 0
    d = np.abs(np.diff(np.where(valid, ws, np.nan), axis=1))
    assert (d[valid[:, 1:]] > GAP).all(), "near-tie in the compared cosines"
    np.testing.assert_allclose(np.asarray(gs)[valid], ws[valid], rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["full", "gather"])
@pytest.mark.parametrize("family,nb,r", BANDINGS[:3])
def test_probed_topp_matches(family, nb, r, engine, rng):
    ids, X, Q = _data(rng)
    h, js, ts = _stores(family, nb, r, ids, X, store_vectors=True, payload_dtype="int8",
                        rerank_engine=engine, rerank_candidates=128)
    pw = h.hash_batch_probe_words_host(Q, 3)
    got = ts.query_topp_batch(pw, Q, 6)
    _assert_topp_equal(got, js.query_topp_batch(pw, Q, 6))
    assert (got[2] >= ts.query_topp_batch(pw[:, 0], Q, 6)[2]).all()
    g, w = ts.query_topp(pw[:1], Q[0], 6), js.query_topp(pw[:1], Q[0], 6)
    _assert_topp_equal((g[0][None], g[1][None], np.asarray([g[2]])),
                       (w[0][None], w[1][None], np.asarray([w[2]])))
    for wire in ("words", "dense"):
        sig = pw if wire == "words" else h.hash_batch_probe_dense_host(Q, 3)
        serve = ts.snapshot_topp_fn(6, wire=wire, probes=3, batch_hint=len(Q))
        want = js.snapshot_topp_fn(6, wire=wire, probes=3, batch_hint=len(Q))(sig, Q)
        _assert_topp_equal([t.numpy() for t in serve(sig, Q)], want)
    spec = (np.sort(ids)[::2], None)
    _assert_topp_equal(ts.query_topp_batch(pw, Q, 6, where=IdFilter(*spec)),
                       js.query_topp_batch(pw, Q, 6, where=JaxFilter(*spec)))


def test_kernel_wrapper_counts_any_probe_match():
    """B1's plain version at probes 2 and 4 against an explicit per-band OR."""
    g = torch.Generator().manual_seed(5)
    bw, c, q = 6, 256, 9
    sig = torch.randint(0, 3, (bw, c), dtype=torch.int32, generator=g)
    tie = torch.randperm(c, generator=g).to(torch.int32)
    tie[::9] = -1
    for probes in (2, 4):
        base = torch.randint(0, 3, (q, 1, bw), dtype=torch.int32, generator=g)
        qw = ((base + torch.arange(probes, dtype=torch.int32)[None, :, None]) % 5)
        qw = qw.reshape(q, probes * bw).contiguous()
        counts = band_counts_t(sig, qw, bw, probes)
        any_match = torch.zeros((q, c), dtype=torch.int32)
        for b in range(bw):
            hit = torch.zeros((q, c), dtype=torch.bool)
            for t in range(probes):
                hit |= sig[b][None, :] == qw[:, t * bw + b][:, None]
            any_match += hit
        assert torch.equal(counts, any_match)
        scale = key_scale(c)
        keys = group_max_keys(sig, tie, qw, num_bands=bw, words=1, group=16, scale=scale,
                              probes=probes)
        want = (counts * scale + torch.where(tie >= 0, tie, -bw * scale)[None, :]).reshape(
            q, c // 16, 16).amax(-1)
        assert torch.equal(keys, want)


# ---------------------------------------------------------------------------
# LSHRS entry points
# ---------------------------------------------------------------------------

def _lsh_pair(ids, X, family, nb, r, **kw):
    base = dict(dim=DIM, num_perm=nb * r, num_bands=nb, rows_per_band=r, seed=11, chunk_size=128,
                initial_capacity=256, hash_family=family)
    if family == "crosspolytope":
        kw.setdefault("engine", "collision")
    jl, tl = JaxLSHRS(**{**base, **kw}), TorchLSHRS(device="cpu", **{**base, **kw})
    for lsh in (jl, tl):
        lsh.index(ids.tolist(), X)
    return jl, tl


CASES = [("gaussian", 8, 8, "host"), ("structured", 8, 8, "host"), ("structured", 8, 8, "device"),
         ("crosspolytope", 8, 6, "host"), ("crosspolytope", 8, 6, "device")]


@pytest.mark.parametrize("probes", [2, 4])
@pytest.mark.parametrize("family,nb,r,hash_mode", CASES)
def test_lshrs_multiprobe_topk_matches(family, nb, r, hash_mode, probes, rng):
    ids, X, Q = _data(rng)
    jl, tl = _lsh_pair(ids, X, family, nb, r, hash_mode=hash_mode, multiprobe=probes,
                       engine="collision")
    assert tl.stats()["multiprobe"] == probes and tl.stats()["hash_family"] == family
    assert tl.query_batch(Q, top_k=K) == jl.query_batch(Q, top_k=K)
    for q in Q[:4]:
        assert tl.query(q, top_k=K) == jl.query(q, top_k=K)
        assert tl.query(q, top_k=None) == jl.query(q, top_k=None)
    np.testing.assert_array_equal(
        tl.serving_fn(top_k=K)(Q), np.asarray(jl.serving_fn(top_k=K)(Q))
    )
    # a stored vector collides with itself in every band (others may tie, id asc)
    assert int(ids[7]) in tl.query(X[7], top_k=K)
    # probing widens the candidate set of the same index
    _, t1 = _lsh_pair(ids, X, family, nb, r, hash_mode=hash_mode, engine="collision")
    n1 = [len(t1.query(q, top_k=None)) for q in Q]
    nt = [len(tl.query(q, top_k=None)) for q in Q]
    assert all(b >= a for a, b in zip(n1, nt)) and sum(nt) > sum(n1)
    spec = (np.sort(ids)[::2], None)
    assert tl.query_batch(Q, top_k=K, where=IdFilter(*spec)) == \
        jl.query_batch(Q, top_k=K, where=JaxFilter(*spec))


@pytest.mark.parametrize("hash_mode", ["host", "device"])
def test_lshrs_multiprobe_hamming_ranks_probe_zero(hash_mode, rng):
    ids, X, Q = _data(rng)
    jl, tl = _lsh_pair(ids, X, "structured", 8, 8, hash_mode=hash_mode, multiprobe=3,
                       engine="hamming")
    _, t1 = _lsh_pair(ids, X, "structured", 8, 8, hash_mode=hash_mode, engine="hamming")
    assert tl.query_batch(Q, top_k=K) == jl.query_batch(Q, top_k=K) == t1.query_batch(Q, top_k=K)
    assert tl.query(Q[0], top_k=K) == jl.query(Q[0], top_k=K)
    assert tl.query_hamming(Q[1], top_k=K) == jl.query_hamming(Q[1], top_k=K)
    np.testing.assert_array_equal(
        tl.serving_fn(top_k=K)(Q), np.asarray(jl.serving_fn(top_k=K)(Q))
    )
    # the collision closure of the same instance does probe
    np.testing.assert_array_equal(
        tl.serving_fn(top_k=K, mode="collision")(Q),
        np.asarray(jl.serving_fn(top_k=K, mode="collision")(Q)),
    )


def _assert_scored_equal(got, want):
    assert [i for i, _ in got] == [i for i, _ in want]
    w = np.asarray([s for _, s in want], np.float64)
    assert (np.abs(np.diff(w)) > GAP).all(), "near-tie in the compared cosines"
    np.testing.assert_allclose([s for _, s in got], w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("engine", ["full", "gather"])
@pytest.mark.parametrize("family,nb,r,hash_mode", CASES[1:])
def test_lshrs_multiprobe_top_p_matches(family, nb, r, hash_mode, engine, rng):
    ids, X, Q = _data(rng)
    jl, tl = _lsh_pair(ids, X, family, nb, r, hash_mode=hash_mode, multiprobe=3,
                       store_vectors=True, rerank_engine=engine, rerank_candidates=128)
    for g, w in zip(tl.get_above_p_batch(Q, p=0.5, top_k=6), jl.get_above_p_batch(Q, p=0.5, top_k=6)):
        _assert_scored_equal(g, w)
    for q in Q[:3]:
        _assert_scored_equal(tl.query(q, top_p=1.0, top_k=5), jl.query(q, top_p=1.0, top_k=5))
    got = tl.serving_fn(top_k=5, mode="topp", batch_hint=len(Q))(Q)
    _assert_topp_equal(got, jl.serving_fn(top_k=5, mode="topp", batch_hint=len(Q))(Q))


@pytest.mark.parametrize("kw,match", [
    (dict(multiprobe=0), "integer >= 1"),
    (dict(multiprobe=2.0), "integer >= 1"),
    (dict(multiprobe=9), "rows_per_band"),
    (dict(multiprobe=33, hash_family="crosspolytope", num_perm=48, rows_per_band=6), "cp_dims"),
    (dict(hash_family="crosspolytope", engine="hamming", num_perm=48, rows_per_band=6), "sign-bit"),
    (dict(hash_family="crosspolytope", enable_hamming=True, num_perm=48, rows_per_band=6),
     "enable_hamming is unavailable"),
    (dict(hash_family="minhash"), "hash_family must be"),
])
def test_constructor_validation_matches(kw, match):
    base = dict(dim=DIM, num_perm=64, num_bands=8, rows_per_band=8)
    with pytest.raises(ValueError, match=match) as got:
        TorchLSHRS(device="cpu", **{**base, **kw})
    with pytest.raises(ValueError) as want:
        JaxLSHRS(**{**base, **kw})
    assert str(got.value) == str(want.value)


def test_crosspolytope_forces_collision_and_auto_banding():
    kw = dict(dim=64, num_perm=64, similarity_threshold=0.7, hash_family="crosspolytope")
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    for key in ("num_bands", "rows_per_band", "engine", "ranking", "multiprobe"):
        assert tl.stats()[key] == jl.stats()[key], key
    assert tl.stats()["engine"] == "collision" and not tl._storage.enable_hamming
    with pytest.raises(ValueError, match="sign-bit signatures"):
        tl.serving_fn(top_k=3, mode="hamming")


@pytest.mark.parametrize("family,nb,r", [("structured", 8, 8), ("crosspolytope", 8, 6)])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax", "port_pickle"])
def test_family_checkpoints_cross_packages(family, nb, r, direction, tmp_path, rng):
    ids, X, Q = _data(rng)
    jl, tl = _lsh_pair(ids, X, family, nb, r, hash_mode="device", multiprobe=2,
                       store_vectors=True, engine="collision")
    src = jl if direction == "jax_to_port" else tl
    want = (src.query_batch(Q, top_k=K), [src.query(q, top_k=None) for q in Q[:3]])
    if direction == "port_pickle":
        back = pickle.loads(pickle.dumps(src))
    else:
        src.save_to_disk(tmp_path / "ckpt")
        assert (tmp_path / "ckpt" / "diagonals.npz").exists()
        assert not (tmp_path / "ckpt" / "projections.npz").exists()
        if direction == "jax_to_port":
            back = TorchLSHRS.load_from_disk(tmp_path / "ckpt", device="cpu")
        else:
            back = JaxLSHRS.load_from_disk(tmp_path / "ckpt")
    assert (back.query_batch(Q, top_k=K), [back.query(q, top_k=None) for q in Q[:3]]) == want
    np.testing.assert_array_equal(back._hasher.diagonals, src._hasher.diagonals)
    for key in ("multiprobe", "num_bands", "rows_per_band", "engine"):
        assert back.stats()[key] == src.stats()[key]
    # a restored index with other diagonals would answer differently: the
    # file, not the seed, decides
    assert back._hasher.hash_family == family


def test_learned_checkpoint_crosses_packages(tmp_path, rng):
    from lshrs_tpu_torch.hash.itq import fit_itq_projection

    ids, X, Q = _data(rng)
    proj = fit_itq_projection(X, 64, seed=1)
    jl, tl = _lsh_pair(ids[:0], X[:0], "learned", 8, 8, hash_mode="host", engine="collision")
    for lsh in (jl, tl):
        lsh._hasher.projections = [proj[b * 8 : (b + 1) * 8] for b in range(8)]
        lsh.index(ids.tolist(), X)
    assert tl.query_batch(Q, top_k=K) == jl.query_batch(Q, top_k=K)
    tl.save_to_disk(tmp_path / "a")
    jl.save_to_disk(tmp_path / "b")
    assert JaxLSHRS.load_from_disk(tmp_path / "a").query_batch(Q, top_k=K) == \
        TorchLSHRS.load_from_disk(tmp_path / "b", device="cpu").query_batch(Q, top_k=K) == \
        tl.query_batch(Q, top_k=K)
    assert TorchLSHRS.load_from_disk(tmp_path / "b", device="cpu").stats()["hash_family"] == "learned"
