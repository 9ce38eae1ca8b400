"""Top-p rerank cores and full-count scans: the port against the JAX package.

Both packages' stores take the same seeded words and vectors; the cores
then run on each store's own state (the JAX side as its own tests run
it on the CPU, ``use_pallas=False``). Ids, candidate counts and exact
flags must be equal; cosines agree within 1e-5 (float32 sums in another
order). Inputs are clustered with graded noise so that no two compared
cosines lie within 1e-5 of each other; every ranking test asserts that.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import rerank as jrerank
from lshrs_tpu.ops import scan as jscan
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch.ops import rerank as trerank
from lshrs_tpu_torch.ops import scan as tscan
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

COS_TOL = 1e-5
GAP = 1e-5


def clustered(rng, n, dim, members=16):
    """``n`` vectors in clusters of ``members``: member k carries noise
    0.05 * (k + 1), so cosines to a cluster's centre are graded."""
    centers = rng.standard_normal((n // members, dim)).astype(np.float32)
    levels = 0.05 * (1 + np.arange(members, dtype=np.float32))
    noise = rng.standard_normal((n // members, members, dim)).astype(np.float32)
    X = centers[:, None, :] + levels[None, :, None] * noise
    return X.reshape(-1, dim), centers


def build_pair(rng, *, nb, r, dim=64, n=3072, capacity=4096, group=64, payload_dtype="float32",
               deleted=40, **kw):
    """Both stores over the same words and vectors, ``deleted`` ids
    tombstoned; returns ``(hasher, X, centers, jax store, port store)``."""
    h = LSHHasher(num_bands=nb, rows_per_band=r, dim=dim, seed=17)
    X, centers = clustered(rng, n, dim)
    ids = rng.permutation(10 * n)[:n]
    args = dict(num_bands=nb, rows_per_band=r, dim=dim, store_vectors=True,
                payload_dtype=payload_dtype, chunk_size=256, initial_capacity=capacity,
                group_size=group, **kw)
    js, ts = JaxStore(**args), TorchStore(device="cpu", **args)
    words = h.hash_batch_words_host(X)
    gone = ids[rng.choice(n, deleted, replace=False)].tolist()
    for store in (js, ts):
        store.add_signature_batch(ids, words, X)
        store.remove_indices(gone)
    return h, X, centers, js, ts


def queries(rng, X, centers, q=24):
    """Noisy cluster centres, two stored vectors and two random vectors."""
    dim = X.shape[1]
    pick = rng.choice(len(centers), q - 4, replace=False)
    Q = centers[pick] + 0.02 * rng.standard_normal((q - 4, dim)).astype(np.float32)
    return np.concatenate([Q, X[[5, 77]], rng.standard_normal((2, dim)).astype(np.float32)])


def assert_no_near_ties(ids, sims):
    """The compared prefix of each row (its valid ids): consecutive
    cosines differ by more than GAP."""
    for row_ids, row_sims in zip(np.asarray(ids), np.asarray(sims, np.float64)):
        s = row_sims[np.asarray(row_ids) >= 0]
        assert (np.abs(np.diff(s)) > GAP).all(), "near-tie in the compared cosines"


def assert_same_ranking(got, want, *, rtol=0.0):
    """``(ids, sims, n[, exact])``: ids, n (and exact) equal, sims close."""
    g_ids, g_sims, g_n = (np.asarray(x) for x in got[:3])
    w_ids, w_sims, w_n = (np.asarray(x) for x in want[:3])
    np.testing.assert_array_equal(g_n, w_n)
    np.testing.assert_array_equal(g_ids, w_ids)
    valid = w_ids >= 0  # sims past the valid prefix are unspecified
    np.testing.assert_allclose(g_sims[valid], w_sims[valid], rtol=rtol, atol=COS_TOL)
    if len(got) == 4:
        np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))


def jax_qv(Q, wire):
    qv = jnp.asarray(Q)
    return qv.astype(jnp.bfloat16) if wire == "bfloat16" else qv


def torch_qv(Q, wire):
    qv = torch.from_numpy(Q)
    return qv.to(torch.bfloat16) if wire == "bfloat16" else qv


def words_of(h, Q):
    return h.hash_batch_words_host(Q)


# ---------------------------------------------------------------------------
# full-count scans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nb,r", [(16, 16), (8, 8)])
@pytest.mark.parametrize("probes", [1, 2])
@pytest.mark.parametrize("chunk", [256, 1000, 1 << 20])  # ragged and single-step
def test_collision_counts_and_nnz_match(nb, r, probes, chunk, rng):
    h, X, centers, js, ts = build_pair(rng, nb=nb, r=r, n=1024, capacity=2048)
    qw = words_of(h, queries(rng, X, centers, q=12))
    if probes > 1:  # probe 1 flips bit 0 of every band (pairwise distinct)
        qw = np.concatenate([qw, qw ^ np.uint32(1)], axis=1)
    sig_t_j, ids_j = js._sig_t, js._ids
    want = np.asarray(jscan.collision_counts(
        sig_t_j, ids_j, jnp.asarray(qw), num_bands=nb, chunk=256, probes=probes))
    want_nnz = np.asarray(jscan.collision_nnz(
        sig_t_j, ids_j, jnp.asarray(qw), num_bands=nb, chunk=256, probes=probes))
    tqw = torch.from_numpy(qw.view(np.int32))
    got = tscan.collision_counts_core(ts._sig_t, ts._ids, tqw, num_bands=nb, chunk=chunk,
                                      probes=probes)
    got_nnz = tscan.collision_nnz_core(ts._sig_t, ts._ids, tqw, num_bands=nb, chunk=chunk,
                                       probes=probes)
    assert got.dtype == got_nnz.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_nnz.numpy(), want_nnz)
    np.testing.assert_array_equal(got_nnz.numpy(), (want > 0).sum(1))
    assert (want_nnz > 0).any() and (want[:, ts._ids.numpy() < 0] == 0).all()


def test_store_count_queries_match(rng):
    h, X, centers, js, ts = build_pair(rng, nb=16, r=16)
    qw = words_of(h, queries(rng, X, centers))
    for got, want in zip(ts.query_counts(qw), js.query_counts(qw)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ts.query_nnz(qw), js.query_nnz(qw))


def test_count_step_keeps_steps_near_one_gigabyte():
    assert tscan.count_step(256, 2048) == 1 << 20  # one step at Q=256, C=2**20
    assert tscan.count_step(8192, 2048) == 1 << 15
    assert tscan.count_step(1 << 20, 2048) == 2048  # never below the floor
    assert tscan.count_step(256, 2048) * 256 * 4 == 1 << 30


# ---------------------------------------------------------------------------
# rerank cores
# ---------------------------------------------------------------------------

PAYLOADS = ["float32", "bfloat16", "int8"]


@pytest.mark.parametrize("payload_dtype", PAYLOADS)
def test_single_query_core_matches(payload_dtype, rng):
    h, X, centers, js, ts = build_pair(rng, nb=16, r=16, payload_dtype=payload_dtype)
    Q = queries(rng, X, centers, q=8)
    qw = words_of(h, Q)
    counts_j = jscan.collision_counts(js._sig_t, js._ids, jnp.asarray(qw), num_bands=16, chunk=256)
    counts_t = ts._counts_dev(torch.from_numpy(qw.view(np.int32)))
    for i in range(len(Q)):
        want = jrerank.rerank_topp(js._payload, js._pnorm, js._ids, counts_j[i],
                                   jnp.asarray(Q[i]), max_out=12)
        got = trerank.rerank_topp_core(ts._payload, ts._pnorm, ts._ids, counts_t[i],
                                       torch.from_numpy(Q[i]), max_out=12)
        assert_no_near_ties(np.asarray(want[0])[None], np.asarray(want[1])[None])
        assert_same_ranking([g[None] for g in got], [np.asarray(w)[None] for w in want])


@pytest.mark.parametrize("payload_dtype", PAYLOADS)
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_out,capacity", [
    (12, 4096),    # out <= 1024 < C: value top-k, then the exact sort
    (2000, 4096),  # out past 1024: the full two-key sort
    (12, 1024),    # C <= 1024: the full two-key sort
])
def test_batch_core_matches(payload_dtype, wire, max_out, capacity, rng):
    h, X, centers, js, ts = build_pair(rng, nb=16, r=16, n=min(3072, capacity - 64),
                                       capacity=capacity, payload_dtype=payload_dtype)
    Q = queries(rng, X, centers)
    qw = words_of(h, Q)
    counts_j = jscan.collision_counts(js._sig_t, js._ids, jnp.asarray(qw), num_bands=16, chunk=256)
    want = jrerank.rerank_topp_batch(js._payload, js._pnorm, js._ids, counts_j,
                                     jax_qv(Q, wire), max_out=max_out)
    counts_t = ts._counts_dev(torch.from_numpy(qw.view(np.int32)))
    got = trerank.rerank_topp_batch_core(ts._payload, ts._pnorm, ts._ids, counts_t,
                                         torch_qv(Q, wire), max_out=max_out)
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    assert tuple(got[0].shape) == (len(Q), min(max_out, capacity))
    assert_no_near_ties(np.asarray(want[0]), np.asarray(want[1]))
    assert_same_ranking(got, want, rtol=1e-2 if wire == "bfloat16" else 0.0)
    assert (np.asarray(want[2])[:-2] > 0).all()  # every query but the random ones collides


def test_full_engine_steps_over_slots_gives_the_same_dots(rng, monkeypatch):
    _, X, _, _, ts = build_pair(rng, nb=8, r=8, payload_dtype="int8")
    qd = torch.from_numpy(X[:5]).to(torch.bfloat16).float()
    whole = trerank._payload_dots(ts._payload, qd)
    monkeypatch.setattr(trerank, "_DOT_SLOTS", 1000)  # ragged steps
    torch.testing.assert_close(trerank._payload_dots(ts._payload, qd), whole, rtol=0, atol=0)


def _gather_pair(js, ts, qw, Q, *, wire="float32", max_out=12, mc=512, group=64):
    js._ensure_ranks()
    want = jrerank.rerank_topp_gather(
        js._payload, js._pnorm, js._ids, js._tie, js._sig_t, jnp.asarray(qw), jax_qv(Q, wire),
        num_bands=js.num_bands, max_out=max_out, max_candidates=mc, group=group,
        pallas_chunk=4096, q_tile=8, use_pallas=False,
        sig_rows=js._refine_rows_for(group, 4096, False), narrow_r=js._refine_narrow_r,
    )
    ts._ensure_ranks()
    got = trerank.rerank_topp_gather_core(
        ts._payload, ts._pnorm, ts._tie, ts._sig_t, torch.from_numpy(qw.view(np.int32)),
        torch_qv(Q, wire), ts._refine_rows(),
        num_bands=ts.num_bands, max_out=max_out, max_candidates=mc, group=group,
        narrow_r=ts._refine_narrow_r,
    )
    return got, want


@pytest.mark.parametrize("payload_dtype", PAYLOADS)
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb,r,group", [(16, 16, 64), (16, 16, 16), (8, 8, 64)])
def test_gather_core_matches(payload_dtype, wire, nb, r, group, rng):
    h, X, centers, js, ts = build_pair(rng, nb=nb, r=r, group=group, payload_dtype=payload_dtype)
    Q = queries(rng, X, centers)
    qw = words_of(h, Q)
    got, want = _gather_pair(js, ts, qw, Q, wire=wire, group=group)
    assert_no_near_ties(np.asarray(want[0]), np.asarray(want[1]))
    assert_same_ranking(got, want, rtol=1e-2 if wire == "bfloat16" else 0.0)
    assert np.asarray(want[3]).all()  # every query covered at this budget


def test_gather_truncation_matches(rng):
    """A budget far below the candidate counts (8x8 bands: ~90 random
    collisions per query): the same truncated selection, flags and n."""
    h, X, centers, js, ts = build_pair(rng, nb=8, r=8)
    Q = queries(rng, X, centers)
    qw = words_of(h, Q)
    got, want = _gather_pair(js, ts, qw, Q, max_out=6, mc=4)
    assert not np.asarray(want[3]).any()
    assert_no_near_ties(np.asarray(want[0]), np.asarray(want[1]))
    assert_same_ranking(got, want)


def test_gather_equals_full_when_exact(rng):
    h, X, centers, _, ts = build_pair(rng, nb=16, r=16, payload_dtype="int8")
    Q = queries(rng, X, centers)
    qw = words_of(h, Q)
    full = ts.query_topp_batch(qw, Q, 12, engine="full")
    gather = ts.query_topp_batch(qw, Q, 12, engine="gather", max_candidates=256)
    assert_no_near_ties(full[0], full[1])
    assert_same_ranking(gather, full)
    assert ts.stats()["rerank_truncations"] == 0


# ---------------------------------------------------------------------------
# the store's top-p entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("payload_dtype", PAYLOADS)
@pytest.mark.parametrize("engine", ["full", "gather"])
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
def test_query_topp_batch_matches(payload_dtype, engine, wire, rng):
    h, X, centers, js, ts = build_pair(rng, nb=16, r=16, payload_dtype=payload_dtype)
    Q = queries(rng, X, centers)
    qw = words_of(h, Q)
    want = js.query_topp_batch(qw, Q, 10, wire_dtype=wire, engine=engine, max_candidates=256)
    got = ts.query_topp_batch(qw, Q, 10, wire_dtype=wire, engine=engine, max_candidates=256)
    assert_no_near_ties(want[0], want[1])
    assert_same_ranking(got, want, rtol=1e-2 if wire == "bfloat16" else 0.0)
    with pytest.raises(ValueError, match="wire_dtype"):
        ts.query_topp_batch(qw, Q, 10, wire_dtype="float16")


def test_truncation_counter_matches(rng):
    h, X, centers, js, ts = build_pair(rng, nb=8, r=8)
    Q = queries(rng, X, centers)
    qw = words_of(h, Q)
    want = js.query_topp_batch(qw, Q, 6, engine="gather", max_candidates=4)
    got = ts.query_topp_batch(qw, Q, 6, engine="gather", max_candidates=4)
    assert_no_near_ties(want[0], want[1])
    assert_same_ranking(got, want)
    assert ts.stats()["rerank_truncations"] == js.stats()["rerank_truncations"] == len(Q)
    ts.query_topp_batch(qw, Q, 6, engine="full")  # the full engine never truncates
    assert ts.stats()["rerank_truncations"] == len(Q)


def test_single_query_topp_matches(rng):
    h, X, centers, js, ts = build_pair(rng, nb=16, r=16)
    Q = queries(rng, X, centers, q=6)
    for i in range(len(Q)):
        qw = words_of(h, Q[i : i + 1])
        want = js.query_topp(qw, Q[i], 9)
        got = ts.query_topp(qw, Q[i], 9)
        assert got[2] == want[2] and isinstance(got[2], int)
        assert_no_near_ties(want[0][None], want[1][None])
        assert_same_ranking([got[0][None], got[1][None], np.asarray([got[2]])],
                            [want[0][None], want[1][None], np.asarray([want[2]])])


@pytest.mark.parametrize("engine", ["full", "gather"])
@pytest.mark.parametrize("wire", ["words", "dense"])
def test_snapshot_topp_fn_matches_slices_and_goes_stale(engine, wire, rng):
    h, X, centers, js, ts = build_pair(rng, nb=16, r=16)
    Q = queries(rng, X, centers, q=10)
    sig = h.hash_batch_words_host(Q) if wire == "words" else h.hash_batch_dense_host(Q)
    want = [np.asarray(x) for x in js.snapshot_topp_fn(5, wire=wire, engine=engine)(sig, Q)]
    whole = ts.snapshot_topp_fn(5, wire=wire, engine=engine)(sig, Q)
    sliced = ts.snapshot_topp_fn(5, wire=wire, engine=engine, dev_batch=4)  # ragged: 4 + 4 + 2
    assert_no_near_ties(want[0], want[1])
    assert_same_ranking([x.numpy() for x in whole], want)
    assert_same_ranking([x.numpy() for x in sliced(sig, torch.from_numpy(Q))], want)
    ts.add_signature_batch([10**6], h.hash_batch_words_host(X[:1]), X[:1])
    with pytest.raises(RuntimeError, match="stale"):
        sliced(sig, Q)


def test_auto_slicing_has_no_floor():
    """The per-slice working set stays near 2 GB: where fewer than 128
    queries fit, the slice is smaller (the reference floors it at 128)."""
    store = TorchStore(num_bands=16, rows_per_band=16, dim=768, store_vectors=True,
                       initial_capacity=1 << 14, device="cpu")
    store._capacity = 1 << 20  # the sizing reads the capacity only
    assert store._topp_dev_batch("gather", 1024) == 256
    assert store._topp_dev_batch("full", 1024) == 256
    assert store._topp_dev_batch("gather", 1 << 14) == 17  # the reference says 128
    store._capacity = 1 << 28
    assert store._topp_dev_batch("full", 1024) == 1


def test_engine_resolution_matches_the_reference(rng):
    """The reference's resolution cases (tests/test_rerank_gather.py), then
    the same answer as the reference over a grid of stores and budgets."""
    _, _, _, js, ts = build_pair(rng, nb=4, r=8, n=2000, capacity=4096, deleted=0)
    for cap, mc, q in [(1 << 18, 64, 1024), (1 << 18, 1024, 1024), (1 << 20, 256, 1024),
                       (1 << 20, 256, 1 << 14), (1 << 12, 8, 1 << 20), (1 << 19, 4096, 64)]:
        for store in (js, ts):
            store._capacity = cap
        assert ts._resolve_rerank_engine("auto", mc, q=q) == js._resolve_rerank_engine(
            "auto", mc, q=q), (cap, mc, q)
    for store in (js, ts):
        store._capacity = 4096
    assert ts._resolve_rerank_engine(None, None)[0] == "full"
    ts._GATHER_MIN_CAPACITY = 1024
    ts._GATHER_CROSSOVER_SLOTS_PER_CANDIDATE = 2
    assert ts._resolve_rerank_engine("auto", 1024)[0] == "gather"
    ts._GATHER_CROSSOVER_SLOTS_PER_CANDIDATE = 10_000
    assert ts._resolve_rerank_engine("auto", 1024)[0] == "full"
    ts._GATHER_CROSSOVER_SLOTS_PER_CANDIDATE = 2
    assert ts._resolve_rerank_engine("auto", 4)[0] == "full"  # expected load > budget
    with pytest.raises(ValueError, match="engine"):
        ts._resolve_rerank_engine("approximate", None)
    with pytest.raises(ValueError, match="max_candidates"):
        ts._resolve_rerank_engine("full", 0)
    bare = TorchStore(num_bands=4, rows_per_band=8, chunk_size=128, initial_capacity=128,
                      device="cpu")
    with pytest.raises(RuntimeError, match="gather"):
        bare._resolve_rerank_engine("gather", 64)
    ts._FULL_RERANK_TEMP_BUDGET = 1  # the full engine cannot fit: gather
    assert ts._resolve_rerank_engine("auto", 4)[0] == "gather"
    bare._FULL_RERANK_TEMP_BUDGET = 1
    assert bare._resolve_rerank_engine("auto", 4)[0] == "full"


def test_topp_requires_a_payload_and_a_store(rng):
    store = TorchStore(num_bands=4, rows_per_band=8, dim=16, initial_capacity=128, device="cpu")
    qw = np.zeros((1, 4), np.uint32)
    with pytest.raises(RuntimeError, match="store_vectors=False"):
        store.query_topp_batch(qw, np.ones((1, 16), np.float32), 5)
    with pytest.raises(RuntimeError, match="store_vectors=False"):
        store.snapshot_topp_fn(5)
    paid = TorchStore(num_bands=4, rows_per_band=8, dim=16, store_vectors=True,
                      initial_capacity=128, device="cpu")
    ids, sims, n = paid.query_topp_batch(qw, np.ones((1, 16), np.float32), 5)
    assert (ids == -1).all() and (n == 0).all() and ids.shape == (1, 5)
    ids, sims, n = paid.query_topp(qw, np.ones(16, np.float32), 5)
    assert (ids == -1).all() and n == 0
    with pytest.raises(RuntimeError, match="non-empty"):
        paid.snapshot_topp_fn(5)
    with pytest.raises(ValueError, match="probes must be >= 1"):
        paid.snapshot_topp_fn(5, probes=0)
    with pytest.raises(ValueError, match="dim is required"):
        TorchStore(num_bands=4, rows_per_band=8, store_vectors=True, device="cpu")
