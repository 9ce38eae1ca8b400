"""Grouped Hamming top-k: the port's core against the JAX package."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import hamming as jham
from lshrs_tpu.ops import scan as jscan
from lshrs_tpu.ops.bitpack import narrow_refine_r
from lshrs_tpu.ops.bitpack import pack_words_narrow as j_pack_narrow
from lshrs_tpu_torch.ops import hamming as tham
from lshrs_tpu_torch.ops import scan as tscan
from lshrs_tpu_torch.ops.bitpack import pack_words_narrow as t_pack_narrow
from lshrs_tpu_torch.ops.bitpack import popcount31

C, Q, GROUP, CHUNK = 1024, 12, 64, 256


def _case(rng, num_bands, rows, dim=16, n=700):
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=dim, seed=7)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    sig_rows = np.zeros((C, words.shape[1]), np.uint32)
    sig_rows[:n] = words
    ids = np.full(C, -1, np.int32)
    ids[:n] = rng.permutation(50_000)[:n]
    ids[:n][rng.random(n) < 0.1] = -1
    qx = X[rng.integers(0, n, Q)] + 0.3 * rng.standard_normal((Q, dim)).astype(np.float32)
    return sig_rows, ids, h.hash_batch_words_host(qx)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("num_bands,rows,k,narrow", [
    (4, 16, 10, False), (4, 16, 10, True), (8, 8, 3, True), (2, 40, 10, False),
    (4, 16, 1100, True),  # k past the candidate pool: padded
])
def test_hamming_core_matches_jax(num_bands, rows, k, narrow, use_pallas, rng):
    narrow_r = narrow_refine_r(rows) if narrow else 0
    assert bool(narrow_r) == narrow
    sig_rows, ids, qwords = _case(rng, num_bands, rows)
    kw = dict(num_bands=num_bands, rows_per_band=rows)

    planes_j = jham.unpack_bitplanes(jnp.asarray(sig_rows), **kw)
    qbits_j = jham.unpack_bitplanes(jnp.asarray(qwords), **kw)
    tie_j = jscan.compute_global_tie(jnp.asarray(ids))
    words_j = jnp.asarray(sig_rows)
    if narrow_r:
        words_j = j_pack_narrow(words_j, num_bands=num_bands, rows_per_band=narrow_r)
    ext_j = jnp.concatenate([
        words_j,
        jax.lax.bitcast_convert_type(tie_j, jnp.uint32)[:, None],
        jax.lax.bitcast_convert_type(jnp.asarray(ids), jnp.uint32)[:, None],
    ], axis=1)
    j_ham, j_ids = jham.hamming_topk(
        planes_j, jnp.asarray(np.ascontiguousarray(sig_rows.T)), jnp.asarray(ids), tie_j,
        qbits_j, jnp.asarray(qwords),
        k=k, chunk=CHUNK, group=GROUP, use_pallas=use_pallas, q_tile=8,
        interpret=use_pallas,
        sig_rows=jscan.build_grouped_refine_rows(
            ext_j, group=GROUP, strided_chunk=CHUNK if use_pallas else None
        ),
        narrow_r=narrow_r,
    )

    words_t = torch.from_numpy(sig_rows.view(np.int32).copy())
    planes_t = tham.unpack_bitplanes(words_t, **kw)
    np.testing.assert_array_equal(planes_t.numpy(), np.asarray(planes_j))
    qw_t = torch.from_numpy(qwords.view(np.int32).copy())
    qbits_t = tham.unpack_bitplanes(qw_t, **kw)
    tie_t = tscan.global_tie_core(torch.from_numpy(ids))
    if narrow_r:
        words_t = t_pack_narrow(words_t, num_bands=num_bands, rows_per_band=narrow_r)
    ext_t = torch.cat([words_t, tie_t[:, None], torch.from_numpy(ids)[:, None]], dim=1)
    t_ham, t_ids = tham.hamming_topk_core(
        planes_t, tie_t, qbits_t, qw_t, tscan.build_grouped_refine_rows(ext_t, group=GROUP),
        k=k, group=GROUP, narrow_r=narrow_r,
    )
    np.testing.assert_array_equal(t_ham.numpy(), np.asarray(j_ham))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert (t_ids.numpy()[:, 0] >= 0).all()


def test_popcount32_matches_numpy(rng):
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
    want = np.unpackbits(x.view(np.uint8)).reshape(-1, 32).sum(1)
    got = tham.popcount32(torch.from_numpy(x.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_popcount31_matches_numpy_below_bit_31(rng):
    """The int32 popcount of kernel B3's plain version (words masked below
    32 bits, so non-negative)."""
    x = rng.integers(0, 2**31, 4096, dtype=np.int64).astype(np.int32)
    x[:4] = [0, 1, 0x40000000, 0x7FFFFFFF]
    want = np.unpackbits(x.view(np.uint8)).reshape(-1, 32).sum(1)
    got = popcount31(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("capacity", [1 << 10, 1 << 20, 1 << 22, 1 << 23])
@pytest.mark.parametrize("num_perm", [64, 256])
def test_supports_hamming_grouped_matches(num_perm, capacity):
    assert tham.supports_hamming_grouped(num_perm, capacity) == jham.supports_hamming_grouped(
        num_perm, capacity
    )


# -- signatures whose width is not a multiple of 32 (padded bitplanes) -------


def _strided_rows(a: np.ndarray, chunk: int, group: int) -> np.ndarray:
    """Permute axis 0 so the Pallas kernel's strided group g holds the
    port's contiguous group g (as in ``tests/test_torch_group_max.py``)."""
    s = np.arange(a.shape[0])
    g, i = s // group, s % group
    ngc = chunk // group
    out = np.empty_like(a)
    out[(g // ngc) * chunk + (g % ngc) + i * ngc] = a
    return out


@pytest.mark.parametrize("asymmetric", [False, True])
@pytest.mark.parametrize("p", [30, 120, 256])
def test_padded_plain_b2_matches_pallas(p, asymmetric, rng):
    """The plain B2 on operands zero-padded to ``plane_width(p)`` columns,
    told the true width, equals the Pallas kernel on the unpadded ones."""
    from lshrs_tpu.ops import asymmetric as jasym
    from lshrs_tpu.ops import pallas_scan as jps
    from lshrs_tpu_torch.ops import group_max as gm

    planes = (2 * rng.integers(0, 2, (C, p)) - 1).astype(np.int8)
    ids = rng.permutation(C).astype(np.int32)
    ids[rng.random(C) < 0.1] = -1
    tie = np.array(jscan.compute_global_tie(jnp.asarray(ids)))
    if asymmetric:
        qbits = rng.integers(-127, 128, (Q, p)).astype(np.int8)
        kw = dict(offset=p * jasym.QMAX, shift=gm.asymmetric_shift(p, C))
    else:
        qbits = planes[rng.integers(0, C, Q)].copy()
        qbits[Q // 2 :] *= np.where(rng.random((Q - Q // 2, p)) < 0.2, -1, 1).astype(np.int8)
        kw = {}
    kw.update(group=GROUP, scale=gm.key_scale(C))
    width = tham.plane_width(p)
    assert width % 32 == 0 and width - p < 32
    pad = ((0, 0), (0, width - p))
    got = gm.hamming_group_max_keys(
        torch.from_numpy(np.pad(planes, pad)), torch.from_numpy(tie),
        torch.from_numpy(np.pad(qbits, pad)), num_perm=p, **kw,
    ).numpy()
    want = np.asarray(jps.hamming_group_max_keys(
        jnp.asarray(_strided_rows(planes, CHUNK, GROUP)),
        jnp.asarray(_strided_rows(tie, CHUNK, GROUP)),
        jnp.asarray(qbits), chunk=CHUNK, q_tile=4, interpret=True, **kw,
    ))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_bands,rows", [(10, 3), (20, 6), (16, 16)])
def test_hamming_lshrs_at_any_width_matches_reference(num_bands, rows, rng):
    """``LSHRS(engine="hamming")`` at 30, 120 and 256 bits: the port's
    padded bitplanes give the reference's ids and distances."""
    from lshrs_tpu import LSHRS as JaxLSHRS
    from lshrs_tpu_torch import LSHRS as TorchLSHRS

    p = num_bands * rows
    kw = dict(dim=24, num_perm=p, num_bands=num_bands, rows_per_band=rows,
              hash_mode="host", seed=13, engine="hamming")
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    X = rng.standard_normal((700, 24)).astype(np.float32)
    jl.index(list(range(700)), X)
    tl.index(list(range(700)), X)
    Qx = X[:40] + 0.3 * rng.standard_normal((40, 24)).astype(np.float32)
    qwords = jl._hasher.hash_batch_words_host(Qx)
    j_ham, j_ids = jl._storage.query_hamming(qwords, 10)
    t_ham, t_ids = tl._storage.query_hamming(qwords, 10)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_ham, j_ham)
    np.testing.assert_array_equal(tl.serving_fn(top_k=10)(Qx), np.asarray(jl.serving_fn(top_k=10)(Qx)))
    assert tl.query_hamming_batch(Qx, top_k=5) == jl.query_hamming_batch(Qx, top_k=5)
    store = tl._storage
    assert store._planes.shape == (store._capacity, tham.plane_width(p))
    assert not store._planes[:, p:].any()
    assert tl.stats()["index"]["hamming_plane_bytes"] == store._planes.numel()


def test_b2_num_perm_is_the_true_width(rng):
    """Zero columns change no dot; ``num_perm`` keeps the symmetric offset
    at the true width, and a width past the operands is refused."""
    from lshrs_tpu_torch.ops import group_max as gm

    planes = torch.from_numpy((2 * rng.integers(0, 2, (256, 30)) - 1).astype(np.int8))
    qbits = planes[:5].clone()
    tie = tscan.global_tie_core(torch.from_numpy(rng.permutation(256).astype(np.int32)))
    kw = dict(group=16, scale=gm.key_scale(256))
    padded = torch.nn.functional.pad(planes, (0, 2)), torch.nn.functional.pad(qbits, (0, 2))
    want = gm.hamming_group_max_keys(planes, tie, qbits, **kw)
    assert torch.equal(gm.hamming_group_max_keys(padded[0], tie, padded[1], num_perm=30, **kw), want)
    assert not torch.equal(gm.hamming_group_max_keys(padded[0], tie, padded[1], **kw), want)
    with pytest.raises(ValueError, match="num_perm"):
        gm.hamming_group_max_keys(planes, tie, qbits, num_perm=31, **kw)


# ---------------------------------------------------------------------------
# B2 over the store's live prefix: the same answers as the full-capacity launch
# ---------------------------------------------------------------------------

LIVE_KW = dict(num_bands=8, rows_per_band=8, dim=16, chunk_size=128, initial_capacity=1024,
               enable_hamming=True)


def _fill(stores, hasher, rng, n, base=0):
    X = rng.standard_normal((n, LIVE_KW["dim"])).astype(np.float32)
    ids = (base + rng.permutation(10 * n)[:n]).astype(np.int64)
    words = hasher.hash_batch_words_host(X)
    for store in stores:
        store.add_signature_batch(ids, words)
    return ids, X


def _live_state(name, stores, hasher, rng):
    """Fill the store pair into the named state: ``(vectors, filter spec, k)``."""
    from lshrs_tpu.storage import IdFilter as JaxFilter
    from lshrs_tpu_torch import IdFilter

    n = {"one_vector": 1, "under_a_group": 40, "one_group": 64, "capacity_less_one": 1023,
         "full": 1024, "past_growth": 1025, "k_past_live": 40}.get(name, 576)
    ids, X = _fill(stores, hasher, rng, 900 if name == "cleared" else n)
    where, k = None, 10
    if name in ("deleted", "compacted"):
        gone = np.concatenate([ids[-30:], ids[:500:7]])
        for store in stores:
            store.remove_indices(gone.tolist())
            if name == "compacted":
                store.compact()
    elif name == "cleared":
        for store in stores:
            store.clear()
        ids, X = _fill(stores, hasher, rng, 300, base=10**6)
    elif name == "filtered":
        spec = (ids[::3].tolist(), ids[:60:2].tolist())
        where = JaxFilter(*spec), IdFilter(*spec)
    elif name == "k_past_live":
        k = 200
    return X, where, k


LIVE_STATES = ["one_vector", "under_a_group", "one_group", "half", "capacity_less_one", "full",
               "past_growth", "deleted", "compacted", "cleared", "filtered", "k_past_live"]


@pytest.mark.parametrize("state", LIVE_STATES)
def test_b2_over_the_live_prefix_matches_the_full_launch(state, rng, monkeypatch):
    """The grouped bitplane path scores only the store's live prefix: its
    ids and distances equal the full-capacity launch's and the reference
    store's, bit for bit, in every fill state; B2's group maxima over the
    prefix are the full launch's first columns."""
    from lshrs_tpu.storage.device import DeviceStore as JaxStore
    from lshrs_tpu_torch.ops import group_max as gm
    from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

    hasher = LSHHasher(num_bands=8, rows_per_band=8, dim=LIVE_KW["dim"], seed=5)
    js, ts = JaxStore(**LIVE_KW), TorchStore(device="cpu", **LIVE_KW)
    X, where, k = _live_state(state, (js, ts), hasher, rng)
    jf, tf = where if where is not None else (None, None)
    qx = X[rng.integers(0, len(X), 24)] + 0.3 * rng.standard_normal((24, X.shape[1]))
    qx[0] = X[-1]
    qw = hasher.hash_batch_words_host(qx.astype(np.float32))

    cap, live = ts._capacity, ts._live_slots()
    assert live % ts._group() == 0 and ts._size <= live <= cap
    assert (live == cap) == (state in ("full", "capacity_less_one"))
    th, ti = ts.query_hamming(qw, k, where=tf)
    jh, ji = js.query_hamming(qw, k, where=jf)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(th, jh)
    served = ts.snapshot_query_fn(k, mode="hamming", where=tf)(qw).numpy()
    np.testing.assert_array_equal(served, np.asarray(js.snapshot_query_fn(k, mode="hamming", where=jf)(qw)))
    if state == "k_past_live":
        assert (ti[:, len(X):] == -1).all() and (th[:, len(X):] == 8 * 8 + 1).all()

    # The core on the store's own tensors, prefix against whole capacity.
    qwt = torch.from_numpy(qw.view(np.int32).copy())
    ids_x, tie_x = ts._filtered_ids_tie(tf)
    qbits = ts._planes_rows(qwt)
    rows = ts._refine_rows() if tf is None else None
    kw = dict(k=min(k, cap), group=ts._group(), narrow_r=ts._refine_narrow_r, num_perm=64,
              sig_t=ts._sig_t, ids=ids_x)
    for got, want in zip(
        tham.hamming_topk_core(ts._planes, tie_x, qbits, qwt, rows, live=live, **kw),
        tham.hamming_topk_core(ts._planes, tie_x, qbits, qwt, rows, **kw),
    ):
        assert torch.equal(got, want)
    b2 = dict(group=ts._group(), scale=gm.key_scale(cap), num_perm=64)
    full = gm.hamming_group_max_keys(ts._planes, tie_x, qbits, **b2)
    prefix = gm.hamming_group_max_keys(ts._planes[:live], tie_x[:live], qbits, **b2)
    assert torch.equal(prefix, full[:, : live // ts._group()])
    assert (full[:, live // ts._group():] <= 0).all()

    # The store with B2 launched over every slot, as before the prefix.
    monkeypatch.setattr(ts, "_live_slots", lambda: cap)
    np.testing.assert_array_equal(ts.query_hamming(qw, k, where=tf)[1], ti)
    np.testing.assert_array_equal(ts.query_hamming(qw, k, where=tf)[0], th)
    np.testing.assert_array_equal(ts.snapshot_query_fn(k, mode="hamming", where=tf)(qw).numpy(), served)


def test_hamming_core_refuses_a_live_extent_off_the_groups(rng):
    planes = torch.from_numpy((2 * rng.integers(0, 2, (256, 32)) - 1).astype(np.int8))
    tie = tscan.global_tie_core(torch.from_numpy(rng.permutation(256).astype(np.int32)))
    qw = torch.zeros((2, 1), dtype=torch.int32)
    for live in (0, 48, 320):
        with pytest.raises(ValueError, match="live"):
            tham.hamming_topk_core(planes, tie, planes[:2].clone(), qw, None, k=3, group=64,
                                   sig_t=qw.new_zeros((1, 256)), ids=tie, live=live)


def test_b2_slot_counters(rng):
    """``stats()`` counts the slots B2 scored and skipped per launch of the
    grouped bitplane path: the dead tail is skipped, a full store skips
    none, and ``LSHRS.serving_fn(mode="hamming")`` reports them too."""
    from lshrs_tpu import LSHRS as JaxLSHRS
    from lshrs_tpu_torch import LSHRS as TorchLSHRS
    from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

    hasher = LSHHasher(num_bands=8, rows_per_band=8, dim=LIVE_KW["dim"], seed=5)
    ts = TorchStore(device="cpu", **LIVE_KW)
    st = ts.stats()
    assert (st["b2_slots_scanned"], st["b2_slots_skipped"]) == (0, 0)
    _, X = _fill([ts], hasher, rng, 576)
    qw = hasher.hash_batch_words_host(X[:5])
    ts.query_hamming(qw, 4)
    ts.snapshot_query_fn(4, mode="hamming")(qw)
    st = ts.stats()
    assert (st["b2_slots_scanned"], st["b2_slots_skipped"]) == (2 * 576, 2 * 448)
    ts.query_topk(qw, 4)  # collision ranking: B1, not counted
    assert ts.stats()["b2_slots_scanned"] == 2 * 576
    full = TorchStore(device="cpu", **LIVE_KW)
    _fill([full], hasher, rng, 1024)
    full.query_hamming(qw, 4)
    full.snapshot_query_fn(4, mode="hamming")(qw)
    st = full.stats()
    assert (st["b2_slots_scanned"], st["b2_slots_skipped"]) == (2 * 1024, 0)

    kw = dict(dim=24, num_perm=64, num_bands=8, rows_per_band=8, hash_mode="host", seed=13,
              engine="hamming", initial_capacity=4096)
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    Y = rng.standard_normal((1500, 24)).astype(np.float32)
    jl.index(list(range(1500)), Y)
    tl.index(list(range(1500)), Y)
    got = tl.serving_fn(top_k=10, mode="hamming")(Y[:30])
    np.testing.assert_array_equal(got, np.asarray(jl.serving_fn(top_k=10, mode="hamming")(Y[:30])))
    st = tl.stats()["index"]
    assert (st["b2_slots_scanned"], st["b2_slots_skipped"]) == (1536, 4096 - 1536)
