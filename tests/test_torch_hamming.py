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


def _spy(monkeypatch, name: str) -> list[int]:
    """The calls of ``lshrs_tpu_torch.ops.hamming.<name>`` as the Hamming
    cores make them: the first argument's row count, one entry a call."""
    calls, real = [], getattr(tham, name)

    def spy(first, *a, **kw):
        calls.append(first.shape[0])
        return real(first, *a, **kw)

    monkeypatch.setattr(tham, name, spy)
    return calls


def test_b2_slot_counters(rng, monkeypatch):
    """B2 scores the live prefix of the grouped bitplane path and skips
    the rest, once a query: the dead tail is skipped, a full store skips
    none, and ``LSHRS.serving_fn(mode="hamming")`` does the same."""
    from lshrs_tpu import LSHRS as JaxLSHRS
    from lshrs_tpu_torch import LSHRS as TorchLSHRS
    from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

    scored = _spy(monkeypatch, "hamming_group_max_keys")
    hasher = LSHHasher(num_bands=8, rows_per_band=8, dim=LIVE_KW["dim"], seed=5)
    ts = TorchStore(device="cpu", **LIVE_KW)
    _, X = _fill([ts], hasher, rng, 576)
    assert scored == []
    qw = hasher.hash_batch_words_host(X[:5])
    ts.query_hamming(qw, 4)
    ts.snapshot_query_fn(4, mode="hamming")(qw)
    assert ts._capacity == 576 + 448 and scored == [576, 576]
    ts.query_topk(qw, 4)  # collision ranking: B1, not B2
    assert scored == [576, 576]
    full = TorchStore(device="cpu", **LIVE_KW)
    _fill([full], hasher, rng, 1024)
    scored.clear()
    full.query_hamming(qw, 4)
    full.snapshot_query_fn(4, mode="hamming")(qw)
    assert full._capacity == 1024 and scored == [1024, 1024]

    kw = dict(dim=24, num_perm=64, num_bands=8, rows_per_band=8, hash_mode="host", seed=13,
              engine="hamming", initial_capacity=4096)
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    Y = rng.standard_normal((1500, 24)).astype(np.float32)
    jl.index(list(range(1500)), Y)
    tl.index(list(range(1500)), Y)
    scored.clear()
    got = tl.serving_fn(top_k=10, mode="hamming")(Y[:30])
    np.testing.assert_array_equal(got, np.asarray(jl.serving_fn(top_k=10, mode="hamming")(Y[:30])))
    assert tl.stats()["index"]["capacity"] == 4096 and scored == [1536]


# --- The fused refine + top-k (kernel hamming_refine_topk; its plain version here) ---


def _tail_case(rng, *, bw, word_bits, group, ng, q=9, tie_bits=None, dead=0.1):
    """Group maxima, query words and a store's columns for
    ``_select_refine``: ``ng`` groups of ``group`` slots of ``bw`` words
    of ``word_bits`` low bits, distinct ids (some -1 dead), global ties."""
    c = ng * group
    words = rng.integers(0, 1 << word_bits, (c, bw), dtype=np.uint64).astype(np.uint32)
    words[1::7] = words[::7][: len(words[1::7])]  # equal distances within groups
    ids = rng.permutation(10 * c)[:c].astype(np.int32)
    ids[rng.random(c) < dead] = -1
    tie = tscan.global_tie_core(torch.from_numpy(ids))
    if tie_bits is not None:  # ties of a block of a 2^tie_bits-slot store
        tie = torch.where(tie >= 0, tie + (1 << tie_bits) - tscan.key_scale(c), -1)
    qw = words[rng.integers(0, c, q)] ^ (rng.integers(0, 1 << word_bits, (q, bw), dtype=np.uint64)
                                         .astype(np.uint32) & 0x11111111)
    gmax = torch.from_numpy(rng.permutation(q * ng).reshape(q, ng).astype(np.int32))
    return dict(words=torch.from_numpy(words.view(np.int32)), ids=torch.from_numpy(ids),
                tie=tie, qwords=torch.from_numpy(qw.view(np.int32)), gmax=gmax)


def _table(case, *, group, narrow_r=0):
    words = case["words"]
    if narrow_r:
        words = t_pack_narrow(words, num_bands=words.shape[1], rows_per_band=narrow_r)
    ext = torch.cat([words, case["tie"][:, None], case["ids"][:, None]], dim=1)
    return tscan.build_grouped_refine_rows(ext, group=group)


def _oracle(case, top_groups, *, group, p, k):
    """The exact (hamming asc, id asc) top-k of the selected groups' alive
    slots, in NumPy."""
    words = case["words"].numpy().view(np.uint32)
    q_words = case["qwords"].numpy().view(np.uint32)
    tie, ids = case["tie"].numpy(), case["ids"].numpy()
    out_h = np.full((len(q_words), k), p + 1)
    out_i = np.full((len(q_words), k), -1)
    for i, groups in enumerate(top_groups.numpy()):
        slots = (groups[:, None] * group + np.arange(group)).ravel()
        slots = slots[tie[slots] >= 0]
        dist = np.unpackbits((words[slots] ^ q_words[i]).view(np.uint8), axis=1).sum(1)
        order = np.lexsort((ids[slots], dist))[:k]
        out_h[i, : order.size] = dist[order]
        out_i[i, : order.size] = ids[slots][order]
    return out_h, out_i


REFINE_ROUTES = {
    # name: (bw, word_bits, narrow_r, group, ng, k, m_groups, tie_bits, table, route)
    "narrow_r16": (16, 16, 16, 64, 40, 10, None, None, True, "kernel"),
    "word_aligned": (8, 32, 0, 16, 40, 10, None, None, True, "kernel"),
    "wide_keys": (16, 16, 16, 64, 40, 10, None, 23, True, "kernel"),
    "k_past_the_groups": (8, 32, 0, 16, 4, 100, None, None, True, "kernel"),
    "pool_at_8192": (4, 32, 0, 64, 160, 10, 128, None, True, "kernel"),
    "no_table": (16, 16, 16, 64, 40, 10, None, None, False, "plain"),
    "k_past_128": (8, 32, 0, 16, 40, 129, None, None, True, "plain"),
    "pool_past_8192": (4, 32, 0, 64, 160, 10, 129, None, True, "plain"),
    "group_8": (8, 32, 0, 8, 40, 10, None, None, True, "plain"),
    "nw_past_64": (65, 32, 0, 16, 8, 10, None, None, True, "plain"),
}


@pytest.mark.parametrize("name", sorted(REFINE_ROUTES))
def test_select_refine_takes_the_fused_kernel_within_its_limits(name, rng, monkeypatch):
    """``_select_refine`` hands a grouped table within the kernel's limits
    to ``hamming_refine_topk`` (one call, no ``lshrs.topk``) and everything
    else to the plain tail (no call of the kernel's wrapper); both give the
    exact (hamming asc, id asc) top-k of the selected groups, and the same
    answer as the plain tail forced."""
    bw, word_bits, narrow_r, group, ng, k, m_groups, tie_bits, table, route = REFINE_ROUTES[name]
    case = _tail_case(rng, bw=bw, word_bits=word_bits, group=group, ng=ng, tie_bits=tie_bits)
    p = bw * word_bits
    rows = _table(case, group=group, narrow_r=narrow_r) if table else None
    calls = []
    real = tham.hamming_refine_topk
    monkeypatch.setattr(tham, "hamming_refine_topk",
                        lambda *a, **kw: calls.append(kw) or real(*a, **kw))
    kw = dict(p=p, k=k, group=group, narrow_r=narrow_r, sig_t=case["words"].T.contiguous(),
              tie=case["tie"], ids=case["ids"], m_groups=m_groups,
              capacity=None if tie_bits is None else 1 << tie_bits, wide_ok=tie_bits is not None)
    got = tham._select_refine(case["gmax"], case["qwords"], rows, **kw)
    assert len(calls) == (route == "kernel")
    m = tham.hamming_select_terms(ng, group, p=p, k=k, m_groups=m_groups,
                                  capacity=kw["capacity"], wide_ok=kw["wide_ok"])[0]
    want_h, want_i = _oracle(case, tscan.select_top_groups(case["gmax"], m), group=group, p=p, k=k)
    np.testing.assert_array_equal(got[1].numpy(), want_i)
    np.testing.assert_array_equal(got[0].numpy(), want_h)
    monkeypatch.setattr(tham, "refine_kernel_fits", lambda **_: False)
    plain = tham._select_refine(case["gmax"], case["qwords"], rows, **kw)
    assert len(calls) == (route == "kernel")  # the plain tail: no new call
    assert torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1])


@pytest.mark.parametrize("narrow_r,wide", [(16, False), (0, False), (16, True)])
def test_fused_plain_version_equals_the_three_stage_tail(narrow_r, wide, rng):
    """``hamming_refine_topk`` on the CPU (its ``_ref``) equals
    ``hamming_refine_gather`` -> ``refine_hamming`` -> ``hamming_final_topk``
    on random stores, narrow and word-aligned, int32 and int64 keys."""
    bw, word_bits, group, ng = (16, 16, 64, 48) if narrow_r else (8, 32, 32, 48)
    for seed in range(3):
        case = _tail_case(np.random.default_rng(seed), bw=bw, word_bits=word_bits, group=group,
                          ng=ng, q=20, tie_bits=23 if wide else None, dead=0.3)
        rows = _table(case, group=group, narrow_r=narrow_r)
        top = tscan.select_top_groups(case["gmax"], 10)
        p = bw * word_bits
        scale = 1 << 23 if wide else tscan.key_scale(ng * group)
        cwords, cand_tie, cand_ids, qcmp = tham.hamming_refine_gather(
            case["qwords"], rows, top, group=group, narrow_r=narrow_r)
        want = tham.hamming_final_topk(tham.refine_hamming(cwords, qcmp), cand_tie, cand_ids,
                                       p=p, k=10, scale=scale, wide=wide)
        got = tham.hamming_refine_topk(tham.refine_query_words(case["qwords"], narrow_r), rows,
                                       top, group=group, p=p, k=10, scale=scale)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        got = tham.hamming_refine_topk(case["qwords"], rows, top, group=group, p=p, k=10,
                                       scale=scale, narrow_r=narrow_r)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert tham.hamming_refine_topk.launches == 0  # the CPU launches nothing


def _refuses(rng):
    case = _tail_case(rng, bw=8, word_bits=32, group=16, ng=16, q=4)
    rows = _table(case, group=16)
    top = tscan.select_top_groups(case["gmax"], 5)
    kw = dict(group=16, p=256, k=10, scale=1 << 8)
    q = case["qwords"]
    return {
        "qcmp_int64": ((q.long(), rows, top), kw, TypeError),
        "top_groups_int32": ((q, rows, top.int()), kw, TypeError),
        "rows_int64": ((q, rows.long(), top), kw, TypeError),
        "rows_width": ((q, rows[:, :-16], top), kw, ValueError),
        "top_groups_rows": ((q, rows, top[:2]), kw, ValueError),
        "k_0": ((q, rows, top), {**kw, "k": 0}, ValueError),
        "k_129": ((q, rows, top), {**kw, "k": 129}, ValueError),
        "group_8": ((q, rows.reshape(-1, 80), top), {**kw, "group": 8}, ValueError),
        "nw_65": ((torch.zeros((4, 65), dtype=torch.int32), torch.zeros((16, 67 * 16),
                   dtype=torch.int32), top), kw, ValueError),
        "pool_8208": ((q, rows, torch.zeros((4, 513), dtype=torch.int64)), kw, ValueError),
        "p_0": ((q, rows, top), {**kw, "p": 0}, ValueError),
        "scale_not_a_power_of_two": ((q, rows, top), {**kw, "scale": 384}, ValueError),
    }


@pytest.mark.parametrize("name", ["qcmp_int64", "top_groups_int32", "rows_int64", "rows_width",
                                  "top_groups_rows", "k_0", "k_129", "group_8", "nw_65",
                                  "pool_8208", "p_0", "scale_not_a_power_of_two"])
def test_fused_wrapper_refuses_what_the_kernel_does_not_take(name, rng):
    args, kw, err = _refuses(rng)[name]
    with pytest.raises(err):
        tham.hamming_refine_topk(*args, **kw)


def test_refine_route_counters_count_each_selection_tail(rng, monkeypatch):
    """One route a selection tail: the grouped table's queries take the
    kernel's wrapper, filtered queries the plain tail, a blocked store one
    tail a block, and a sharded store one a shard."""
    from lshrs_tpu_torch import LSHRS, IdFilter

    import lshrs_tpu_torch.storage.device as device_mod

    x = rng.standard_normal((3000, 16)).astype(np.float32)
    tails = _spy(monkeypatch, "select_top_groups")
    fused = _spy(monkeypatch, "hamming_refine_topk")

    def counts():
        """(kernel, plain) selection tails since the last call: the
        wrapper's calls, and the other group selections."""
        kernel, plain = len(fused), len(tails) - len(fused)
        tails.clear()
        fused.clear()
        return kernel, plain

    def index(**kw):
        lsh = LSHRS(dim=16, num_perm=64, num_bands=8, rows_per_band=8, engine="hamming",
                    initial_capacity=1024, device="cpu", **kw)
        lsh.index(np.arange(3000), x)
        return lsh

    lsh = index()
    assert counts() == (0, 0)
    serve = lsh.serving_fn(top_k=5)
    serve(x[:20])
    serve(x[20:40])
    assert counts() == (2, 0)
    lsh._storage.query_hamming(lsh._hasher.hash_batch_words(x[:20]), 5,
                               where=IdFilter(allowed_ids=np.arange(0, 3000, 2)))
    assert counts() == (0, 1)
    lsh._storage.query_hamming(lsh._hasher.hash_batch_words(x[:20]), 200)  # k past 128
    assert counts() == (0, 1)

    with monkeypatch.context() as mp:
        mp.setattr(device_mod, "hamming_block_slots", lambda p: 1024)
        blocked = index()
        blocked.serving_fn(top_k=5)(x[:20])
    assert counts() == (3, 0)  # 3,000 slots in three 1,024-slot blocks

    sharded = index(shards=2)
    sharded.serving_fn(top_k=5)(x[:20])
    assert counts() == (2, 0)
