"""Exact Hamming top-k on the packed words past one launch's int32 key
ceiling, in blocks of kernel B3.

A ``hamming_storage="packed"`` store of more than ``hamming_block_slots(P)``
slots (2^22 at 256 bits) ranks on its stored words block by block
(``hamming_topk_blocked_core`` with ``planes=None``): B3 on the view
``sig_t[:, s:e]`` of each block's live slots, the selection and the
refine, then one merge by ``(hamming asc, id asc)``. Here the block size
is patched down so that a CPU-sized store holds three or more blocks, the
last partly live, and the answers are held to the float64 reference of the
benchmark (`perfbench/reference/lsh.py`) and to a planes store on the same
words, bit for bit. B3's wrapper reads a strided block in place; its
layout check (``packed_words_stride``) is held here on CPU tensors, and
``stats()["device_bytes"]`` to the bytes of the store's tensors, and
``device_budget_bytes`` to the budget it sets.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import lshrs_tpu_torch.storage.device as device_mod
from lshrs_tpu_torch import LSHRS, DeviceStore, IdFilter
from lshrs_tpu_torch.ops import group_max as gm
from lshrs_tpu_torch.ops import hamming as tham
from lshrs_tpu_torch.ops.scan import compute_chunk_ranks, global_tie_core
from perfbench.reference import lsh as reference

NB, R = 16, 16
P = NB * R
BLOCK, CHUNK = 1024, 512


@pytest.fixture
def rng() -> np.random.Generator:
    return np.random.default_rng(24680)


def _blocks(monkeypatch, block: int = BLOCK) -> None:
    monkeypatch.setattr(device_mod, "hamming_block_slots", lambda p: block)


def _spy(monkeypatch, name: str) -> list:
    """The calls of ``lshrs_tpu_torch.ops.hamming.<name>`` as the Hamming
    cores make them: ``(shape, row stride)`` of the first argument."""
    calls, real = [], getattr(tham, name)

    def spy(first, *a, **kw):
        calls.append((tuple(first.shape), first.stride(0)))
        return real(first, *a, **kw)

    monkeypatch.setattr(tham, name, spy)
    return calls


def _stores(rng, n: int, **kw) -> tuple[dict, np.ndarray, np.ndarray]:
    """A packed and a planes CPU store of the same ``n`` random 256-bit
    signatures under permuted ids; rows ``i`` and ``i + BLOCK`` share a
    signature for ``i < 40``, the later slot under the smaller id."""
    words = rng.integers(0, 1 << R, (n, NB), dtype=np.uint32)
    words[BLOCK : BLOCK + 40] = words[:40]
    ids = rng.permutation(20 * n).astype(np.int64)[:n]
    lo = np.minimum(ids[:40], ids[BLOCK : BLOCK + 40])
    hi = np.maximum(ids[:40], ids[BLOCK : BLOCK + 40])
    ids[:40], ids[BLOCK : BLOCK + 40] = hi, lo
    stores = {}
    for storage in ("packed", "planes"):
        stores[storage] = DeviceStore(
            num_bands=NB, rows_per_band=R, chunk_size=CHUNK, initial_capacity=1024,
            enable_hamming=True, hamming_storage=storage, device="cpu", **kw)
        stores[storage].add_signature_batch(ids, words)
    return stores, words, ids


def _queries(rng, words: np.ndarray, q: int) -> np.ndarray:
    """Stored signatures (the shared ones first: distance-0 ties across
    the first block boundary), some with a few bits flipped."""
    pick = np.concatenate([np.arange(8), rng.integers(0, len(words), q - 8)])
    flips = rng.integers(0, 1 << R, (q, NB), dtype=np.uint32) & 0x0101
    flips[:8] = 0
    return words[pick] ^ flips


def _same(a, b) -> None:
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("k", [10, 700])
def test_packed_blocks_equal_the_planes_store_bit_for_bit(k, filtered, rng, monkeypatch):
    """Three and a half blocks (the last partly live), with tombstones and
    an upsert, unfiltered and under ``where=``: the packed store's ids and
    distances == the planes store's on the same words; ``k=700`` is past
    the last block's live slots."""
    n = 3 * BLOCK + 300
    stores, words, ids = _stores(rng, n)
    upsert = ids[5 : 2 * BLOCK : 37]
    new_words = rng.integers(0, 1 << R, (len(upsert), NB), dtype=np.uint32)
    for s in stores.values():
        s.remove_indices(ids[::13].tolist())
        s.add_signature_batch(upsert, new_words)
    where = IdFilter(allowed_ids=ids[(np.arange(n) % 3) != 1]) if filtered else None
    qw = _queries(rng, words, 24)
    _blocks(monkeypatch)
    got = {name: s.query_hamming(qw, k, where=where) for name, s in stores.items()}
    _same(got["packed"], got["planes"])
    assert stores["packed"]._capacity == 4096 and stores["packed"]._block_tie[0] == BLOCK


def test_equal_distances_across_a_block_boundary_go_to_the_smaller_id(rng, monkeypatch):
    """A signature stored at slot i < 40 and at slot i + BLOCK (the later
    slot under the smaller id): both rank at distance 0 on the packed
    words, the smaller id first, though its block comes second."""
    stores, words, ids = _stores(rng, 2 * BLOCK + 100)
    _blocks(monkeypatch)
    hamming, got = stores["packed"].query_hamming(words[:8], 3)
    assert (hamming[:, :2] == 0).all()
    np.testing.assert_array_equal(got[:, 0], ids[BLOCK : BLOCK + 8])
    np.testing.assert_array_equal(got[:, 1], ids[:8])


@pytest.mark.parametrize("filtered", [False, True])
def test_b3_scores_each_live_block_in_place_and_b2_never_runs(filtered, rng, monkeypatch):
    """One B3 call a live block, on the view of the store's words (rows the
    capacity apart, the last block cut to the live prefix), no B2 call, no
    bitplanes, no chunk ranks; one block at the real block size, over the
    live prefix, with the same answers."""
    n = 3 * BLOCK + 300
    stores, words, ids = _stores(rng, n)
    store = stores["packed"]
    where = IdFilter(allowed_ids=ids[::3]) if filtered else None
    qw = _queries(rng, words, 8)
    b3 = _spy(monkeypatch, "hamming_packed_group_max_keys")
    b2 = _spy(monkeypatch, "hamming_group_max_keys")
    one = store.query_hamming(qw, 5, where=where)
    live, cap = store._live_slots(), store._capacity
    assert live == n + (-n % 64) and cap == 4096
    assert b3 == [((NB, live), cap)] and store._block_tie is None
    _blocks(monkeypatch)
    b3.clear()
    blocked = store.query_hamming(qw, 5, where=where)
    assert b3 == [((NB, BLOCK), cap)] * 3 + [((NB, live - 3 * BLOCK), cap)]
    assert b2 == [] and store._planes is None and store._ranks is None
    _same(one, blocked)


def test_blocked_packed_route_matches_the_float64_reference(monkeypatch):
    """``LSHRS(engine="hamming", hamming_storage="packed")`` over seeded
    unit vectors, three blocks of 1,024 slots (the last 448 live): the
    served ids == the benchmark's float64 reference's, and the store's
    distances == the reference's bits' distances to those ids."""
    from perfbench.data import clustered

    n, q, dim = 2500, 64, 24
    x = clustered(20_260_026, n + q, dim, centers=64, noise=0.35, device="cpu").numpy()
    train, test = x[:n], x[n:]
    test[:4] = train[[3, BLOCK + 3, 2 * BLOCK + 3, 7]]
    index = dict(dim=dim, num_perm=P, num_bands=NB, rows_per_band=R, engine="hamming",
                 hash_mode="device", hash_family="gaussian", seed=42)
    lsh = LSHRS(**index, hamming_storage="packed", initial_capacity=1024, device="cpu")
    lsh.index(np.arange(n), train)
    _blocks(monkeypatch)
    b3 = _spy(monkeypatch, "hamming_packed_group_max_keys")
    served = lsh.serving_fn(top_k=10)(test)
    store = lsh._storage
    assert store._capacity == 4096 and -(-store._live_slots() // BLOCK) == 3
    assert [shape[1] for shape, _ in b3] == [BLOCK, BLOCK, store._live_slots() - 2 * BLOCK]
    truth = reference.answers(index, train, test, ranking="hamming", k=10,
                              precision="float64", device="cpu")
    np.testing.assert_array_equal(served, truth)
    planes = torch.from_numpy(reference.hyperplanes(42, P, dim))
    dbits = reference.sign_bits(torch.from_numpy(train), planes, precision="float64")
    qbits = reference.sign_bits(torch.from_numpy(test), planes, precision="float64")
    want = (dbits[torch.from_numpy(truth).long()] != qbits[:, None, :]).sum(-1).numpy()
    words = lsh._hash_wire(lsh._augment_query(lsh._validate_batch(test)), 1)
    hamming, ids = store.query_hamming(words, 10)
    np.testing.assert_array_equal(ids, truth)
    np.testing.assert_array_equal(hamming, want)
    assert store._planes is None


def test_the_blocked_core_on_words_equals_it_on_planes(rng):
    """The core itself: ``planes=None`` on the words == the planes on the
    same words, block by block and merged."""
    c, q = 4096, 6
    words = rng.integers(0, 1 << R, (c, NB), dtype=np.uint32)
    sig_rows = torch.from_numpy(words.view(np.int32))
    sig_t = sig_rows.T.contiguous()
    ids = torch.from_numpy(rng.permutation(10 * c)[:c].astype(np.int32))
    ids[::17] = -1
    live = 3000 + (-3000 % 64)
    ids[live:] = -1
    block_tie = torch.where(
        ids >= 0, gm.key_scale(BLOCK) - 1 - compute_chunk_ranks(ids, chunk=BLOCK), -1
    ).to(torch.int32)
    qw = torch.from_numpy(words[rng.integers(0, live, q)].view(np.int32))
    planes = tham.unpack_bitplanes(sig_rows, num_bands=NB, rows_per_band=R)
    qbits = tham.unpack_bitplanes(qw, num_bands=NB, rows_per_band=R)
    kw = dict(k=7, group=64, block=BLOCK, live=live, num_perm=P, sig_t=sig_t, ids=ids)
    want = tham.hamming_topk_blocked_core(planes, block_tie, qbits, qw, None, **kw)
    got = tham.hamming_topk_blocked_core(None, block_tie, None, qw, None, word_bits=R, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="sig_t and num_perm"):
        tham.hamming_topk_blocked_core(None, block_tie, None, qw, None,
                                       **{**kw, "sig_t": None})


@pytest.mark.parametrize("bw,word_bits,start,width,ld", [
    (16, 16, 0, 1024, 4096),      # the first block of a wider store
    (16, 16, 2048, 960, 4096),    # a later block's live prefix
    (8, 32, 1024, 1024, 2048),    # full words
    (1, 16, 512, 256, 1024),      # one word: the row stride does not matter
])
def test_b3_on_a_strided_view_equals_the_contiguous_copy(bw, word_bits, start, width, ld, rng):
    """B3's wrapper on the view ``words[:, s:s+L]`` of a ``(BW, ld)`` array
    == its plain version on the contiguous copy; the view passes the
    layout check the card makes, with its row stride."""
    mask = (1 << word_bits) - 1
    big = torch.from_numpy(
        (rng.integers(0, 1 << 32, (bw, ld), dtype=np.uint64) & mask).astype(np.uint32)
        .view(np.int32))
    view = big[:, start : start + width]
    assert view.is_contiguous() == (bw == 1)
    ids = torch.from_numpy(rng.permutation(4 * width)[:width].astype(np.int32))
    ids[::11] = -1
    tie = global_tie_core(ids)
    qw = view[:, rng.integers(0, width, 9)].T.contiguous()
    kw = dict(num_perm=bw * word_bits, group=64, scale=gm.key_scale(ld), word_bits=word_bits)
    got = gm.hamming_packed_group_max_keys(view, tie, qw, **kw)
    want = gm.hamming_packed_group_max_keys_ref(view.contiguous(), tie, qw, **kw)
    assert torch.equal(got, want)
    assert gm.packed_words_stride(view) == (ld if bw > 1 else width)


@pytest.mark.parametrize("case", ["slots_strided", "rows_major", "misaligned_base",
                                  "row_stride_off_16_bytes"])
def test_the_layout_check_refuses_what_b3_cannot_read(case):
    """Slots not contiguous, the row-major twin's transpose, a base off 16
    bytes and a row stride off 16 bytes are refused; a contiguous array
    and a block of it are not."""
    big = torch.zeros((16, 4096), dtype=torch.int32)
    assert gm.packed_words_stride(big) == 4096
    assert gm.packed_words_stride(big[:, 1024:2048]) == 4096
    bad = {
        "slots_strided": big[:, ::2],
        "rows_major": torch.zeros((4096, 16), dtype=torch.int32).T,
        "misaligned_base": big[:, 1:1025],
        "row_stride_off_16_bytes": torch.zeros((16, 4098), dtype=torch.int32)[:, :4096],
    }[case]
    match = "aligned" if case in ("misaligned_base", "row_stride_off_16_bytes") else "contiguous"
    with pytest.raises(ValueError, match=match):
        gm.packed_words_stride(bad)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@pytest.mark.parametrize("storage", ["packed", "planes"])
def test_device_bytes_sum_the_store_tensors(storage, rng, monkeypatch):
    """``stats()["device_bytes"]`` == the bytes of the words, the row twin,
    the ids and the ties; then also of the refine table, the block ties
    and (planes) the bitplanes, once a blocked query has built them."""
    stores, words, _ = _stores(rng, 2 * BLOCK + 100)
    s = stores[storage]
    base = (s._sig_t, s._sig_rows, s._ids, s._tie)
    assert s.stats()["device_bytes"] == _nbytes(*base) == s._capacity * (4 * 2 * NB + 8)
    _blocks(monkeypatch)
    s.query_hamming(words[:4], 5)
    lazy = [s._refine, s._block_tie[1]] + ([s._planes] if storage == "planes" else [])
    assert all(t is not None for t in lazy) and (s._planes is None) == (storage == "packed")
    assert s.stats()["device_bytes"] == _nbytes(*base, *lazy)
    s.remove_indices([int(s._ids[0])])  # drops the lazy tables but the planes
    kept = [s._planes] if storage == "planes" else []
    assert s.stats()["device_bytes"] == _nbytes(*base, *kept)


def test_a_sharded_store_counts_the_bytes_of_its_shards(rng):
    """A sharded store holds no tensor itself: its ``device_bytes`` is the
    sum of its shards'."""
    from lshrs_tpu_torch.parallel import ShardedDeviceStore, make_mesh

    kw = dict(num_bands=NB, rows_per_band=R, chunk_size=CHUNK, initial_capacity=2048,
              enable_hamming=True, hamming_storage="packed")
    st = ShardedDeviceStore(mesh=make_mesh(devices=["cpu"] * 2), **kw)
    words = rng.integers(0, 1 << R, (1500, NB), dtype=np.uint32)
    st.add_signature_batch(np.arange(1500), words)
    st.query_hamming(words[:3], 4)
    shards = [sh.stats()["device_bytes"] for sh in st._shards]
    assert st.stats()["device_bytes"] == sum(shards) > 0 and st._sig_t is None



@pytest.mark.parametrize("storage", ["packed", "planes"])
def test_a_store_within_its_budget_answers_as_one_without(storage, rng, monkeypatch):
    """A budget equal to what the blocked store comes to hold changes
    nothing: the same answers, the same bytes, the lazy tables kept."""
    _blocks(monkeypatch)
    free, words, _ = _stores(rng, 2 * BLOCK + 100)
    q = _queries(rng, words, 24)
    want = free[storage].query_hamming(q, 10)
    held = free[storage].stats()["device_bytes"]
    capped, _, _ = _stores(np.random.default_rng(24680), 2 * BLOCK + 100,
                           device_budget_bytes=held)
    _same(capped[storage].query_hamming(q, 10), want)
    assert capped[storage].stats()["device_bytes"] == held
    assert capped[storage]._refine is not None and capped[storage]._block_tie is not None


@pytest.mark.parametrize("storage,lazy", [("packed", "_block_tie"), ("planes", "_planes")])
def test_a_lazy_table_past_the_budget_raises_and_is_dropped(storage, lazy, rng, monkeypatch):
    """One byte short of the blocked store's whole holding: the query that
    would build its last lazy table raises, the store keeps holding no
    more than the budget, and the next query raises again."""
    _blocks(monkeypatch)
    free, words, _ = _stores(rng, 2 * BLOCK + 100)
    free[storage].query_hamming(words[:4], 5)
    held = free[storage].stats()["device_bytes"]
    capped, _, _ = _stores(np.random.default_rng(24680), 2 * BLOCK + 100,
                           device_budget_bytes=held - 1)
    s = capped[storage]
    for _ in range(2):
        with pytest.raises(MemoryError, match="device_budget_bytes"):
            s.query_hamming(words[:4], 5)
        assert s.stats()["device_bytes"] <= held - 1
    assert getattr(s, lazy) is None


def test_a_growth_past_the_budget_raises_before_writing(rng):
    """The growth an append needs, past the budget: the append raises and
    the store keeps its capacity and contents."""
    words = rng.integers(0, 1 << R, (3000, NB), dtype=np.uint32)
    s = DeviceStore(num_bands=NB, rows_per_band=R, chunk_size=CHUNK, initial_capacity=2048,
                    enable_hamming=True, hamming_storage="packed", device="cpu",
                    device_budget_bytes=2048 * (8 * NB + 8) + 1)
    s.add_signature_batch(np.arange(1000), words[:1000])
    before = s.stats()["device_bytes"]
    with pytest.raises(MemoryError, match="device_budget_bytes"):
        s.add_signature_batch(np.arange(1000, 3000), words[1000:])
    assert (s._capacity, len(s), s.stats()["device_bytes"]) == (2048, 1000, before)


@pytest.mark.parametrize("case", ["zero", "sharded", "memory_backend", "own_storage"])
def test_a_budget_is_refused_where_it_cannot_hold(case):
    """A budget must be positive, and it binds one unsharded device store:
    a sharded store, another backend, or a store given whole are refused."""
    kw = dict(dim=16, num_perm=P, num_bands=NB, rows_per_band=R, device="cpu")
    with pytest.raises(ValueError, match="device_budget_bytes"):
        if case == "zero":
            DeviceStore(num_bands=NB, rows_per_band=R, device="cpu", device_budget_bytes=0)
        elif case == "sharded":
            LSHRS(**kw, shards=2, device_budget_bytes=1 << 30)
        elif case == "memory_backend":
            LSHRS(**kw, backend="memory", device_budget_bytes=1 << 30)
        else:
            store = DeviceStore(num_bands=NB, rows_per_band=R, device="cpu")
            LSHRS(**kw, storage=store, device_budget_bytes=1 << 30)
