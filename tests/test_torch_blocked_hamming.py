"""Exact Hamming top-k past one B2 launch's int32 key ceiling, in blocks.

A store of more than ``hamming_block_slots(P)`` slots (2^22 at 256 bits)
ranks on its bitplanes block by block (``hamming_topk_blocked_core``):
B2, the selection and the refine once per block of live slots, then one
merge by ``(hamming asc, id asc)``. Here the block size is patched down
so that a CPU-sized store holds three or more blocks, the last partly
live, and the answers are held to the float64 reference of the benchmark
(`perfbench/reference/lsh.py`) and to the chunked core on the same store,
bit for bit: equal distances across a block boundary, tombstones, an
upsert, a ``where=`` filter and ``k`` past a block's live slots. A store
that fits one block launches B2 once and merges nothing.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lshrs_tpu_torch.storage.device as device_mod
from lshrs_tpu_torch import LSHRS, DeviceStore, IdFilter
from lshrs_tpu_torch.ops import hamming as tham
from lshrs_tpu_torch.ops.scan import compute_chunk_ranks
from perfbench.reference import lsh as reference

NB, R = 16, 16
P = NB * R
BLOCK, CHUNK = 1024, 512


@pytest.fixture
def rng() -> np.random.Generator:
    """The suite's seed, here too: the card runs this file without the
    suite's ``conftest.py`` (it imports JAX)."""
    return np.random.default_rng(12345)


def _blocks(monkeypatch, block: int = BLOCK) -> None:
    monkeypatch.setattr(device_mod, "hamming_block_slots", lambda p: block)


def _chunked(monkeypatch) -> None:
    """Route the store to its chunked core: one block of any size, and the
    single launch refused."""
    monkeypatch.setattr(device_mod, "hamming_block_slots", lambda p: 1 << 40)
    monkeypatch.setattr(device_mod, "supports_hamming_grouped", lambda *a: False)


def _spy(monkeypatch, name: str) -> list:
    """The calls of ``lshrs_tpu_torch.ops.hamming.<name>`` as the Hamming
    cores make them: the first argument's row count, one entry a call."""
    calls, real = [], getattr(tham, name)

    def spy(first, *a, **kw):
        calls.append(first.shape[0])
        return real(first, *a, **kw)

    monkeypatch.setattr(tham, name, spy)
    return calls


def _spans(prof) -> list[str]:
    return [ev.name() for ev in sorted(prof.profiler.kineto_results.events(),
                                       key=lambda ev: ev.start_ns())
            if ev.name().startswith("lshrs.")]


@pytest.mark.parametrize("num_perm", [32, 64, 128, 256, 384, 512, 1024])
def test_block_slots_is_the_largest_power_of_two_under_the_ceiling(num_perm):
    b = tham.hamming_block_slots(num_perm)
    assert b & (b - 1) == 0
    assert tham.supports_hamming_grouped(num_perm, b)
    assert not tham.supports_hamming_grouped(num_perm, 2 * b)


def test_block_slots_at_256_bits():
    assert tham.hamming_block_slots(256) == 1 << 22


def _store(rng, n: int, **kw) -> tuple[DeviceStore, np.ndarray, np.ndarray]:
    """A CPU store of ``n`` random 256-bit signatures under permuted ids;
    rows ``i`` and ``i + BLOCK`` share a signature for ``i < 40``, the
    later slot under the smaller id."""
    words = rng.integers(0, 1 << R, (n, NB), dtype=np.uint32)
    words[BLOCK : BLOCK + 40] = words[:40]
    ids = rng.permutation(20 * n).astype(np.int64)[:n]
    lo = np.minimum(ids[:40], ids[BLOCK : BLOCK + 40])
    hi = np.maximum(ids[:40], ids[BLOCK : BLOCK + 40])
    ids[:40], ids[BLOCK : BLOCK + 40] = hi, lo
    store = DeviceStore(num_bands=NB, rows_per_band=R, chunk_size=CHUNK, initial_capacity=1024,
                        enable_hamming=True, device="cpu", **kw)
    store.add_signature_batch(ids, words)
    return store, words, ids


def _queries(rng, words: np.ndarray, q: int) -> np.ndarray:
    """Stored signatures (the shared ones first: distance-0 ties across
    the first block boundary), some with a few bits flipped."""
    pick = np.concatenate([np.arange(8), rng.integers(0, len(words), q - 8)])
    flips = rng.integers(0, 1 << R, (q, NB), dtype=np.uint32) & 0x0101
    flips[:8] = 0
    return words[pick] ^ flips


def _answers(store, qw, k, where=None):
    return store.query_hamming(qw, k, where=where)


@pytest.mark.parametrize("k", [10, 700])
def test_blocked_store_equals_its_chunked_route_bit_for_bit(k, rng, monkeypatch):
    """Three and a half blocks (the last partly live): ids and distances
    == the chunked route's and the chunked core's on the same planes, with
    tombstones, an upsert and a ``where=`` filter; ``k=700`` is past the
    last block's live slots."""
    n = 3 * BLOCK + 300
    store, words, ids = _store(rng, n)
    assert store._capacity == 4096
    qw = _queries(rng, words, 24)
    cases = {}
    store.remove_indices(ids[::13].tolist())
    upsert = ids[5 : 2 * BLOCK : 37]
    store.add_signature_batch(upsert, rng.integers(0, 1 << R, (len(upsert), NB), dtype=np.uint32))
    allow = IdFilter(allowed_ids=ids[(np.arange(n) % 3) != 1])
    with monkeypatch.context() as mp:
        _blocks(mp)
        scored = _spy(mp, "hamming_group_max_keys")
        cases["all"] = _answers(store, qw, k)
        cases["where"] = _answers(store, qw, k, where=allow)
        live = store._live_slots()
        assert live == n + (-n % 64) and -(-live // BLOCK) == 4
        assert scored == ([BLOCK] * 3 + [live - 3 * BLOCK]) * 2
        assert store._block_tie is not None and store._block_tie[0] == BLOCK
    with monkeypatch.context() as mp:
        _chunked(mp)
        want = {"all": _answers(store, qw, k), "where": _answers(store, qw, k, where=allow)}
    for name, got in cases.items():
        np.testing.assert_array_equal(got[0], want[name][0])
        np.testing.assert_array_equal(got[1], want[name][1])
    # The chunked core itself, on the store's planes and ids.
    idt = store._ids
    core = tham.hamming_topk_chunked_core(
        store._planes, idt, compute_chunk_ranks(idt, chunk=CHUNK),
        store._planes_rows(torch.from_numpy(qw.view(np.int32))), k=k, chunk=CHUNK, num_perm=P)
    np.testing.assert_array_equal(cases["all"][0], core[0].numpy())
    np.testing.assert_array_equal(cases["all"][1], core[1].numpy())


def test_equal_distances_across_a_block_boundary_go_to_the_smaller_id(rng, monkeypatch):
    """A signature stored at slot i < 40 and at slot i + BLOCK (the later
    slot under the smaller id): a query equal to it ranks both at
    distance 0, the smaller id first, though its block comes second."""
    store, words, ids = _store(rng, 2 * BLOCK + 100)
    _blocks(monkeypatch)
    hamming, got = store.query_hamming(words[:8], 3)
    assert (hamming[:, :2] == 0).all()
    np.testing.assert_array_equal(got[:, 0], ids[BLOCK : BLOCK + 8])
    np.testing.assert_array_equal(got[:, 1], ids[:8])
    assert (got[:, 0] < got[:, 1]).all()


def test_duplicate_ids_across_blocks_keep_slot_order(rng, monkeypatch):
    """``dedupe=False``: one id stored in two blocks with equal distances
    answers as the chunked route does (slot order)."""
    n = 2 * BLOCK + 200
    words = rng.integers(0, 1 << R, (n, NB), dtype=np.uint32)
    words[BLOCK : BLOCK + 20] = words[:20]
    ids = rng.permutation(20 * n)[:n]
    ids[BLOCK : BLOCK + 20] = ids[:20]
    store = DeviceStore(num_bands=NB, rows_per_band=R, chunk_size=CHUNK, initial_capacity=1024,
                        enable_hamming=True, dedupe=False, device="cpu")
    store.add_signature_batch(ids, words)
    qw = _queries(rng, words, 16)
    with monkeypatch.context() as mp:
        _blocks(mp)
        got = store.query_hamming(qw, 6)
    with monkeypatch.context() as mp:
        _chunked(mp)
        want = store.query_hamming(qw, 6)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1][:8, 0] == got[1][:8, 1]).all()


def test_blocked_route_matches_the_float64_reference(monkeypatch):
    """``LSHRS(engine="hamming")`` over seeded unit vectors, three blocks
    of 1,024 slots (the last 448 live): the served ids == the benchmark's
    float64 reference's (exact Hamming ranking of every stored row), and
    the store's distances == the reference's bits' distances to those
    ids."""
    from perfbench.data import clustered

    n, q, dim = 2500, 64, 24
    x = clustered(20_260_001, n + q, dim, centers=64, noise=0.35, device="cpu").numpy()
    train, test = x[:n], x[n:]
    test[:4] = train[[3, BLOCK + 3, 2 * BLOCK + 3, 7]]
    index = dict(dim=dim, num_perm=P, num_bands=NB, rows_per_band=R, engine="hamming",
                 hash_mode="device", hash_family="gaussian", seed=42)
    lsh = LSHRS(**index, initial_capacity=1024, device="cpu")
    lsh.index(np.arange(n), train)
    _blocks(monkeypatch)
    scored = _spy(monkeypatch, "hamming_group_max_keys")
    served = lsh.serving_fn(top_k=10)(test)
    store = lsh._storage
    assert store._capacity == 4096 and -(-store._live_slots() // BLOCK) == 3
    assert scored == [BLOCK, BLOCK, store._live_slots() - 2 * BLOCK]
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


@pytest.mark.parametrize("filtered", [False, True])
def test_a_store_under_the_ceiling_launches_b2_once_and_merges_nothing(
    filtered, rng, monkeypatch
):
    """The same store, unfiltered and under ``where=``: one B2 launch over
    the live slots, no block ties and no ``lshrs.merge`` at the real block
    size; three launches and one merge in blocks, with the same ids and
    distances. Every selection tail takes the kernel's wrapper unfiltered
    and the plain tail under the filter."""
    store, words, ids = _store(rng, 2 * BLOCK + 100)
    qw = _queries(rng, words, 8)
    where = IdFilter(allowed_ids=ids[::3]) if filtered else None
    scored = _spy(monkeypatch, "hamming_group_max_keys")
    tails = _spy(monkeypatch, "select_top_groups")
    fused = _spy(monkeypatch, "hamming_refine_topk")
    store.query_hamming(qw, 5, where=where)  # the lazy tables
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        one = store.query_hamming(qw, 5, where=where)
    assert _spans(prof) == ["lshrs.b2", "lshrs.select", "lshrs.refine", "lshrs.topk"]
    assert scored == [store._live_slots()] * 2 and store._block_tie is None
    _blocks(monkeypatch)
    store.query_hamming(qw, 5, where=where)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        three = store.query_hamming(qw, 5, where=where)
    assert _spans(prof) == ["lshrs.b2", "lshrs.select", "lshrs.refine", "lshrs.topk"] * 3 + [
        "lshrs.merge"]
    assert len(scored) == 2 + 6 and store._block_tie[0] == BLOCK
    assert (len(fused), len(tails) - len(fused)) == ((0, 2 + 6) if filtered else (2 + 6, 0))
    np.testing.assert_array_equal(one[0], three[0])
    np.testing.assert_array_equal(one[1], three[1])


def test_block_ties_follow_every_mutation(rng, monkeypatch):
    """The block-local tie column is dropped by appends, deletes and
    compaction, and recomputed on the next query: answers stay equal to
    the chunked route's."""
    store, words, ids = _store(rng, 2 * BLOCK + 100)
    qw = _queries(rng, words, 12)

    def check():
        with monkeypatch.context() as mp:
            _blocks(mp)
            got = store.query_hamming(qw, 7)
        with monkeypatch.context() as mp:
            _chunked(mp)
            want = store.query_hamming(qw, 7)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])

    check()
    store.add_signature_batch(np.arange(10**6, 10**6 + 900),
                              rng.integers(0, 1 << R, (900, NB), dtype=np.uint32))
    assert store._block_tie is None
    check()
    store.remove_indices(ids[BLOCK - 50 : BLOCK + 50].tolist())
    assert store._block_tie is None
    check()
    store.compact()
    check()


def test_blocked_core_refuses_blocks_off_the_groups():
    planes = torch.zeros((4096, P), dtype=torch.int8)
    tie = torch.full((4096,), -1, dtype=torch.int32)
    qb = torch.zeros((2, P), dtype=torch.int8)
    qw = torch.zeros((2, NB), dtype=torch.int32)
    kw = dict(k=3, group=64, num_perm=P)
    for block, live in ((1000, 4096), (1024, 0), (1024, 100), (1024, 8192)):
        with pytest.raises(ValueError, match="block"):
            tham.hamming_topk_blocked_core(planes, tie, qb, qw, None, block=block, live=live, **kw)
    with pytest.raises(ValueError, match="int32"):
        tham.hamming_topk_blocked_core(
            torch.zeros((1 << 23, 32), dtype=torch.int8), torch.zeros(1 << 23, dtype=torch.int32),
            torch.zeros((1, 32), dtype=torch.int8), qw, None, block=1 << 23, live=64,
            k=3, group=64, num_perm=256)


def test_merge_hamming_pools_orders_by_distance_then_id():
    hamming = torch.tensor([[3, 5, 257, 1, 3, 257]], dtype=torch.int32)
    ids = torch.tensor([[9, 4, -1, 7, 2, -1]], dtype=torch.int32)
    h, i = tham.merge_hamming_pools(hamming, ids, p=256, k=5)
    assert h.tolist() == [[1, 3, 3, 5, 257]] and i.tolist() == [[7, 2, 9, 4, -1]]


@pytest.mark.parametrize("family,bands,rows", [
    ("gaussian", 16, 16), ("structured", 8, 8), ("crosspolytope", 4, 5)])
def test_the_device_build_hashes_in_row_slices(family, bands, rows, monkeypatch):
    """``add_vectors_batch`` hashes its batch a slice of
    ``_BUILD_HASH_ROWS`` rows at a time (a 6.4M x 768 build's bitpack
    temporaries would not fit the card at once): the stored words equal a
    one-slice build's."""
    x = np.random.default_rng(31).standard_normal((100, 24)).astype(np.float32)
    stored = []
    for step in (1 << 18, 7):
        monkeypatch.setattr(DeviceStore, "_BUILD_HASH_ROWS", step)
        lsh = LSHRS(dim=24, num_perm=bands * rows, num_bands=bands, rows_per_band=rows,
                    hash_family=family, hash_mode="device", device="cpu")
        lsh.index(np.arange(100), x)
        stored.append(lsh._storage._sig_rows[:100].clone())
    assert torch.equal(stored[0], stored[1])
