"""The chunked fallback engines: the port against `lshrs_tpu` on the same words.

Where the grouped key cannot run — more than 64 bands, a key past int32
(more than 2**22 slots at 256 bits), a capacity below ``group_size`` —
both packages rank through chunked cores whose keys embed each slot's id
rank within its chunk. The same seeded numpy inputs go through the
reference's jitted cores and the port's, and everything must be equal:
values and ids, at ``k`` below the chunk, above it and above the alive
count. At the store level the chunked route is forced at small
capacities by replacing ``supports_fast_path`` / ``supports_hamming_grouped``
in both packages' ``storage.device`` namespaces (the reference's sharded
store reads them from ``ops.scan`` and ``parallel.sharded``), which edits
no file; the 16-slot store and a 128-band rehash take it unforced. Mirrors
`tests/test_fallback_paths.py`.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lshrs_tpu.ops.scan as jscan_mod
import lshrs_tpu.parallel.sharded as jsharded_mod
import lshrs_tpu.storage.device as jdevice_mod
import lshrs_tpu_torch.storage.device as tdevice_mod
from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import asymmetric as jasym
from lshrs_tpu.ops import hamming as jham
from lshrs_tpu.ops import scan as jscan
from lshrs_tpu.parallel import ShardedDeviceStore as JaxSharded
from lshrs_tpu.parallel import make_mesh as jax_make_mesh
from lshrs_tpu.storage import IdFilter as JaxFilter
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch import IdFilter
from lshrs_tpu_torch.ops import asymmetric as tasym
from lshrs_tpu_torch.ops import hamming as tham
from lshrs_tpu_torch.ops import scan as tscan
from lshrs_tpu_torch.ops.asymmetric import QMAX, QMAX4, quantize_coords_np
from lshrs_tpu_torch.parallel import ShardedDeviceStore, make_mesh
from lshrs_tpu_torch.storage.device import DeviceStore

C, CHUNK = 256, 32
KS = [3, 40, 300]  # below the chunk, above it, above the alive count


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _same(first, *others):
    for other in others:
        for a, b in zip(first, other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _slot_ids(rng, c=C):
    """Slot ids with ~20% dead slots and duplicated alive ids, within a
    chunk and across chunks (the ``dedupe=False`` case)."""
    ids = rng.permutation(5000)[:c].astype(np.int32)
    ids[rng.random(c) < 0.2] = -1
    ids[[5, 40]] = 77
    ids[[6, 7]] = 78
    return ids


def _ranks(ids, chunk=CHUNK):
    jr = np.asarray(jscan.compute_chunk_ranks(jnp.asarray(ids), chunk=chunk))
    tr = tscan.compute_chunk_ranks(_t(ids), chunk=chunk)
    return jr, tr


# -- the cores, against the reference's jitted functions ------------------


@pytest.mark.parametrize("chunk", [1, 16, 64, 256])
def test_chunk_ranks_match_the_reference(chunk, rng):
    ids = _slot_ids(rng)
    jr, tr = _ranks(ids, chunk)
    np.testing.assert_array_equal(jr, tr.numpy())
    assert tr.dtype == torch.int32


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("probes", [1, 2])
@pytest.mark.parametrize("num_bands,rows", [(8, 4), (80, 2), (128, 1)])
def test_collision_chunked_core_matches_the_reference(num_bands, rows, probes, k, rng):
    ids = _slot_ids(rng)
    jr, tr = _ranks(ids)
    sig = rng.integers(0, 2**rows, (num_bands, C), dtype=np.uint32)
    qw = rng.integers(0, 2**rows, (5, probes * num_bands), dtype=np.uint32)
    qw[:, :num_bands] = sig[:, :5].T  # first probe: stored slots
    want = jscan.collision_topk(
        jnp.asarray(sig), jnp.asarray(ids), jnp.asarray(jr), jnp.asarray(qw),
        num_bands=num_bands, k=k, chunk=CHUNK, probes=probes,
    )
    got = tscan.collision_topk_core(
        _t(sig), _t(ids), tr, _t(qw), num_bands=num_bands, k=k, chunk=CHUNK, probes=probes
    )
    _same(want, got)
    assert got[0].dtype == got[1].dtype == torch.int32


def _planes_pair(rng, num_bands, rows, n, q):
    """Stored and query words, the reference's bitplanes and the port's
    (padded to `plane_width`)."""
    sig_rows = rng.integers(0, 2**rows, (n, num_bands), dtype=np.uint32)
    qw = rng.integers(0, 2**rows, (q, num_bands), dtype=np.uint32)
    qw[: q // 2] = sig_rows[: q // 2]
    kw = dict(num_bands=num_bands, rows_per_band=rows)
    jp = jham.unpack_bitplanes(jnp.asarray(sig_rows), **kw)
    jq = jham.unpack_bitplanes(jnp.asarray(qw), **kw)
    width = tham.plane_width(num_bands * rows)
    tp = tham.unpack_bitplanes(_t(sig_rows), width=width, **kw)
    tq = tham.unpack_bitplanes(_t(qw), width=width, **kw)
    return sig_rows, qw, (jp, jq), (tp, tq)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("num_bands,rows", [(16, 16), (3, 10)])  # P=256, and 30 padded to 32
def test_hamming_chunked_cores_match_the_reference(num_bands, rows, k, rng):
    p = num_bands * rows
    ids = _slot_ids(rng)
    jr, tr = _ranks(ids)
    sig_rows, qw, (jp, jq), (tp, tq) = _planes_pair(rng, num_bands, rows, C, 6)
    want = jham.hamming_topk_chunked(jp, jnp.asarray(ids), jnp.asarray(jr), jq, k=k, chunk=CHUNK)
    got = tham.hamming_topk_chunked_core(tp, _t(ids), tr, tq, k=k, chunk=CHUNK, num_perm=p)
    _same(want, got)
    sig_t = np.ascontiguousarray(sig_rows.T)
    want_packed = jham.hamming_topk_packed_chunked(
        jnp.asarray(sig_t), jnp.asarray(ids), jnp.asarray(jr), jnp.asarray(qw),
        num_perm=p, k=k, chunk=CHUNK,
    )
    got_packed = tham.hamming_topk_packed_chunked_core(
        _t(sig_t), _t(ids), tr, _t(qw), num_perm=p, k=k, chunk=CHUNK
    )
    _same(want_packed, got_packed, got)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("qmax", [QMAX, QMAX4])
def test_asymmetric_chunked_core_matches_the_reference(qmax, k, rng):
    num_bands, rows = 3, 10  # P=30: the port's planes and coordinates padded to 32
    p = num_bands * rows
    ids = _slot_ids(rng)
    jr, tr = _ranks(ids)
    _, _, (jp, _), (tp, _) = _planes_pair(rng, num_bands, rows, C, 2)
    qc = rng.integers(-qmax, qmax + 1, (6, p)).astype(np.int8)
    want = jasym.asymmetric_topk_chunked(
        jp, jnp.asarray(ids), jnp.asarray(jr), jnp.asarray(qc), k=k, chunk=CHUNK, qmax=qmax
    )
    qc_t = torch.nn.functional.pad(_t(qc), (0, tp.shape[1] - p))
    got = tasym.asymmetric_topk_chunked_core(
        tp, _t(ids), tr, qc_t, k=k, chunk=CHUNK, qmax=qmax, num_perm=p
    )
    _same(want, got)


def test_asymmetric_chunked_core_keeps_the_reference_guard():
    planes = torch.ones((1 << 14, 1024), dtype=torch.int8)  # P * qmax = 130048
    ids = torch.zeros((1 << 14,), dtype=torch.int32)
    with pytest.raises(ValueError, match="too wide for exact asymmetric packing"):
        tasym.asymmetric_topk_chunked_core(
            planes, ids, ids, planes[:2], k=3, chunk=1 << 14, qmax=QMAX
        )


@pytest.mark.parametrize("m,n", [(1, 64), (17, 40), (24, 5), (100, 256)])
def test_int8_dots_pads_to_the_int_mm_shapes(m, n, rng):
    a = _t(rng.integers(-127, 128, (m, 32)).astype(np.int8))
    b = _t(rng.integers(-127, 128, (n, 32)).astype(np.int8))
    got = tham.int8_dots(a, b)
    assert got.shape == (m, n) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.numpy().astype(np.int64) @ b.numpy().T)
    with pytest.raises(ValueError, match="multiple of 8"):
        tham.int8_dots(a[:, :30], b[:, :30])


def test_grouped_and_chunked_agree(rng):
    """Mirror of the reference's test: the same contents through both
    selection engines give the same answers (collision, planes, packed),
    and equal the reference's chunked cores."""
    nb, r, dim, c = 8, 8, 16, 512
    h = LSHHasher(num_bands=nb, rows_per_band=r, dim=dim, seed=5)
    words = h.hash_batch_words_host(rng.standard_normal((400, dim)).astype(np.float32))
    ids = np.full(c, -1, np.int32)
    ids[:400] = rng.permutation(8000)[:400]
    sig_t = np.zeros((nb, c), np.uint32)
    sig_t[:, :400] = words.T
    qw = h.hash_batch_words_host(rng.standard_normal((7, dim)).astype(np.float32))
    jr, tr = _ranks(ids, 128)
    tie = tscan.global_tie_core(_t(ids))
    chunked = tscan.collision_topk_core(_t(sig_t), _t(ids), tr, _t(qw), num_bands=nb, k=20, chunk=128)
    grouped = tscan.collision_topk_grouped_core(
        _t(sig_t), tie, _t(qw), None, num_bands=nb, k=20, group=32, ids=_t(ids)
    )
    want = jscan.collision_topk(
        jnp.asarray(sig_t), jnp.asarray(ids), jnp.asarray(jr), jnp.asarray(qw),
        num_bands=nb, k=20, chunk=128,
    )
    _same(want, chunked, grouped)
    planes = tham.unpack_bitplanes(_t(np.ascontiguousarray(sig_t.T)), num_bands=nb, rows_per_band=r)
    qbits = tham.unpack_bitplanes(_t(qw), num_bands=nb, rows_per_band=r)
    ham_chunked = tham.hamming_topk_chunked_core(planes, _t(ids), tr, qbits, k=20, chunk=128)
    ham_packed = tham.hamming_topk_packed_chunked_core(
        _t(sig_t), _t(ids), tr, _t(qw), num_perm=nb * r, k=20, chunk=128
    )
    ham_grouped = tham.hamming_topk_core(
        planes, tie, qbits, _t(qw), None, k=20, group=32, sig_t=_t(sig_t), ids=_t(ids)
    )
    _same(ham_grouped, ham_chunked, ham_packed)


# -- stores: mirrors of tests/test_fallback_paths.py ----------------------


def oracle_topk(words, ids, qw, num_bands, k):
    n = words.shape[0]
    eq = (words == qw[None, :]).reshape(n, num_bands, -1).all(-1)
    counts = eq.sum(-1)
    cand = sorted((-int(c), int(i)) for c, i in zip(counts, ids) if c > 0)
    return [(i, -c) for c, i in cand[:k]]


@pytest.mark.parametrize("num_bands,rows", [(128, 4), (80, 2)])
def test_wide_band_configs_use_chunked_fallback(num_bands, rows, rng):
    """More than 64 bands: the chunked scan, oracle-exact and == the
    reference's store."""
    dim = 24
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=dim, seed=3)
    kw = dict(num_bands=num_bands, rows_per_band=rows, chunk_size=128, initial_capacity=128)
    js, ts = JaxStore(**kw), DeviceStore(device="cpu", **kw)
    assert not ts._use_grouped() and not ts.stats()["fast_path"]
    assert ts.stats()["fast_path"] == js.stats()["fast_path"]
    X = rng.standard_normal((300, dim)).astype(np.float32)
    ids = rng.permutation(9000)[:300]
    words = h.hash_batch_words_host(X)
    for s in (js, ts):
        s.add_signature_batch(ids, words)
    qw = h.hash_batch_words_host(rng.standard_normal((6, dim)).astype(np.float32))
    counts, out_ids = ts.query_topk(qw, 15)
    _same(js.query_topk(qw, 15), (counts, out_ids))
    for qi in range(6):
        got = [(int(i), int(c)) for i, c in zip(out_ids[qi], counts[qi]) if c > 0]
        assert got == oracle_topk(words, ids, qw[qi], num_bands, 15)


def test_very_wide_bands_w4(rng, monkeypatch):
    """r = 128 (W = 4 words per band): grouped, then forced chunked; both
    oracle-exact and == the reference."""
    h = LSHHasher(num_bands=2, rows_per_band=128, dim=24, seed=11)
    kw = dict(num_bands=2, rows_per_band=128, chunk_size=128, initial_capacity=128)
    js, ts = JaxStore(**kw), DeviceStore(device="cpu", **kw)
    X = rng.standard_normal((200, 24)).astype(np.float32)
    ids = rng.permutation(5000)[:200]
    words = h.hash_batch_words_host(X)
    for s in (js, ts):
        s.add_signature_batch(ids, words)
    qw = h.hash_batch_words_host(rng.standard_normal((5, 24)).astype(np.float32))
    grouped = ts.query_topk(qw, 10)
    _force_chunked(monkeypatch)
    assert not ts._use_grouped()
    chunked = ts.query_topk(qw, 10)
    _same(js.query_topk(qw, 10), chunked, grouped)
    for qi in range(5):
        got = [(int(i), int(c)) for i, c in zip(chunked[1][qi], chunked[0][qi]) if c > 0]
        assert got == oracle_topk(words, ids, qw[qi], 2, 10)
    counts, out_ids = ts.query_topk(words[:1], 1)
    assert out_ids[0][0] == ids[0] and counts[0][0] == 2


def _force_chunked(monkeypatch):
    """Route every store of both packages to its chunked cores."""
    for mod in (jdevice_mod, tdevice_mod, jscan_mod):
        monkeypatch.setattr(mod, "supports_fast_path", lambda *a: False)
    for mod in (jdevice_mod, tdevice_mod, jsharded_mod):
        monkeypatch.setattr(mod, "supports_hamming_grouped", lambda *a: False)


B, R, D = 8, 8, 32  # 64 bits: room for a 32-bit cascade prefix


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def _pair(**kw):
    kw = {"num_bands": B, "rows_per_band": R, "chunk_size": 64, "initial_capacity": 256,
          "enable_hamming": True, **kw}
    return JaxStore(**kw), DeviceStore(device="cpu", **kw)


_MODES = {
    "planes": {},
    "packed": {"hamming_storage": "packed"},
    # The cascade falls back (to the packed chunked core) only where the
    # capacity is not a multiple of the group.
    "cascade": {"hamming_cascade": 32, "hamming_cascade_refine": 64, "group_size": 512},
}


def _hamming_answers(js, ts, qw, k, **q):
    _same(js.query_hamming(qw, k, **q), ts.query_hamming(qw, k, **q))


@pytest.mark.parametrize("mode", ["collision", *_MODES])
def test_forced_chunked_store_matches_the_reference(mode, hasher, rng, monkeypatch):
    """Every query form of a store forced onto its chunked route: ids and
    counts / distances == the reference's forced store, through the store
    API, serving closures (stale after a mutation), ``where=``, a delete
    and a compact."""
    _force_chunked(monkeypatch)
    js, ts = _pair(**_MODES.get(mode, {}))
    n = 180
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(20_000)[:n]
    words = hasher.hash_batch_words_host(X)
    for s in (js, ts):
        s.add_signature_batch(ids, words)
    assert ts.stats()["fast_path"] is False and js.stats()["fast_path"] is False
    qw = hasher.hash_batch_words_host(X[:8] + 0.3 * rng.standard_normal((8, D)).astype(np.float32))
    ham = mode != "collision"
    query = (lambda s, *a, **kw: s.query_hamming(*a, **kw)) if ham else (
        lambda s, *a, **kw: s.query_topk(*a, **kw))
    smode = "hamming" if ham else "collision"
    for k in (70, 300):
        _same(query(js, qw, k), query(ts, qw, k))
    assert ts._ranks is not None and ts._refine is None  # the chunked route, not the grouped
    jf = JaxFilter(allowed_ids=ids[::3], disallowed_ids=[int(ids[0])])
    tf = IdFilter(allowed_ids=ids[::3], disallowed_ids=[int(ids[0])])
    _same(query(js, qw, 12, where=jf), query(ts, qw, 12, where=tf))
    serve_t = ts.snapshot_query_fn(10, mode=smode)
    want = query(js, qw, 10)[1]
    want_f = query(js, qw, 10, where=jf)[1]
    np.testing.assert_array_equal(serve_t(qw).numpy(), want)
    np.testing.assert_array_equal(ts.snapshot_query_fn(10, mode=smode, where=tf)(qw).numpy(), want_f)
    if mode != "cascade":  # the reference's cascade closure fails on a group above the capacity
        np.testing.assert_array_equal(np.asarray(js.snapshot_query_fn(10, mode=smode)(qw)), want)
        np.testing.assert_array_equal(
            np.asarray(js.snapshot_query_fn(10, mode=smode, where=jf)(qw)), want_f
        )
    gone = ids[:40:2].tolist()
    for s in (js, ts):
        s.remove_indices(gone)
    with pytest.raises(RuntimeError, match="stale"):
        serve_t(qw)
    assert ts._ranks is None  # dropped by the mutation
    after = query(ts, qw, 20)
    _same(query(js, qw, 20), after)
    assert not np.isin(after[1], gone).any()
    for s in (js, ts):
        s.compact()
    _same(query(js, qw, 20), query(ts, qw, 20), after)
    if mode == "collision":
        probe = np.stack([qw, words[8:16]], axis=1)  # (Q, T=2, BW)
        _same(js.query_topk(probe, 9), ts.query_topk(probe, 9))


def test_forced_chunked_asymmetric_matches_the_reference(hasher, rng, monkeypatch):
    """The asymmetric chunked route (a capacity not a multiple of the
    group; forced here on the port's store) == the reference's grouped
    engine, which is exact at this capacity (shift 0)."""
    js, ts = _pair()
    n = 180
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(20_000)[:n]
    words = hasher.hash_batch_words_host(X)
    for s in (js, ts):
        s.add_signature_batch(ids, words)
    assert tasym.asymmetric_shift(B * R, ts._capacity) == 0
    monkeypatch.setattr(ts, "_group", lambda: 3 * ts._capacity)  # no whole group fits
    qc, _ = quantize_coords_np(hasher.hash_batch_coords_host(X[:8]))
    for k in (70, 300):
        _same(js.query_asymmetric(qc, k), ts.query_asymmetric(qc, k))
    assert ts._ranks is not None and ts._refine is None
    jf = JaxFilter(allowed_ids=ids[::2])
    tf = IdFilter(allowed_ids=ids[::2])
    _same(js.query_asymmetric(qc, 12, where=jf), ts.query_asymmetric(qc, 12, where=tf))
    np.testing.assert_array_equal(
        np.asarray(js.snapshot_query_fn(10, mode="asymmetric")(qc)),
        ts.snapshot_query_fn(10, mode="asymmetric")(qc).numpy(),
    )
    qc4, _ = quantize_coords_np(hasher.hash_batch_coords_host(X[:8]), qmax=QMAX4)
    from lshrs_tpu_torch.ops.asymmetric import pack_coords_int4_np

    wire = pack_coords_int4_np(qc4)
    np.testing.assert_array_equal(
        np.asarray(js.snapshot_query_fn(10, mode="asymmetric", wire="coords4")(wire)),
        ts.snapshot_query_fn(10, mode="asymmetric", wire="coords4")(wire).numpy(),
    )


# -- a store below the group: the fault this slice repairs -----------------


@pytest.mark.parametrize("mode", ["collision", *_MODES])
def test_sixteen_slot_store_answers_like_the_reference(mode):
    """Capacity 16 below group_size 64: the port raised on the first top-k;
    both packages now answer through the chunked cores."""
    kw = dict(num_bands=B, rows_per_band=R, chunk_size=16, initial_capacity=16)
    if mode != "collision":
        kw.update(enable_hamming=True, **_MODES[mode])
    js, ts = JaxStore(**kw), DeviceStore(device="cpu", **kw)
    assert ts._capacity == 16 and ts._capacity % ts.group and not ts._use_grouped()
    w = np.arange(1, 1 + 3 * B, dtype=np.uint32).reshape(3, B)
    for s in (js, ts):
        s.add_signature_batch([0, 1, 2], w)
    q = np.concatenate([w[:2], w[2:] ^ 1])
    for k in (1, 3, 20):
        if mode == "collision":
            _same(js.query_topk(q, k), ts.query_topk(q, k))
        else:
            _same(js.query_hamming(q, k), ts.query_hamming(q, k))
    if mode == "collision":
        np.testing.assert_array_equal(ts.query_topk(w[:2], 3)[1], [[0, -1, -1], [1, -1, -1]])


def test_sixteen_slot_lshrs_answers_like_the_reference(rng):
    """`LSHRS(initial_capacity=16, chunk_size=16)` (group 32 by default) and
    a group above the capacity: top-k, serving, Hamming and asymmetric
    ranking == the reference."""
    X = rng.standard_normal((12, D)).astype(np.float32)
    for extra in ({}, {"group_size": 128, "enable_hamming": True}):
        kw = dict(dim=D, num_perm=32, num_bands=4, rows_per_band=8, seed=3,
                  initial_capacity=16, chunk_size=16, **extra)
        jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
        for lsh in (jl, tl):
            lsh.index(list(range(12)), X)
        assert tl.stats()["index"]["capacity"] == 16
        assert tl.query_batch(X[:6], top_k=4) == jl.query_batch(X[:6], top_k=4)
        assert tl.get_top_k(X[3], topk=3) == jl.get_top_k(X[3], topk=3)
        np.testing.assert_array_equal(tl.serving_fn(top_k=5)(X), np.asarray(jl.serving_fn(top_k=5)(X)))
        if extra:
            assert tl.query_hamming_batch(X[:4], top_k=5) == jl.query_hamming_batch(X[:4], top_k=5)
            got = tl.query_asymmetric_batch(X[:4], top_k=5)
            want = jl.query_asymmetric_batch(X[:4], top_k=5)
            assert [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]


# -- sharded stores, rehash, top-p, closures --------------------------------


@pytest.mark.parametrize("mode", ["collision", "planes", "packed"])
def test_forced_chunked_sharded_store_matches_the_reference(mode, hasher, rng, monkeypatch):
    """Eight CPU shards forced chunked (shard-local chunk ranks, merged by
    id) == the reference's sharded store on its 8 virtual devices and ==
    the port's grouped unsharded store."""
    kw = dict(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64 * 8,
              enable_hamming=mode != "collision", **_MODES.get(mode, {}))
    n = 400
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(50_000)[:n]
    words = hasher.hash_batch_words_host(X)
    single = DeviceStore(device="cpu", **kw)
    single.add_signature_batch(ids, words)
    qw = hasher.hash_batch_words_host(X[:10] + 0.3 * rng.standard_normal((10, D)).astype(np.float32))
    query = "query_topk" if mode == "collision" else "query_hamming"
    want = getattr(single, query)(qw, 25)
    _force_chunked(monkeypatch)
    js = JaxSharded(mesh=jax_make_mesh(8), **kw)
    ts = ShardedDeviceStore(mesh=make_mesh(8, devices=["cpu"] * 8), **kw)
    for s in (js, ts):
        s.add_signature_batch(ids, words)
    assert not ts._use_grouped() and not js._use_grouped()
    _same(getattr(js, query)(qw, 25), getattr(ts, query)(qw, 25), want)
    assert all(s._ranks is not None for s in ts._shards)
    smode = "collision" if mode == "collision" else "hamming"
    np.testing.assert_array_equal(
        np.asarray(js.snapshot_query_fn(10, mode=smode)(qw)),
        ts.snapshot_query_fn(10, mode=smode)(qw).numpy(),
    )
    flt = (JaxFilter(allowed_ids=ids[::4]), IdFilter(allowed_ids=ids[::4]))
    _same(getattr(js, query)(qw, 9, where=flt[0]), getattr(ts, query)(qw, 9, where=flt[1]))


def _rehash_pair(rng, **kw):
    base = dict(dim=D, num_perm=128, num_bands=16, rows_per_band=8, store_vectors=True, seed=42,
                chunk_size=128, initial_capacity=512, engine="collision", hash_family="structured")
    base.update(kw)
    X = rng.standard_normal((300, D)).astype(np.float32)
    out = []
    for lsh in (JaxLSHRS(**base), TorchLSHRS(device="cpu", **base)):
        lsh.index(list(range(300)), X)
        lsh.delete([3, 4])
        lsh.rehash(num_bands=128, rows_per_band=1, seed=2)
        out.append(lsh)
    return (*out, X)


def test_rehash_to_128_bands_serves_like_the_reference(rng, tmp_path):
    """128 x 1 after a rehash: the chunked collision core; top-k, serving
    and top-p (auto -> the full engine; a pinned gather raises) == the
    reference, and a checkpoint loads both ways."""
    jl, tl, X = _rehash_pair(rng)
    store = tl._storage
    assert store.num_bands == 128 and not store._use_grouped()
    assert tl.query_batch(X[:20], top_k=8) == jl.query_batch(X[:20], top_k=8)
    np.testing.assert_array_equal(tl.serving_fn(top_k=6)(X[:30]),
                                  np.asarray(jl.serving_fn(top_k=6)(X[:30])))
    assert store._resolve_rerank_engine(None, None)[0] == "full"
    assert tl.stats()["index"]["rerank_engine"] == jl.stats()["index"]["rerank_engine"] == "full"
    want = jl.get_above_p_batch(X[:6], p=0.5, top_k=5)
    got = tl.get_above_p_batch(X[:6], p=0.5, top_k=5)
    assert [[i for i, _ in r] for r in got] == [[i for i, _ in r] for r in want]
    for lsh in (jl, tl):
        with pytest.raises(RuntimeError, match="gather"):
            lsh._storage._resolve_rerank_engine("gather", None)
    tl.save_to_disk(tmp_path / "port")
    jl.save_to_disk(tmp_path / "ref")
    from_port = JaxLSHRS.load_from_disk(tmp_path / "port")
    from_ref = TorchLSHRS.load_from_disk(tmp_path / "ref", device="cpu")
    assert from_ref._storage.num_bands == 128 and not from_ref._storage._use_grouped()
    want = jl.query_batch(X[:20], top_k=8)
    assert from_port.query_batch(X[:20], top_k=8) == want == from_ref.query_batch(X[:20], top_k=8)


def test_chunked_closures_follow_mutations(rng):
    """A closure taken on a chunked store serves, goes stale after a
    mutation, and an ``auto_refresh`` one serves the new contents ==
    the reference's."""
    jl, tl, X = _rehash_pair(rng)
    strict = tl.serving_fn(top_k=5)
    fresh_t, fresh_j = (lsh.serving_fn(top_k=5, auto_refresh=True) for lsh in (tl, jl))
    np.testing.assert_array_equal(strict(X[:10]), fresh_t(X[:10]))
    for lsh in (jl, tl):
        lsh.delete([0, 1, 2])
    with pytest.raises(RuntimeError, match="stale"):
        strict(X[:10])
    out = fresh_t(X[:10])
    np.testing.assert_array_equal(out, np.asarray(fresh_j(X[:10])))
    assert not np.isin(out, [0, 1, 2]).any()
    assert (out[5:, 0] == np.arange(5, 10)).all()


def test_grouped_routes_never_compute_chunk_ranks(hasher, rng):
    """The chunk ranks are computed only where a chunked route reads them."""
    _, ts = _pair()
    X = rng.standard_normal((100, D)).astype(np.float32)
    ts.add_signature_batch(np.arange(100), hasher.hash_batch_words_host(X))
    qw = hasher.hash_batch_words_host(X[:4])
    ts.query_topk(qw, 5)
    ts.query_hamming(qw, 5)
    assert ts._use_grouped() and ts._ranks is None


@pytest.mark.parametrize("storage", ["planes", "packed"])
def test_hamming_below_the_group_chunk_answers_where_the_reference_raises(storage, rng):
    """A kept difference: at ``chunk_size < group_size`` on a store that
    takes the grouped Hamming route, the reference's XLA core fails on the
    first query (``key.reshape(q, chunk // group, group)`` in
    ``lshrs_tpu/ops/hamming.py``). The port answers, with the ids the
    reference gives at ``chunk_size == group_size`` on the same words."""
    kw = dict(dim=32, num_perm=32, num_bands=8, rows_per_band=4, initial_capacity=128,
              group_size=64, engine="hamming", hamming_storage=storage,
              hash_family="structured", hash_mode="host", seed=3)
    X = rng.standard_normal((100, 32)).astype(np.float32)
    Q = X[:20] + 0.3 * rng.standard_normal((20, 32)).astype(np.float32)
    faulty = JaxLSHRS(chunk_size=32, **kw)
    faulty.index(np.arange(100), X)
    with pytest.raises(TypeError, match="reshape"):
        faulty.query_batch(Q[:3], top_k=5)
    ref = JaxLSHRS(chunk_size=64, **kw)
    port = TorchLSHRS(chunk_size=32, device="cpu", **kw)
    for lsh in (ref, port):
        lsh.index(np.arange(100), X)
    np.testing.assert_array_equal(
        port._storage._sig_t[:, :100].numpy(), _t(np.asarray(ref._storage._sig_t)[:, :100]).numpy())
    assert port.query_batch(Q, top_k=5) == ref.query_batch(Q, top_k=5)
    assert port.query_hamming_batch(Q, top_k=5) == ref.query_hamming_batch(Q, top_k=5)
    np.testing.assert_array_equal(port.serving_fn(top_k=5)(Q), np.asarray(ref.serving_fn(top_k=5)(Q)))
    np.testing.assert_array_equal(port.serving_fn(top_k=1)(X[:50])[:, 0], np.arange(50))
