"""Asymmetric ranking: the port against `lshrs_tpu` on the same words and
the same quantised coordinates.

Both stores are fed identical signature words; both packages quantise
with the same ``rint`` and take the coordinates from the host hash, so
dots and ids must be IDENTICAL — through the store, its serving closure
(both wires), ``where=`` filters, mutations and the `LSHRS` entry
points. The reference runs its XLA path, and its Pallas kernel in
interpret mode where a test says so.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import asymmetric as jasym
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch import IdFilter
from lshrs_tpu_torch.ops import asymmetric as tasym
from lshrs_tpu_torch.ops.group_max import key_scale
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

B, R, D = 4, 8, 32
P = B * R
KW = dict(num_bands=B, rows_per_band=R, chunk_size=64, initial_capacity=64, enable_hamming=True)


@pytest.fixture
def hasher():
    return LSHHasher(num_bands=B, rows_per_band=R, dim=D, seed=42)


def _pair(**kw):
    kw = {**KW, **kw}
    return JaxStore(**kw), TorchStore(device="cpu", **kw)


def planes_of(words, num_bands=B, rows=R, wpb=1):
    """±1 bitplanes in the packing's bit order (band-major, row-minor)."""
    n, p = words.shape[0], num_bands * rows
    out = np.zeros((n, p), np.int8)
    for j in range(p):
        band, row = j // rows, j % rows
        out[:, j] = ((words[:, band * wpb + row // 32] >> (row % 32)) & 1).astype(np.int8) * 2 - 1
    return out


def oracle_topk(q_i8, store_planes, ids, k):
    """(dots desc, id asc) brute force over alive slots."""
    dots = store_planes.astype(np.int32) @ q_i8.astype(np.int32)
    return [(-d, i) for d, i in sorted(zip((-dots).tolist(), ids.tolist()))[:k]]


def _coords(hasher, rng, q, qmax=jasym.QMAX):
    return jasym.quantize_coords_np(
        hasher.hash_batch_coords_host(rng.standard_normal((q, D)).astype(np.float32)), qmax=qmax
    )[0]


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))


def test_quantize_coords_contract(rng):
    coords = rng.standard_normal((16, P)).astype(np.float32) * 3.7
    coords[3, :4] = [0.5, -0.5, 1.5, 2.5]  # rint's halves, scaled by the row max
    qi8, sumabs = tasym.quantize_coords_np(coords)
    jq, js = jasym.quantize_coords_np(coords)
    np.testing.assert_array_equal(qi8, jq)
    np.testing.assert_array_equal(sumabs, js)
    assert np.abs(qi8.astype(np.int32)).max() == tasym.QMAX
    tq, ts = tasym.quantize_coords(torch.from_numpy(coords))
    np.testing.assert_array_equal(tq.numpy(), qi8)
    np.testing.assert_array_equal(ts.numpy(), sumabs)
    for qmax in (tasym.QMAX4, 64):
        np.testing.assert_array_equal(
            tasym.quantize_coords_np(coords, qmax)[0], jasym.quantize_coords_np(coords, qmax)[0]
        )
    z, sz = tasym.quantize_coords(torch.zeros((2, P)))
    assert (z == 0).all() and (sz == 0).all()


def test_asymmetric_shift_bounds():
    assert tasym.asymmetric_shift(P, 1024) == 0
    for p, cap in [(256, 1 << 17), (256, 1 << 20), (1024, 1 << 22), (256, 1 << 23)]:
        s = tasym.asymmetric_shift(p, cap)
        assert s == jasym.asymmetric_shift(p, cap)
        # the largest alive key, (maxscaled + 2) * scale - 1, is an int32
        assert (((2 * p * tasym.QMAX) >> s) + 2) * key_scale(cap) <= 2**31


def test_pack_unpack_coords_int4_roundtrip(rng):
    qi8 = rng.integers(-tasym.QMAX4, tasym.QMAX4 + 1, size=(17, P)).astype(np.int8)
    packed = tasym.pack_coords_int4_np(qi8)
    np.testing.assert_array_equal(packed, jasym.pack_coords_int4_np(qi8))
    assert packed.shape == (17, P // 2) and packed.dtype == np.uint8
    out = tasym.unpack_coords_int4(torch.from_numpy(packed))
    assert out.dtype == torch.int8
    np.testing.assert_array_equal(out.numpy(), qi8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jasym.unpack_coords_int4(packed)))
    with pytest.raises(ValueError, match="int4"):
        tasym.pack_coords_int4_np(np.full((2, P), 100, np.int8))
    with pytest.raises(ValueError, match="even"):
        tasym.pack_coords_int4_np(np.zeros((2, P - 1), np.int8))


@pytest.mark.parametrize("narrow", [False, True])
def test_refine_dots_from_words_matches_reference(narrow, rng):
    """The batched-product refine == the reference's select-accumulate, on
    word-aligned and narrow-packed rows (r=16: two bands per word)."""
    from lshrs_tpu_torch.ops.bitpack import pack_words_narrow

    nb, r = 6, 16
    words = rng.integers(0, 1 << r, (3, 4, nb, 5), dtype=np.int64).astype(np.uint32)
    qc = rng.integers(-127, 128, (3, nb * r)).astype(np.int8)
    cw = torch.from_numpy(words.view(np.int32))
    narrow_r = 0
    if narrow:
        flat = cw.permute(0, 1, 3, 2).reshape(-1, nb)
        cw = pack_words_narrow(flat, num_bands=nb, rows_per_band=r)
        cw = cw.reshape(3, 4, 5, -1).permute(0, 1, 3, 2)
        words = cw.contiguous().numpy().view(np.uint32)
        narrow_r = r
    got = tasym.refine_dots_from_words(
        cw, torch.from_numpy(qc), num_bands=nb, rows_per_band=r, narrow_r=narrow_r
    )
    want = jasym.refine_dots_from_words(words, qc, num_bands=nb, rows_per_band=r, narrow_r=narrow_r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_exact_pool_order_matches_reference(rng):
    dots = rng.integers(-50, 50, (5, 40)).astype(np.int32)
    ids = np.stack([rng.permutation(1000)[:40] for _ in range(5)]).astype(np.int32)
    alive = rng.random((5, 40)) < 0.8
    alive[4] = False  # an all-dead pool
    for k in (7, 40, 50):
        got = tasym._exact_pool_order(
            torch.from_numpy(dots), torch.from_numpy(ids), torch.from_numpy(alive), k, 4064
        )
        _same(got, jasym._exact_pool_order(dots, ids, alive, k, 4064))


def test_asymmetric_matches_reference_and_oracle(hasher, rng):
    js, ts = _pair()
    n = 500
    X = rng.standard_normal((n, D)).astype(np.float32)
    ids = rng.permutation(30_000)[:n]
    words = hasher.hash_batch_words_host(X)
    js.add_signature_batch(ids, words)
    ts.add_signature_batch(ids, words)
    assert tasym.asymmetric_shift(P, ts.stats()["capacity"]) == 0  # exact regime
    qi8 = _coords(hasher, rng, 10)
    got = ts.query_asymmetric(qi8, 15)
    _same(got, js.query_asymmetric(qi8, 15))
    xb = planes_of(words)
    for qi in range(10):
        assert list(zip(got[0][qi].tolist(), got[1][qi].tolist())) == oracle_topk(
            qi8[qi], xb, ids, 15
        )


def test_asymmetric_after_mutations(hasher, rng):
    js, ts = _pair()
    X = rng.standard_normal((300, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    for s in (js, ts):
        s.add_signature_batch(np.arange(300), words)
        s.remove_indices(list(range(0, 300, 3)))
        s.add_signature_batch([4, 5, 900], hasher.hash_batch_words_host(X[[10, 11, 12]]))
    qi8 = _coords(hasher, rng, 6)
    _same(ts.query_asymmetric(qi8, 9), js.query_asymmetric(qi8, 9))
    for s in (js, ts):
        s.compact()
    _same(ts.query_asymmetric(qi8, 9), js.query_asymmetric(qi8, 9))


def test_asymmetric_shifted_regime_matches_reference(hasher, rng, monkeypatch):
    """A shift > 0 (the regime of large stores, forced by a small budget
    through key_scale) selects the same groups in both packages."""
    import lshrs_tpu.ops.asymmetric as jmod

    import lshrs_tpu_torch.ops.group_max as tgm

    js, ts = _pair(initial_capacity=1024)
    X = rng.standard_normal((900, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(np.concatenate([X, X[:50]]))
    ids = np.arange(950)
    js.add_signature_batch(ids, words)
    ts.add_signature_batch(ids, words)
    big = lambda c: 1 << 24  # noqa: E731 - budget (2**31 >> 24) - 2 = 126
    for mod in (tgm, tasym, jmod):
        monkeypatch.setattr(mod, "key_scale", big)
    import lshrs_tpu.ops.pallas_scan as jps

    monkeypatch.setattr(jps, "key_scale", big)
    assert tgm.asymmetric_shift(P, 1024) > 0
    qi8 = _coords(hasher, rng, 8)
    _same(ts.query_asymmetric(qi8, 12), js.query_asymmetric(qi8, 12))


def test_asymmetric_where_filter(hasher, rng):
    js, ts = _pair(initial_capacity=512)
    X = rng.standard_normal((400, D)).astype(np.float32)
    ids = rng.permutation(5000)[:400]
    words = hasher.hash_batch_words_host(X)
    js.add_signature_batch(ids, words)
    ts.add_signature_batch(ids, words)
    allow = ids[rng.random(400) < 0.3]
    flt = IdFilter(allowed_ids=allow, disallowed_ids=allow[:5])
    from lshrs_tpu.storage import IdFilter as JaxFilter

    jflt = JaxFilter(allowed_ids=allow, disallowed_ids=allow[:5])
    qi8 = _coords(hasher, rng, 9)
    got = ts.query_asymmetric(qi8, 10, where=flt)
    _same(got, js.query_asymmetric(qi8, 10, where=jflt))
    admitted = flt.admits(ids)
    xb = planes_of(words[admitted])
    for qi in range(9):
        assert list(zip(got[0][qi].tolist(), got[1][qi].tolist())) == oracle_topk(
            qi8[qi], xb, ids[admitted], 10
        )
    serve = ts.snapshot_query_fn(10, mode="asymmetric", where=flt)
    np.testing.assert_array_equal(serve(qi8).numpy(), got[1])


def test_asymmetric_plain_b2_matches_pallas_interpret(hasher, rng):
    """The port's core (B2's plain version on the CPU) == the reference's
    core with its Pallas kernel in interpret mode."""
    import jax.numpy as jnp

    from lshrs_tpu.ops.hamming import unpack_bitplanes
    from lshrs_tpu.ops.scan import compute_global_tie
    from lshrs_tpu_torch.ops.scan import global_tie_core

    c = 512
    X = rng.standard_normal((300, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    ids = np.full(c, -1, np.int32)
    ids[:300] = rng.permutation(4000)[:300]
    sig = np.zeros((c, B), np.uint32)
    sig[:300] = words
    planes = unpack_bitplanes(jnp.asarray(sig), num_bands=B, rows_per_band=R)
    tie = compute_global_tie(jnp.asarray(ids))
    qi8 = _coords(hasher, rng, 6)
    want = jasym.asymmetric_topk(
        planes, jnp.asarray(ids), tie, jnp.asarray(qi8), k=12, chunk=128, group=32, shift=0,
        use_pallas=True, interpret=True, q_tile=8,
    )
    sig_t = torch.from_numpy(sig.view(np.int32).T.copy())
    got = tasym.asymmetric_topk_core(
        torch.from_numpy(np.array(planes)), global_tie_core(torch.from_numpy(ids)),
        torch.from_numpy(qi8), None, num_bands=B, rows_per_band=R, k=12, group=32, shift=0,
        sig_t=sig_t, ids=torch.from_numpy(ids),
    )
    _same(got, want)


def test_snapshot_asymmetric_matches_query(hasher, rng):
    js, ts = _pair()
    X = rng.standard_normal((300, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    js.add_signature_batch(np.arange(300), words)
    ts.add_signature_batch(np.arange(300), words)
    qi8 = _coords(hasher, rng, 7)
    _, want = ts.query_asymmetric(qi8, 6)
    serve = ts.snapshot_query_fn(6, mode="asymmetric")
    np.testing.assert_array_equal(serve(qi8).numpy(), want)
    np.testing.assert_array_equal(
        serve(qi8).numpy(), np.asarray(js.snapshot_query_fn(6, mode="asymmetric")(qi8))
    )
    ts.remove_indices([3])
    with pytest.raises(RuntimeError, match="stale"):
        serve(qi8)
    with pytest.raises(ValueError, match="asymmetric"):
        ts.snapshot_query_fn(6, mode="cosine")


def test_snapshot_coords4_matches_reference(hasher, rng):
    js, ts = _pair()
    X = rng.standard_normal((280, D)).astype(np.float32)
    words = hasher.hash_batch_words_host(X)
    js.add_signature_batch(np.arange(280), words)
    ts.add_signature_batch(np.arange(280), words)
    qi4 = _coords(hasher, rng, 6, qmax=tasym.QMAX4)
    _, want = ts.query_asymmetric(qi4, 7)
    wire = tasym.pack_coords_int4_np(qi4)
    got = ts.snapshot_query_fn(7, mode="asymmetric", wire="coords4")(wire).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(js.snapshot_query_fn(7, mode="asymmetric", wire="coords4")(wire))
    )
    with pytest.raises(ValueError, match="coords4"):
        ts.snapshot_query_fn(7, mode="collision", wire="coords4")


@pytest.mark.parametrize("case", ["packed", "collision_only", "empty"])
def test_asymmetric_refusals_match_reference(case, hasher, rng):
    kw = {"packed": dict(hamming_storage="packed"), "collision_only": dict(enable_hamming=False),
          "empty": {}}[case]
    js, ts = _pair(**kw)
    qi8 = _coords(hasher, rng, 2)
    if case == "empty":
        _same(ts.query_asymmetric(qi8, 3), js.query_asymmetric(qi8, 3))
        assert (ts.query_asymmetric(qi8, 3)[0] == -(P * tasym.QMAX + 1)).all()
        with pytest.raises(RuntimeError, match="non-empty"):
            ts.snapshot_query_fn(3, mode="asymmetric")
        return
    words = hasher.hash_batch_words_host(rng.standard_normal((20, D)).astype(np.float32))
    ts.add_signature_batch(np.arange(20), words)
    match = "planes" if case == "packed" else "enable_hamming"
    with pytest.raises(RuntimeError, match=match):
        ts.query_asymmetric(qi8, 3)
    with pytest.raises(RuntimeError, match=match):
        ts.snapshot_query_fn(5, mode="asymmetric")


def test_word_row_refine_multiword_bands(rng):
    """r=40: two words per band, word-aligned refine rows."""
    b2, r2, d2 = 2, 40, 48
    h = LSHHasher(num_bands=b2, rows_per_band=r2, dim=d2, seed=5)
    js, ts = _pair(num_bands=b2, rows_per_band=r2)
    X = rng.standard_normal((200, d2)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    js.add_signature_batch(np.arange(200), words)
    ts.add_signature_batch(np.arange(200), words)
    qi8 = jasym.quantize_coords_np(
        h.hash_batch_coords_host(rng.standard_normal((4, d2)).astype(np.float32))
    )[0]
    got = ts.query_asymmetric(qi8, 6)
    _same(got, js.query_asymmetric(qi8, 6))
    xb = planes_of(words, b2, r2, wpb=2)
    for qi in range(4):
        assert [(int(d), int(i)) for d, i in zip(*[g[qi] for g in got]) if i >= 0] == oracle_topk(
            qi8[qi], xb, np.arange(200), 6
        )


def _lsh_pair(**kw):
    kw = {**dict(dim=D, num_perm=P, num_bands=B, rows_per_band=R, enable_hamming=True,
                 initial_capacity=256, hash_mode="host"), **kw}
    return JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)


def test_orchestrator_query_asymmetric(rng):
    jl, tl = _lsh_pair()
    X = rng.standard_normal((200, D)).astype(np.float32)
    jl.index(np.arange(200), X)
    tl.index(np.arange(200), X)
    res = tl.query_asymmetric(X[7], top_k=5)
    assert res == jl.query_asymmetric(X[7], top_k=5)
    assert res[0][0] == 7 and res[0][1] == pytest.approx(1.0)
    Q = X[:12] + 0.3 * rng.standard_normal((12, D)).astype(np.float32)
    assert tl.query_asymmetric_batch(Q, top_k=4) == jl.query_asymmetric_batch(Q, top_k=4)
    assert tl.query_asymmetric_batch(Q, top_k=4, where=[1, 2, 3, 50]) == (
        jl.query_asymmetric_batch(Q, top_k=4, where=[1, 2, 3, 50]))
    with pytest.raises(ValueError, match="top_k"):
        tl.query_asymmetric(X[0], top_k=0)
    with pytest.raises(ValueError, match="shape"):
        tl.query_asymmetric_batch(X[:, :8], top_k=3)
    assert tl.stats()["counters"]["queries_served"] == jl.stats()["counters"]["queries_served"]


def test_query_asymmetric_requires_hamming_and_planes(rng):
    X = rng.standard_normal((10, D)).astype(np.float32)
    for kw, match in ((dict(engine="collision", enable_hamming=False), "enable_hamming"),
                      (dict(hamming_storage="packed"), "planes")):
        _, tl = _lsh_pair(**kw)
        tl.index(np.arange(10), X)
        with pytest.raises(RuntimeError, match=match):
            tl.query_asymmetric(np.ones(D, np.float32))
    _, tl = _lsh_pair()
    assert tl.query_asymmetric(np.ones(D, np.float32)) == []


@pytest.mark.parametrize("coords_wire", ["int8", "int4"])
def test_serving_fn_asymmetric_matches_reference(coords_wire, rng):
    jl, tl = _lsh_pair()
    X = rng.standard_normal((240, D)).astype(np.float32)
    jl.index(np.arange(240), X)
    tl.index(np.arange(240), X)
    serve = tl.serving_fn(top_k=5, mode="asymmetric", coords_wire=coords_wire)
    got = serve(X[:16])
    assert got.shape == (16, 5) and got.dtype == np.int32
    assert got[:, 0].tolist() == list(range(16))
    want = np.asarray(jl.serving_fn(top_k=5, mode="asymmetric", coords_wire=coords_wire)(X[:16]))
    np.testing.assert_array_equal(got, want)
    Q = X[:16] + 0.4 * rng.standard_normal((16, D)).astype(np.float32)
    np.testing.assert_array_equal(
        serve(Q), np.asarray(jl.serving_fn(top_k=5, mode="asymmetric",
                                           coords_wire=coords_wire)(Q)))
    if coords_wire == "int8":
        assert [row[:5] for row in serve(Q).tolist()] == [
            [i for i, _ in r] for r in tl.query_asymmetric_batch(Q, top_k=5)]
    served = tl.stats()["counters"]["queries_served"]
    tl.index([500], rng.standard_normal((1, D)).astype(np.float32))
    with pytest.raises(RuntimeError, match="stale"):
        serve(X[:2])
    assert tl.stats()["counters"]["queries_served"] == served
    with pytest.raises(ValueError, match="coords_wire"):
        tl.serving_fn(top_k=5, mode="asymmetric", coords_wire="int2")


def test_asymmetric_recall_dominates_symmetric(rng):
    """Keeping the query's coordinates beats sign-sign Hamming on recall@10
    (clustered data, exact-cosine truth), in both packages alike."""
    b, r, d = 4, 16, 32
    centers = rng.standard_normal((40, d)).astype(np.float32) * 2.0
    base = np.concatenate([c + rng.standard_normal((50, d)).astype(np.float32) for c in centers])
    n = len(base)
    queries = base[rng.permutation(n)[:64]] + 0.3 * rng.standard_normal((64, d)).astype(np.float32)
    bn = base / np.linalg.norm(base, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    gt = np.argsort(-(qn @ bn.T), axis=1)[:, :10]
    jl, tl = _lsh_pair(dim=d, num_perm=b * r, num_bands=b, rows_per_band=r,
                       initial_capacity=2048)
    jl.index(np.arange(n), base)
    tl.index(np.arange(n), base)
    ham = tl.query_hamming_batch(queries, top_k=10)
    asym = tl.query_asymmetric_batch(queries, top_k=10)
    assert asym == jl.query_asymmetric_batch(queries, top_k=10)

    def recall(rows):
        return sum(len({i for i, _ in row} & set(gt[q].tolist())) for q, row in enumerate(rows)) / gt.size

    assert recall(asym) > recall(ham), (recall(asym), recall(ham))
