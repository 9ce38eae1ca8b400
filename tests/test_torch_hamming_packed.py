"""Packed-words Hamming (kernel B3): the port against the JAX package.

Kernel B3's plain version is held to the JAX Pallas kernel in interpret
mode, the packed top-k core to the JAX core, and the port's packed store
to its planes store and to the JAX packed store, on the same signature
words. Every comparison is exact: outputs are integer keys, distances and
ids. The Pallas kernel groups slots strided within a chunk; its inputs
are permuted so that its group ``g`` holds the port's contiguous group
``g`` (as in ``tests/test_torch_group_max.py``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.ops import hamming as jham
from lshrs_tpu.ops import pallas_scan as jps
from lshrs_tpu.ops import scan as jscan
from lshrs_tpu.ops.bitpack import narrow_refine_r
from lshrs_tpu.ops.bitpack import pack_words_narrow as j_pack_narrow
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.ops import _build
from lshrs_tpu_torch.ops import group_max as gm
from lshrs_tpu_torch.ops import hamming as tham
from lshrs_tpu_torch.ops import scan as tscan
from lshrs_tpu_torch.ops.bitpack import pack_bits_to_words
from lshrs_tpu_torch.ops.bitpack import pack_words_narrow as t_pack_narrow
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore

C, CHUNK, Q_TILE = 1024, 256, 8


def _strided(a: np.ndarray, axis: int, group: int) -> np.ndarray:
    """Permute the slot axis so Pallas group g holds contiguous group g."""
    s = np.arange(a.shape[axis])
    g, i = s // group, s % group
    ngc = CHUNK // group
    pos = (g // ngc) * CHUNK + (g % ngc) + i * ngc
    out = np.empty_like(a)
    idx = [slice(None)] * a.ndim
    idx[axis] = pos
    out[tuple(idx)] = a
    return out


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))  # a writable copy


def _case(rng, num_bands, rows, q, dim=16, n=700):
    """Host-hashed store (10% of the live rows tombstoned) and
    near-duplicate queries."""
    h = LSHHasher(num_bands=num_bands, rows_per_band=rows, dim=dim, seed=7)
    X = rng.standard_normal((n, dim)).astype(np.float32)
    sig_rows = np.zeros((C, h.words_per_band * num_bands), np.uint32)
    sig_rows[:n] = h.hash_batch_words_host(X)
    ids = np.full(C, -1, np.int32)
    ids[:n] = rng.permutation(50_000)[:n]
    ids[:n][rng.random(n) < 0.1] = -1
    qx = X[rng.integers(0, n, q)] + 0.3 * rng.standard_normal((q, dim)).astype(np.float32)
    return sig_rows, ids, h.hash_batch_words_host(qx)


# (num_bands, rows): BW 8 at one word per band, BW 8 at two words per band
# (r=40), BW 16 (the 16 x 16 main path).
@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("q", [16, 13])  # 13: ragged, padded for Pallas
@pytest.mark.parametrize("num_bands,rows", [(8, 8), (4, 40), (16, 16)])
def test_packed_group_max_ref_matches_pallas(num_bands, rows, q, group, rng):
    sig_rows, ids, qwords = _case(rng, num_bands, rows, q)
    p = num_bands * rows
    tie = np.asarray(jscan.compute_global_tie(jnp.asarray(ids)))
    scale = gm.key_scale(C)
    sig_t = np.ascontiguousarray(sig_rows.T)

    got = gm.hamming_packed_group_max_keys_ref(
        _t(sig_t), _t(tie), _t(qwords), num_perm=p, group=group, scale=scale
    ).numpy()

    q_pad = -(-q // Q_TILE) * Q_TILE
    qw_pad = np.zeros((q_pad, qwords.shape[1]), np.uint32)
    qw_pad[:q] = qwords
    pallas = np.asarray(
        jps.hamming_packed_group_max_keys(
            jnp.asarray(_strided(sig_t, 1, group)), jnp.asarray(_strided(tie, 0, group)),
            jnp.asarray(qw_pad), num_perm=p, group=group, chunk=CHUNK,
            q_tile=Q_TILE, scale=scale, interpret=True,
        )
    )[:q]
    np.testing.assert_array_equal(got, pallas)
    alive = (tie.reshape(-1, group) >= 0).any(-1)
    assert (got[:, ~alive] <= 0).all() and (got[:, alive] >= scale).all()
    # Masked to the low rows_per_band bits of each word (what the store
    # passes where a band is one word): the same keys, the store's words
    # carry nothing above them.
    masked = gm.hamming_packed_group_max_keys_ref(
        _t(sig_t), _t(tie), _t(qwords), num_perm=p, group=group, scale=scale,
        word_bits=min(rows, 32),
    ).numpy()
    np.testing.assert_array_equal(masked, pallas)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("num_bands,rows,k,narrow", [
    (4, 16, 10, False), (4, 16, 10, True), (16, 16, 7, True), (2, 40, 10, False),
    (4, 16, 1100, True),  # k past the candidate pool: padded
])
def test_packed_core_matches_jax(num_bands, rows, k, narrow, use_pallas, rng):
    group = 64
    narrow_r = narrow_refine_r(rows) if narrow else 0
    sig_rows, ids, qwords = _case(rng, num_bands, rows, 12)
    p = num_bands * rows

    tie_j = jscan.compute_global_tie(jnp.asarray(ids))
    words_j = jnp.asarray(sig_rows)
    if narrow_r:
        words_j = j_pack_narrow(words_j, num_bands=num_bands, rows_per_band=narrow_r)
    ext_j = jnp.concatenate([
        words_j,
        jax.lax.bitcast_convert_type(tie_j, jnp.uint32)[:, None],
        jax.lax.bitcast_convert_type(jnp.asarray(ids), jnp.uint32)[:, None],
    ], axis=1)
    j_ham, j_ids = jham.hamming_topk_packed(
        jnp.asarray(np.ascontiguousarray(sig_rows.T)), jnp.asarray(ids), tie_j,
        jnp.asarray(qwords),
        num_perm=p, k=k, chunk=CHUNK, group=group, use_pallas=use_pallas,
        q_tile=Q_TILE, interpret=use_pallas,
        sig_rows=jscan.build_grouped_refine_rows(
            ext_j, group=group, strided_chunk=CHUNK if use_pallas else None
        ),
        narrow_r=narrow_r,
    )

    words_t = _t(sig_rows)
    tie_t = tscan.global_tie_core(torch.from_numpy(ids))
    refine = words_t
    if narrow_r:
        refine = t_pack_narrow(words_t, num_bands=num_bands, rows_per_band=narrow_r)
    ext_t = torch.cat([refine, tie_t[:, None], torch.from_numpy(ids)[:, None]], dim=1)
    t_ham, t_ids = tham.hamming_topk_packed_core(
        words_t.T.contiguous(), tie_t, _t(qwords),
        tscan.build_grouped_refine_rows(ext_t, group=group),
        num_perm=p, k=k, group=group, narrow_r=narrow_r,
    )
    np.testing.assert_array_equal(t_ham.numpy(), np.asarray(j_ham))
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    assert (t_ids.numpy()[:, 0] >= 0).all()

    # The same top-k through the bitplane core (kernel B2's plain version).
    kw = dict(num_bands=num_bands, rows_per_band=rows)
    b_ham, b_ids = tham.hamming_topk_core(
        tham.unpack_bitplanes(words_t, **kw), tie_t,
        tham.unpack_bitplanes(_t(qwords), **kw), _t(qwords),
        tscan.build_grouped_refine_rows(ext_t, group=group),
        k=k, group=group, narrow_r=narrow_r,
    )
    assert torch.equal(b_ham, t_ham) and torch.equal(b_ids, t_ids)


def _store_words(rng, num_bands, rows, n):
    """Words as the store packs them: ``rows`` random bits per band, the
    bits above them zero."""
    bits = torch.from_numpy(rng.integers(0, 2, (n, num_bands * rows)).astype(np.int32))
    return pack_bits_to_words(bits, num_bands=num_bands, rows_per_band=rows)


@pytest.mark.parametrize("num_bands,rows", [(8, 8), (16, 16), (32, 8), (10, 3)])
def test_packed_operand_equals_unpack_bitplanes(num_bands, rows, rng):
    """One word per band, word_bits = rows_per_band: kernel B3's operand
    columns are the store's bitplanes, padded alike to whole 32 columns."""
    words = _store_words(rng, num_bands, rows, 50)
    width = tham.plane_width(num_bands * rows)
    got = gm.packed_operand(words, word_bits=rows)
    assert got.dtype == torch.int8 and got.shape == (50, width)
    assert gm.packed_width(num_bands, rows) == width
    want = tham.unpack_bitplanes(words, num_bands=num_bands, rows_per_band=rows, width=width)
    assert torch.equal(got, want)
    # Random full words at 32 bits: bit b of word w in column 32 w + b.
    full = torch.from_numpy(rng.integers(-(2**31), 2**31, (7, 3), dtype=np.int64).astype(np.int32))
    op = gm.packed_operand(full).numpy()
    bits = (full.numpy().view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(op, (2 * bits.astype(np.int8) - 1).reshape(7, 96))
    with pytest.raises(ValueError, match="width"):
        gm.packed_operand(words, word_bits=rows, width=num_bands * rows - 1)


# (kind, BW, word_bits, num_perm): random full words (num_perm = 32 * BW),
# the store's words at word_bits = rows_per_band (4 x 40: two words per
# band, so 32), and 16 x 16 words at the default 32 bits (offset 0).
@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("kind,num_bands,rows,word_bits", [
    ("full", 16, 32, 32), ("full", 12, 32, 32),
    ("store", 8, 8, 8), ("store", 16, 16, 16), ("store", 32, 8, 8),
    ("store", 4, 40, 32), ("store", 10, 3, 3), ("store", 16, 16, 32),
])
def test_b2_plain_on_packed_operands_equals_b3_plain(kind, num_bands, rows, word_bits, group, rng):
    """The CUDA kernel B3 is B2's pipeline on +-1 expansions of the packed
    words: with n = BW * word_bits columns, dot = n - 2 * ham, so B2's key
    at offset 2P - n, shift 1 and dead bias -P * scale is B3's key, bit
    for bit, alive and dead slots alike."""
    c, q = 1024, 21
    if kind == "full":
        bw = num_bands
        p = 32 * bw
        sig = torch.from_numpy(rng.integers(-(2**31), 2**31, (c, bw), dtype=np.int64).astype(np.int32))
        qw = torch.from_numpy(rng.integers(-(2**31), 2**31, (q, bw), dtype=np.int64).astype(np.int32))
    else:
        p = num_bands * rows
        sig = _store_words(rng, num_bands, rows, c)
        qw = _store_words(rng, num_bands, rows, q)
        bw = sig.shape[1]
    qw[: q // 2] = sig[rng.integers(0, c, q // 2)]  # stored slots: small distances
    qw[: q // 4] ^= torch.from_numpy((rng.random((q // 4, bw)) < 0.3).astype(np.int32) << 2)
    ids = rng.permutation(c).astype(np.int32)
    ids[rng.random(c) < 0.2] = -1
    ids[256:512] = -1  # whole dead groups
    tie = tscan.global_tie_core(torch.from_numpy(ids))
    scale = gm.key_scale(c)
    want = gm.hamming_packed_group_max_keys_ref(
        sig.T.contiguous(), tie, qw, num_perm=p, group=group, scale=scale, word_bits=word_bits)
    n = bw * word_bits
    got = gm.hamming_group_max_keys_ref(
        gm.packed_operand(sig, word_bits=word_bits), tie, gm.packed_operand(qw, word_bits=word_bits),
        group=group, scale=scale, offset=2 * p - n, shift=1, dead_bias=-p * scale)
    assert torch.equal(got, want)
    dead = (tie.reshape(-1, group) < 0).all(-1)
    assert dead.any() and (~dead).any()
    assert (want[:, dead] <= 0).all() and (want[:, ~dead] >= scale).all()


@pytest.mark.parametrize("hash_mode", ["device", "host"])
@pytest.mark.parametrize("num_bands,rows", [(8, 8), (16, 16), (4, 40), (10, 3)])
def test_packed_store_words_carry_no_bit_above_rows_per_band(num_bands, rows, hash_mode, rng):
    """Kernel B3 expands only the low min(rows_per_band, 32) bits of each
    word: a packed store's words hold nothing above a band's rows."""
    lsh = TorchLSHRS(dim=24, num_perm=num_bands * rows, num_bands=num_bands, rows_per_band=rows,
                     hash_mode=hash_mode, engine="hamming", hamming_storage="packed", seed=4,
                     device="cpu")
    lsh.index(np.arange(300), rng.standard_normal((300, 24)).astype(np.float32))
    store = lsh._storage
    words = store._sig_t[:, :300].numpy().view(np.uint32)  # (BW, n)
    per_band = words.reshape(num_bands, -1, 300)
    top = rows - 32 * (per_band.shape[1] - 1)  # bits used in a band's last word
    assert top == 32 or (per_band[:, -1] >> np.uint32(top) == 0).all()
    assert store._packed_word_bits() == min(rows, 32)
    assert (words != 0).any()


def test_packed_serving_passes_word_bits_and_builds_no_planes(monkeypatch, rng):
    """Serving a packed index: B3 gets word_bits = rows_per_band, the ids
    equal the planes index's, and no bitplane array is ever built."""
    seen = []
    real = tham.hamming_packed_group_max_keys

    def spy(*args, **kw):
        seen.append(kw["word_bits"])
        return real(*args, **kw)

    monkeypatch.setattr(tham, "hamming_packed_group_max_keys", spy)
    kw = dict(dim=24, num_perm=128, num_bands=16, rows_per_band=8, hash_mode="host", seed=9,
              engine="hamming", initial_capacity=512, device="cpu")
    packed = TorchLSHRS(hamming_storage="packed", **kw)
    planes = TorchLSHRS(hamming_storage="planes", **kw)
    X = rng.standard_normal((500, 24)).astype(np.float32)
    for lsh in (packed, planes):
        lsh.index(np.arange(500), X)
    Q = X[:40] + 0.3 * rng.standard_normal((40, 24)).astype(np.float32)
    out = packed.serving_fn(top_k=10)(Q)
    np.testing.assert_array_equal(out, planes.serving_fn(top_k=10)(Q))
    assert packed.query_hamming_batch(Q, top_k=5) == planes.query_hamming_batch(Q, top_k=5)
    packed.delete([1, 2, 3])
    packed.serving_fn(top_k=10)(Q)
    assert seen and set(seen) == {8}
    assert packed._storage._planes is None
    assert packed.stats()["index"]["hamming_plane_bytes"] == 0
    assert planes._storage._planes is not None


NB, R, DIM = 4, 8, 32
STORE_KW = dict(num_bands=NB, rows_per_band=R, dim=DIM, chunk_size=128,
                initial_capacity=512, enable_hamming=True)


@pytest.mark.parametrize("wire", ["words", "dense"])
def test_packed_store_matches_planes_and_jax(wire, rng):
    """Port packed == port planes == JAX packed (cf. tests/test_hamming.py
    test_packed_hamming_matches_planes)."""
    h = LSHHasher(num_bands=NB, rows_per_band=R, dim=DIM, seed=3)
    stores = {
        "jax": JaxStore(hamming_storage="packed", **STORE_KW),
        "planes": TorchStore(hamming_storage="planes", device="cpu", **STORE_KW),
        "packed": TorchStore(hamming_storage="packed", device="cpu", **STORE_KW),
    }
    X = rng.standard_normal((300, DIM)).astype(np.float32)
    ids = rng.permutation(10_000)[:300]
    words = h.hash_batch_words_host(X)
    for s in stores.values():
        s.add_signature_batch(ids, words)

    qx = np.concatenate([X[:5], rng.standard_normal((6, DIM)).astype(np.float32)])
    qw = h.hash_batch_words_host(qx)
    want_h, want_i = stores["jax"].query_hamming(qw, 9)
    for name in ("planes", "packed"):
        got_h, got_i = stores[name].query_hamming(qw, 9)
        np.testing.assert_array_equal(got_h, want_h, err_msg=name)
        np.testing.assert_array_equal(got_i, want_i, err_msg=name)
    np.testing.assert_array_equal(want_i[:5, 0], ids[:5])

    q = qw if wire == "words" else h.hash_batch_dense_host(qx)
    want = np.asarray(stores["jax"].snapshot_query_fn(5, wire=wire, mode="hamming")(q))
    for name in ("planes", "packed"):
        got = stores[name].snapshot_query_fn(5, wire=wire, mode="hamming")(q)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)

    assert stores["planes"].stats()["hamming_plane_bytes"] > 0
    assert stores["packed"].stats()["hamming_plane_bytes"] == 0
    assert stores["packed"].stats()["hamming_storage"] == "packed"


def test_packed_store_never_allocates_planes(rng):
    h = LSHHasher(num_bands=NB, rows_per_band=R, dim=DIM, seed=5)
    ts = TorchStore(hamming_storage="packed", device="cpu", **{**STORE_KW, "initial_capacity": 128})
    X = rng.standard_normal((400, DIM)).astype(np.float32)
    words = h.hash_batch_words_host(X)
    ts.add_signature_batch(np.arange(100), words[:100])
    ts.query_hamming(words[:3], 4)  # query
    ts.add_signature_batch(np.arange(100, 400), words[100:])  # append + growth
    ts.add_signature_batch(np.arange(10), words[200:210])  # overwrite
    ts.snapshot_query_fn(4, mode="hamming")(words[:3])
    ts.remove_indices([5])
    ts.compact()
    ts.query_hamming(words[:3], 4)
    assert ts._planes is None and ts._capacity == 1024
    assert ts.stats()["hamming_plane_bytes"] == 0


def test_invalid_hamming_storage_raises():
    with pytest.raises(ValueError, match="hamming_storage"):
        TorchStore(hamming_storage="sparse", device="cpu", **STORE_KW)
    with pytest.raises(ValueError, match="hamming_storage"):
        TorchLSHRS(dim=8, num_perm=16, num_bands=4, rows_per_band=4,
                   hamming_storage="bits", device="cpu")


@pytest.mark.parametrize("engine,storage", [
    ("collision", "packed"),  # with enable_hamming=True
    ("auto", "packed"),       # explicit "packed" survives the engine override
    ("hamming", None),        # None means planes
])
def test_lshrs_query_hamming_matches_reference(engine, storage, rng):
    kw = dict(dim=24, num_perm=64, num_bands=8, rows_per_band=8, hash_mode="host",
              seed=11, chunk_size=128, initial_capacity=128, engine=engine,
              enable_hamming=True, hamming_storage=storage)
    jl, tl = JaxLSHRS(**kw), TorchLSHRS(device="cpu", **kw)
    X = rng.standard_normal((600, 24)).astype(np.float32)
    jl.index(list(range(600)), X)
    tl.index(list(range(600)), X)
    Q = X[:20] + 0.3 * rng.standard_normal((20, 24)).astype(np.float32)
    for i in (0, 3, 11):
        assert tl.query_hamming(Q[i], top_k=6) == jl.query_hamming(Q[i], top_k=6)
    assert tl.query_hamming_batch(Q, top_k=5) == jl.query_hamming_batch(Q, top_k=5)
    assert tl.query_hamming_batch(X[:8], top_k=1) == [[(i, 1.0)] for i in range(8)]
    jl.query_hamming_batch(X[:8], top_k=1)
    ts, js = tl.stats(), jl.stats()
    assert ts["index"]["hamming_storage"] == js["index"]["hamming_storage"]
    assert ts["index"]["hamming_storage"] == (storage or "planes")
    assert ts["ranking"] == js["ranking"]
    assert ts["counters"] == js["counters"]
    with pytest.raises(ValueError, match="top_k"):
        tl.query_hamming_batch(Q, top_k=0)


def test_query_hamming_needs_hamming_enabled(rng):
    tl = TorchLSHRS(dim=8, num_perm=16, num_bands=4, rows_per_band=4,
                    engine="collision", device="cpu")
    x = rng.standard_normal((2, 8)).astype(np.float32)
    tl.index([0, 1], x)
    with pytest.raises(RuntimeError, match="enable_hamming"):
        tl.query_hamming(x[0])


def test_cpu_wrapper_takes_the_plain_version(rng, monkeypatch):
    def no_build():
        raise AssertionError("a CPU call must not build or launch a kernel")

    monkeypatch.setattr(_build, "library", no_build)
    sig_rows, ids, qwords = _case(rng, 16, 16, 9)
    tie = tscan.global_tie_core(torch.from_numpy(ids))
    args = (_t(np.ascontiguousarray(sig_rows.T)), tie, _t(qwords))
    kw = dict(num_perm=256, group=64, scale=gm.key_scale(C))
    before = gm.hamming_packed_group_max_keys.launches
    got = gm.hamming_packed_group_max_keys(*args, **kw)
    assert torch.equal(got, gm.hamming_packed_group_max_keys_ref(*args, **kw))
    assert gm.hamming_packed_group_max_keys.launches == before


def test_packed_wrapper_rejects_other_devices_and_bad_inputs():
    sig = torch.zeros((4, 256), dtype=torch.int32)
    tie = torch.zeros((256,), dtype=torch.int32)
    qw = torch.zeros((3, 4), dtype=torch.int32)
    kw = dict(num_perm=64, group=64, scale=256)
    with pytest.raises(ValueError, match="unsupported device"):
        gm.hamming_packed_group_max_keys(sig.to("meta"), tie.to("meta"), qw.to("meta"), **kw)
    with pytest.raises(TypeError):
        gm.hamming_packed_group_max_keys(sig.float(), tie, qw, **kw)
    with pytest.raises(ValueError, match="shape"):
        gm.hamming_packed_group_max_keys(sig, tie, qw[:, :3], **kw)
    with pytest.raises(ValueError, match="group"):
        gm.hamming_packed_group_max_keys(sig, tie, qw, **{**kw, "group": 48})
    with pytest.raises(ValueError, match="int32"):
        gm.hamming_packed_group_max_keys(sig, tie, qw, **{**kw, "scale": 1 << 25})
    for word_bits in (0, 33):
        with pytest.raises(ValueError, match="word_bits"):
            gm.hamming_packed_group_max_keys(sig, tie, qw, **kw, word_bits=word_bits)


def test_packed_store_past_the_int32_key_ceiling_raises(monkeypatch, rng):
    """Past (P + 2) * S >= 2**31 (more than 2**22 slots at 256 bits) both
    storages used to raise; they now rank through the chunked fallbacks
    (packed words, bitplanes) == the reference's on the same words, and
    the single-pass engine's selection still refuses int32-overflowing
    keys."""
    import lshrs_tpu.storage.device as jdevice_mod
    import lshrs_tpu_torch.storage.device as device_mod

    words = rng.integers(0, 2**R, (60, NB), dtype=np.uint32)
    qw = np.concatenate([words[:3], rng.integers(0, 2**R, (3, NB), dtype=np.uint32)])
    stores = []
    for storage in ("packed", "planes"):
        ts = TorchStore(hamming_storage=storage, device="cpu", **STORE_KW)
        js = JaxStore(hamming_storage=storage, **STORE_KW)
        for s in (ts, js):
            s.add_signature_batch(np.arange(60) * 3, words)
        stores.append((ts, js))
    for mod in (device_mod, jdevice_mod):
        monkeypatch.setattr(mod, "supports_hamming_grouped", lambda *a: False)
    answers = []
    for ts, js in stores:
        got, want = ts.query_hamming(qw, 7), js.query_hamming(qw, 7)
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
        assert ts._ranks is not None and ts._refine is None  # the chunked route
        answers.append(got)
    np.testing.assert_array_equal(answers[0][1], answers[1][1])
    with pytest.raises(NotImplementedError, match="int32"):
        tham._select_refine(
            torch.zeros((1, 1 << 17), dtype=torch.int32), torch.zeros((1, 8), dtype=torch.int32),
            None, p=256, k=3, group=64,
        )
    assert not tham.supports_hamming_grouped(256, 1 << 23)
    assert tham.supports_hamming_grouped(256, 1 << 22)
