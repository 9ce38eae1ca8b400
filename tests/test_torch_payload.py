"""The resident payload (``store_vectors``): float32, bfloat16 and int8
rows, their norms and scales, kept equal to the JAX package's through
every write path — append, dense wire, fused device build, upsert,
growth, delete, compact — and through checkpoints in both directions.

Payload rows must be equal (``torch.equal``: int8 rounding is half to
even in both packages); norms agree to float32 rounding (sums in another
order) and int8 scales within one ulp.
"""

from __future__ import annotations

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher
from lshrs_tpu.storage.device import DeviceStore as JaxStore
from lshrs_tpu.storage.device import _cast_payload_rows as j_cast
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.storage.device import DeviceStore as TorchStore
from lshrs_tpu_torch.storage.device import _cast_payload_rows as t_cast

PAYLOADS = ["float32", "bfloat16", "int8"]
NB, R, DIM = 8, 8, 48
KW = dict(num_bands=NB, rows_per_band=R, dim=DIM, store_vectors=True, chunk_size=128,
          initial_capacity=128)


def _payload_np(store) -> dict:
    """A store's payload state as float32 NumPy (either package)."""
    out = {"payload": np.asarray(store._payload[: store._size]).astype(np.float32)
           if isinstance(store._payload, jnp.ndarray)
           else store._payload[: store._size].float().numpy(),
           "pnorm": np.asarray(store._pnorm[: store._size]),
           "ids": np.asarray(store._ids[: store._size])}
    if store._pscale is not None:
        out["pscale"] = np.asarray(store._pscale[: store._size])
    return out


def assert_same_payload(js, ts):
    a, b = _payload_np(js), _payload_np(ts)
    assert set(a) == set(b)
    np.testing.assert_array_equal(b["ids"], a["ids"])
    np.testing.assert_array_equal(b["payload"], a["payload"])
    np.testing.assert_allclose(b["pnorm"], a["pnorm"], rtol=1e-6)
    if "pscale" in a:
        np.testing.assert_array_max_ulp(b["pscale"], a["pscale"], maxulp=1)


def test_int8_quantization_matches_the_reference(rng):
    x = rng.standard_normal((64, DIM)).astype(np.float32) * rng.uniform(0.01, 50, (64, 1))
    x = x.astype(np.float32)
    x[0] = 0.0  # zero row: scale 1
    x[1, :5] = [127.0, 0.5, 1.5, 2.5, -0.5]  # scale 1: exact halves round to even
    x[1, 5:] = 0.0
    rows_j, scale_j = j_cast(jnp.asarray(x), jnp.int8)
    rows_t, norm_t, scale_t = t_cast(torch.from_numpy(x), torch.int8)
    assert rows_t.dtype == torch.int8
    assert torch.equal(rows_t, torch.from_numpy(np.array(rows_j)))
    np.testing.assert_array_max_ulp(scale_t.numpy(), np.asarray(scale_j), maxulp=1)
    assert rows_t[1, :5].tolist() == [127, 0, 2, 2, 0] and scale_t[0] == 1.0
    np.testing.assert_allclose(
        norm_t.numpy(), np.linalg.norm(np.asarray(rows_j, np.float32), axis=1), rtol=1e-6)


def test_bfloat16_rows_match_the_reference(rng):
    x = rng.standard_normal((64, DIM)).astype(np.float32)
    rows_j, _ = j_cast(jnp.asarray(x), jnp.bfloat16)
    rows_t, _, scale = t_cast(torch.from_numpy(x), torch.bfloat16)
    assert scale is None
    np.testing.assert_array_equal(rows_t.float().numpy(), np.asarray(rows_j, np.float32))


def _words(h, X, dense):
    return h.hash_batch_dense_host(X) if dense else h.hash_batch_words_host(X)


@pytest.mark.parametrize("payload_dtype", PAYLOADS)
@pytest.mark.parametrize("dense", [False, True])
def test_writes_keep_payload_equal(payload_dtype, dense, rng):
    """Append (growing past the first capacity), upsert with in-batch
    duplicates, delete, compact: the payload state stays the reference's."""
    h = LSHHasher(num_bands=NB, rows_per_band=R, dim=DIM, seed=4)
    js, ts = (cls(payload_dtype=payload_dtype, **kw) for cls, kw in
              ((JaxStore, KW), (TorchStore, dict(KW, device="cpu"))))
    X = rng.standard_normal((300, DIM)).astype(np.float32)
    for store in (js, ts):
        store.add_signature_batch(np.arange(100), _words(h, X[:100], dense), X[:100])
        store.add_signature_batch(np.arange(100, 300), _words(h, X[100:], dense), X[100:])
    assert ts._capacity == js._capacity > 128
    assert_same_payload(js, ts)

    up_ids = np.array([5, 250, 5, 301, 17])  # 5 twice: the last wins; 301 is new
    Y = rng.standard_normal((5, DIM)).astype(np.float32) * 3
    for store in (js, ts):
        store.add_signature_batch(up_ids, _words(h, Y, dense), Y)
    assert_same_payload(js, ts)
    np.testing.assert_array_equal(ts.get_vectors([5, 301, 7]), js.get_vectors([5, 301, 7]))

    for store in (js, ts):
        store.remove_indices([1, 2, 250])
        assert store.compact() == 3
    assert_same_payload(js, ts)
    np.testing.assert_array_equal(ts.get_vectors([0, 5, 299]), js.get_vectors([0, 5, 299]))
    with pytest.raises(KeyError, match="not present"):
        ts.get_vectors([250])


@pytest.mark.parametrize("payload_dtype", PAYLOADS)
def test_fused_device_build_writes_the_payload(payload_dtype, rng):
    X = rng.standard_normal((200, DIM)).astype(np.float32)
    js, ts = JaxStore(payload_dtype=payload_dtype, **KW), TorchStore(
        payload_dtype=payload_dtype, device="cpu", **KW)
    jh = LSHHasher(num_bands=NB, rows_per_band=R, dim=DIM, seed=4)
    proj = np.ascontiguousarray(jh.projection_matrix.T)
    js.add_vectors_batch(np.arange(200), X, jnp.asarray(proj))
    ts.add_vectors_batch(np.arange(200), X, torch.from_numpy(proj))
    ts.add_vectors_batch([3, 3], X[:2], torch.from_numpy(proj))  # the upsert path
    js.add_vectors_batch([3, 3], X[:2], jnp.asarray(proj))
    assert_same_payload(js, ts)


def test_payload_validation_and_stats(rng):
    with pytest.raises(ValueError, match="payload_dtype"):
        TorchStore(payload_dtype="float16", device="cpu", **KW)
    with pytest.raises(ValueError, match="rerank_engine"):
        TorchStore(rerank_engine="nope", device="cpu", **KW)
    with pytest.raises(ValueError, match="rerank_candidates"):
        TorchStore(rerank_candidates=0, device="cpu", **KW)
    ts = TorchStore(device="cpu", **KW)
    words = np.zeros((2, NB), np.uint32)
    with pytest.raises(ValueError, match="vectors are required"):
        ts.add_signature_batch([0, 1], words)
    with pytest.raises(ValueError, match="vectors must have shape"):
        ts.add_signature_batch([0, 1], words, np.ones((2, DIM - 1), np.float32))
    bare = TorchStore(num_bands=NB, rows_per_band=R, dim=DIM, device="cpu")
    with pytest.raises(RuntimeError, match="store_vectors=False"):
        bare.get_vectors([0])
    assert bare.stats()["payload_bytes"] == 0 and bare.stats()["rerank_engine"] is None
    for payload_dtype in PAYLOADS:
        kw = dict(KW, payload_dtype=payload_dtype, rerank_engine="gather")
        t, j = TorchStore(device="cpu", **kw), JaxStore(**kw)
        for key in ("payload_bytes", "rerank_engine", "rerank_truncations"):
            assert t.stats()[key] == j.stats()[key], (payload_dtype, key)


def _lsh_kw(payload_dtype, **kw):
    return dict(dim=DIM, num_perm=64, num_bands=8, rows_per_band=8, hash_mode="host", seed=9,
                chunk_size=128, initial_capacity=128, store_vectors=True,
                payload_dtype=payload_dtype, rerank_engine="gather", rerank_candidates=300,
                **kw)


def _data(rng, n=500):
    c = rng.standard_normal((25, DIM)).astype(np.float32)
    steps = 0.05 * (1 + np.arange(20, dtype=np.float32))
    X = c[:, None] + steps[None, :, None] * rng.standard_normal((25, 20, DIM)).astype(np.float32)
    return X.reshape(n, DIM), c + 0.02 * rng.standard_normal((25, DIM)).astype(np.float32)


def _topp(lsh, Q):
    """Top-6 ``(ids, cosines)`` per query; asserts that no two cosines of
    a row lie within 1e-5 (the ids are then fixed)."""
    out = lsh.get_above_p_batch(Q, p=1.0, top_k=6)
    ids = [[i for i, _ in r] for r in out]
    sims = [[s for _, s in r] for r in out]
    assert all((np.abs(np.diff(row)) > 1e-5).all() for row in sims), "near-tie"
    return ids, sims


@pytest.mark.parametrize("payload_dtype", PAYLOADS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_payload_checkpoints_load_across_packages(payload_dtype, direction, tmp_path, rng):
    X, Q = _data(rng)
    kw = _lsh_kw(payload_dtype)
    src = JaxLSHRS(**kw) if direction == "jax_to_port" else TorchLSHRS(device="cpu", **kw)
    src.index(list(range(len(X))), X)
    src.delete([7, 8])
    want_ids, want_sims = _topp(src, Q)
    src.save_to_disk(tmp_path / "ckpt")
    if direction == "jax_to_port":
        back = TorchLSHRS.load_from_disk(tmp_path / "ckpt", device="cpu")
    else:
        back = JaxLSHRS.load_from_disk(tmp_path / "ckpt")
    got_ids, got_sims = _topp(back, Q)
    assert got_ids == want_ids
    np.testing.assert_allclose(np.concatenate(got_sims), np.concatenate(want_sims), atol=1e-5)
    for key in ("payload_dtype", "rerank_engine", "rerank_candidates", "store_vectors"):
        assert back._tpu_config[key] == src._tpu_config[key]
    assert back._storage.payload_dtype == payload_dtype
    np.testing.assert_array_equal(back._storage.get_vectors([0, 9, 499]),
                                  src._storage.get_vectors([0, 9, 499]))


@pytest.mark.parametrize("payload_dtype", PAYLOADS)
def test_payload_survives_pickle_and_port_checkpoints(payload_dtype, tmp_path, rng):
    X, Q = _data(rng)
    tl = TorchLSHRS(device="cpu", **_lsh_kw(payload_dtype))
    tl.index(list(range(len(X))), X)
    want = _topp(tl, Q)
    tl.save_to_disk(tmp_path / "m")
    for back in (TorchLSHRS.load_from_disk(tmp_path / "m", device="cpu"),
                 pickle.loads(pickle.dumps(tl))):
        assert _topp(back, Q)[0] == want[0]
        assert back._storage.rerank_candidates == 300
        assert back.stats()["index"]["payload_bytes"] == tl.stats()["index"]["payload_bytes"]
