"""`LSHRS.retrain` (an ITQ fit on the resident payload, then the learned
family) and `DeviceStore.sample_payload_rows`: the port against
`lshrs_tpu`.

Mirrors `tests/test_itq.py`'s orchestrator cases (less the sharded one,
ROADMAP Queue A item 7): rebuild exactness, explicit samples and the cap,
ingest after a retrain, persistence and pickling, staleness, re-banding
the learned matrix, MIPS augmentation of the sample, validation and the
payload sampler. Then parity: the sampled rows equal the reference's
(exactly for float32 and bf16 payloads; dequantised int8 rows within two
float32 ulps, as the reference's fused build may round a row's scale one
ulp apart), the projection retrain installs equals the reference's ITQ fit
of the same sample within the tolerance of
`tests/test_torch_hasher_families.py::test_itq_fit_matches` (host LAPACK
on both sides; the fit amplifies an ulp of its input, so each package's
own sample is fed to the reference's fit), and a retrained index of either
package answers the same ids after a checkpoint crosses to the other.
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.itq import fit_itq_projection as jax_fit
from lshrs_tpu_torch import LSHRS


def _lowrank_data(rng, n, dim, rank=6, noise=0.05):
    """Anisotropic unit vectors: a few signal directions + isotropic noise."""
    basis = rng.standard_normal((rank, dim)).astype(np.float32)
    z = rng.standard_normal((n, rank)).astype(np.float32)
    x = z @ basis + noise * rng.standard_normal((n, dim)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


BASE = dict(num_perm=16, num_bands=4, rows_per_band=4, store_vectors=True, seed=42,
            chunk_size=128, initial_capacity=128)


def _device_lsh(rng, n=300, dim=32, **kw):
    lsh = LSHRS(dim=dim, device="cpu", **{**BASE, **kw})
    X = _lowrank_data(rng, n, dim)
    lsh.index(list(range(n)), X)
    return lsh, X


# -- mirrors of tests/test_itq.py ------------------------------------------


def test_retrain_end_to_end(rng):
    lsh, X = _device_lsh(rng)
    info = lsh.retrain(iters=16)
    assert info["fitted_bits"] == 16 and info["padded_bits"] == 0
    assert lsh._tpu_config["hash_family"] == "learned"
    assert lsh._hasher.hash_family == "learned"
    idx, count = lsh._ordered_candidates(X[9])[0]
    assert idx == 9 and count == 4
    res = lsh.get_above_p(X[17], p=0.1)
    assert res[0][0] == 17 and res[0][1] > 0.9999


def test_retrain_explicit_sample_and_cap(rng):
    lsh, X = _device_lsh(rng)
    info = lsh.retrain(sample=X[:100], iters=8, sample_cap=64)
    assert info["sample_rows"] == 64  # capped, strided
    assert lsh.get_top_k(X[3], topk=1)[0] == 3


def test_retrain_then_ingest_uses_learned_family(rng):
    lsh, _ = _device_lsh(rng)
    lsh.retrain(iters=8)
    extra = _lowrank_data(rng, 50, 32)
    lsh.index(list(range(1000, 1050)), extra)
    idx, count = lsh._ordered_candidates(extra[7])[0]
    assert idx == 1007 and count == 4


def test_retrain_persistence_and_pickle(rng, tmp_path):
    lsh, X = _device_lsh(rng)
    lsh.retrain(iters=8)
    before = lsh.get_above_p(X[4], p=0.5)
    proj = lsh._hasher.projection_matrix.copy()
    lsh.save_to_disk(tmp_path / "idx")
    re = LSHRS.load_from_disk(tmp_path / "idx", device="cpu")
    assert re._hasher.hash_family == "learned"
    np.testing.assert_array_equal(re._hasher.projection_matrix, proj)
    assert [i for i, _ in re.get_above_p(X[4], p=0.5)] == [i for i, _ in before]
    pk = pickle.loads(pickle.dumps(lsh))
    assert pk._hasher.hash_family == "learned"
    np.testing.assert_array_equal(pk._hasher.projection_matrix, proj)
    # X[11] collides in every band (the learned bits may give another
    # vector its signature too: ids then tie by id), as before pickling
    assert (11, 4) in pk._ordered_candidates(X[11])
    assert pk.get_top_k(X[11], topk=3) == lsh.get_top_k(X[11], topk=3)


def test_retrain_staleness_guard(rng):
    lsh, X = _device_lsh(rng)
    fn = lsh.serving_fn(1)
    lsh.retrain(iters=4)
    with pytest.raises(RuntimeError, match="stale"):
        fn(X[:4])


def test_rehash_rebands_learned_matrix(rng):
    """Re-banding after retrain carries the learned matrix; changing
    num_perm demands a fresh fit."""
    lsh, X = _device_lsh(rng)
    lsh.retrain(iters=8)
    proj = lsh._hasher.projection_matrix.copy()
    lsh.rehash(num_bands=8, rows_per_band=2)
    assert lsh._hasher.hash_family == "learned"
    np.testing.assert_array_equal(lsh._hasher.projection_matrix, proj)
    idx, count = lsh._ordered_candidates(X[9])[0]
    assert idx == 9 and count == 8
    with pytest.raises(ValueError, match="retrain"):
        lsh.rehash(num_bands=8, rows_per_band=8)


def test_retrain_mips_augments_sample(rng):
    X = _lowrank_data(rng, 300, 16) * 2.0
    lsh = LSHRS(dim=16, store_vectors=True, num_perm=16, num_bands=4, rows_per_band=4,
                similarity="dot", max_norm=4.0, chunk_size=128, initial_capacity=128,
                device="cpu")
    lsh.index(list(range(300)), X)
    info = lsh.retrain(sample=X[:200], iters=8)
    assert lsh._hasher.projection_matrix.shape == (16, 17)  # the dim + 1 geometry
    assert info["fitted_bits"] == 16
    got = lsh.get_above_p(X[5], p=0.05)
    assert got[0][0] == 5
    np.testing.assert_allclose(got[0][1], float(X[5] @ X[5]), rtol=1e-4)


def test_retrain_validation(rng):
    mem = LSHRS(dim=8, num_perm=16, backend="memory", device="cpu")
    with pytest.raises(RuntimeError, match="device backend"):
        mem.retrain()
    no_payload = LSHRS(dim=8, num_perm=16, chunk_size=128, initial_capacity=128, device="cpu")
    with pytest.raises(RuntimeError, match="store_vectors"):
        no_payload.retrain()
    lsh, _ = _device_lsh(rng)
    with pytest.raises(ValueError, match="shape"):
        lsh.retrain(sample=np.ones((10, 7), np.float32))
    empty = LSHRS(dim=8, **BASE, device="cpu")
    with pytest.raises(RuntimeError, match="at least 2"):
        empty.retrain()


def test_sample_payload_rows(rng):
    lsh, X = _device_lsh(rng)
    store = lsh._storage
    rows = store.sample_payload_rows(10_000)  # cap above n: every alive row
    assert rows.shape == X.shape and rows.dtype == np.float32
    np.testing.assert_allclose(rows, X, rtol=1e-6)
    capped = store.sample_payload_rows(64)
    assert capped.shape == (64, 32)
    assert all(np.isclose(X, r[None, :], atol=1e-6).all(axis=1).any() for r in capped)
    lsh.delete([0, 1, 2])
    assert store.sample_payload_rows(10_000).shape[0] == X.shape[0] - 3  # no tombstones
    with pytest.raises(ValueError, match="cap must be > 0"):
        store.sample_payload_rows(0)


def test_sample_payload_rows_int8_dequantized(rng):
    lsh, X = _device_lsh(rng, payload_dtype="int8")
    rows = lsh._storage.sample_payload_rows(10_000)
    np.testing.assert_allclose(rows, X, rtol=0.05, atol=0.02)
    assert lsh.retrain(iters=4)["sample_rows"] == X.shape[0]


def test_sample_payload_rows_requires_payload(rng):
    lsh = LSHRS(dim=16, num_perm=16, num_bands=4, rows_per_band=4, chunk_size=64,
                initial_capacity=64, device="cpu")
    lsh.ingest(1, rng.standard_normal(16).astype(np.float32))
    lsh.flush()
    with pytest.raises(RuntimeError, match="store_vectors=True"):
        lsh._storage.sample_payload_rows(8)


# -- parity with lshrs_tpu --------------------------------------------------


def _pair(rng, n=400, dim=32, **kw):
    X = _lowrank_data(rng, n, dim) * rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
    out = []
    for cls, extra in ((JaxLSHRS, {}), (LSHRS, {"device": "cpu"})):
        lsh = cls(dim=dim, **{**BASE, "initial_capacity": 512, **kw}, **extra)
        lsh.index(list(range(n)), X)
        lsh.delete([3, 10, 11])
        out.append(lsh)
    return (*out, X)


@pytest.mark.parametrize("payload_dtype", ["float32", "int8", "bfloat16"])
@pytest.mark.parametrize("cap", [64, 100_000])
def test_sample_payload_rows_match_the_reference(payload_dtype, cap, rng):
    jl, tl, _ = _pair(rng, payload_dtype=payload_dtype)
    want = jl._storage.sample_payload_rows(cap)
    got = tl._storage.sample_payload_rows(cap)
    assert got.shape == want.shape and got.dtype == np.float32
    if payload_dtype == "int8":  # the row times a scale that may be an ulp apart
        np.testing.assert_allclose(got, want, rtol=2**-22, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [{}, {"payload_dtype": "int8"},
                                {"similarity": "dot", "max_norm": 2.5}])
def test_retrain_matches_the_reference(kw, rng):
    """The port's retrain installs the reference's ITQ fit of the port's
    own payload sample, with the same diagnostics, and updates the
    configuration as the reference's retrain does."""
    jl, tl, X = _pair(rng, **kw)
    sample = tl._storage.sample_payload_rows(256)
    want, wi = jax_fit(sample, 16, iters=16, seed=42, return_info=True)
    jl.retrain(iters=16, sample_cap=256)
    gi = tl.retrain(iters=16, sample_cap=256)
    assert gi.keys() == wi.keys()
    for k in gi:
        np.testing.assert_allclose(gi[k], wi[k], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl._hasher.projection_matrix, want, rtol=1e-5, atol=1e-6)
    if "payload_dtype" not in kw:  # the same sample in both packages
        np.testing.assert_allclose(tl._hasher.projection_matrix,
                                   jl._hasher.projection_matrix, rtol=1e-5, atol=1e-6)
    assert tl._config == jl._config
    assert tl._tpu_config["hash_family"] == jl._tpu_config["hash_family"] == "learned"


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_retrained_checkpoint_crosses_packages(direction, rng, tmp_path):
    """A retrained (then re-banded) index saved by either package loads in
    the other with the same learned matrix, words and answers."""
    jl, tl, X = _pair(rng)
    src = jl if direction == "jax_to_port" else tl
    src.retrain(iters=8)
    src.rehash(num_bands=8, rows_per_band=2)
    src.save_to_disk(tmp_path / "ckpt")
    if direction == "jax_to_port":
        back = LSHRS.load_from_disk(tmp_path / "ckpt", device="cpu")
    else:
        back = JaxLSHRS.load_from_disk(tmp_path / "ckpt")
    assert back._tpu_config["hash_family"] == "learned"
    assert back._config == src._config
    np.testing.assert_array_equal(back._hasher.projection_matrix, src._hasher.projection_matrix)
    want = src.query_batch(X[:40], top_k=5)
    assert back.query_batch(X[:40], top_k=5) == want
    q = pickle.loads(pickle.dumps(src))
    assert q.query_batch(X[:40], top_k=5) == want
