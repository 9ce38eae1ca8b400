"""Persistence: port checkpoints and pickles round-trip, and checkpoints
load across the two packages with the same results.

Queries hash on the host (``hash_mode="host"``), where both packages
compute bit-identical signatures; the index itself comes from the
checkpoint, so both sides rank the same words.
"""

from __future__ import annotations

import json
import pickle

import numpy as np
import pytest

from lshrs_tpu import LSHRS as JaxLSHRS
from lshrs_tpu.hash.hasher import LSHHasher as JaxHasher
from lshrs_tpu_torch import LSHRS as TorchLSHRS
from lshrs_tpu_torch.hash.hasher import LSHHasher as TorchHasher

DIM = 24
BASE = dict(dim=DIM, num_perm=64, num_bands=8, rows_per_band=8, hash_mode="host", seed=21,
            chunk_size=128, initial_capacity=128)


def _data(rng, n=600):
    c = rng.standard_normal((30, DIM)).astype(np.float32)
    X = (c[rng.integers(0, 30, n)] + 0.4 * rng.standard_normal((n, DIM))).astype(np.float32)
    Q = X[:25] + 0.2 * rng.standard_normal((25, DIM)).astype(np.float32)
    return X, Q


def _results(lsh, X, Q) -> dict:
    out = {
        "batch": lsh.query_batch(Q, top_k=6),
        "single": [lsh.query(X[i], top_k=5) for i in (0, 9)],
        "serve": np.asarray(lsh.serving_fn(top_k=7)(Q)).tolist(),
    }
    if lsh.stats()["index"]["hamming_storage"] is not None:
        out["hamming"] = lsh.query_hamming_batch(Q, top_k=4)
    return out


# Restoring drops tombstoned slots (in both packages), so size and
# tombstones are not carried; what is alive, and where, is.
RESTORED_KEYS = ("alive", "capacity", "hamming_storage", "hamming_plane_bytes", "fast_path")


CASES = {
    "collision": dict(engine="collision"),
    "packed": dict(engine="hamming", hamming_storage="packed"),
    # engine="auto" past the switch: the resolution is pinned and persisted.
    "auto_pinned": dict(engine="auto", hamming_storage="packed", initial_capacity=1 << 19),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_checkpoint_round_trips(case, tmp_path, rng):
    tl = TorchLSHRS(device="cpu", **{**BASE, **CASES[case]})
    X, Q = _data(rng)
    tl.index(list(range(len(X))), X)
    tl.delete([3, 4, 5])
    want = _results(tl, X, Q)
    tl.save_to_disk(tmp_path / "ckpt")
    meta = json.loads((tmp_path / "ckpt" / "metadata.json").read_text())
    assert meta["version"] == "0.1.0"
    assert set(meta) == {"version", "config", "redis_config", "tpu_config"}

    back = TorchLSHRS.load_from_disk(tmp_path / "ckpt", device="cpu")
    assert _results(back, X, Q) == want
    assert back.stats()["engine_resolved"] == tl.stats()["engine_resolved"]
    assert back._storage.hamming_storage == tl._storage.hamming_storage
    if case == "auto_pinned":
        assert back.stats()["engine_resolved"] == "hamming"
    if tl._storage.hamming_storage == "packed":
        assert back._storage._planes is None
    np.testing.assert_array_equal(back._hasher.projection_matrix, tl._hasher.projection_matrix)

    clone = pickle.loads(pickle.dumps(tl))
    assert _results(clone, X, Q) == want
    assert clone.stats()["engine_resolved"] == tl.stats()["engine_resolved"]
    for key in RESTORED_KEYS:
        assert clone.stats()["index"][key] == tl.stats()["index"][key], key


def test_pinned_engine_survives_a_smaller_restored_store(tmp_path, rng):
    """A restore into a store below the auto switch keeps Hamming ranking."""
    tl = TorchLSHRS(device="cpu", **{**BASE, "initial_capacity": 1 << 19})
    X, Q = _data(rng, 200)
    tl.index(list(range(200)), X)
    want = tl.query_batch(Q, top_k=5)
    assert tl.stats()["engine_resolved"] == "hamming"
    tl.save_to_disk(tmp_path / "m")
    meta = json.loads((tmp_path / "m" / "metadata.json").read_text())
    meta["tpu_config"]["initial_capacity"] = 128
    (tmp_path / "m" / "metadata.json").write_text(json.dumps(meta))
    back = TorchLSHRS.load_from_disk(tmp_path / "m", device="cpu")
    assert back.stats()["index"]["capacity"] < TorchLSHRS._AUTO_HAMMING_CAPACITY
    assert back.stats()["ranking"] == "hamming"
    assert back.query_batch(Q, top_k=5) == want


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_load_across_packages(direction, case, tmp_path, rng):
    kw = {**BASE, **CASES[case]}
    X, Q = _data(rng)
    src = JaxLSHRS(**kw) if direction == "jax_to_port" else TorchLSHRS(device="cpu", **kw)
    src.index(list(range(len(X))), X)
    src.delete([10, 11])
    want = _results(src, X, Q)
    src.save_to_disk(tmp_path / "ckpt")
    if direction == "jax_to_port":
        back = TorchLSHRS.load_from_disk(tmp_path / "ckpt", device="cpu")
    else:
        back = JaxLSHRS.load_from_disk(tmp_path / "ckpt")
    assert _results(back, X, Q) == want
    assert back.stats()["engine_resolved"] == src.stats()["engine_resolved"]
    for key in RESTORED_KEYS:
        assert back.stats()["index"][key] == src.stats()["index"][key], key


# What an edited checkpoint must do on load. Capabilities the port lacks
# raise NotImplementedError. A hash family swapped in by hand names a file
# the checkpoint does not hold (diagonals.npz): FileNotFoundError, never a
# silent gaussian index (cross-polytope at this banding already fails its
# geometry check: ValueError). A multi-probe depth restores as it is.
@pytest.mark.parametrize("where,change", [
    ("tpu_config", {"hash_family": "crosspolytope"}),
    ("tpu_config", {"shards": 2}),
    ("tpu_config", {"hash_family": "structured"}),
    ("tpu_config", {"multiprobe": 2}),
    ("tpu_config", {"query_mode": "bucket"}),
    ("tpu_config", {"hamming_cascade": 32}),
    ("tpu_config", {"backend": "memory"}),
    ("config", {"similarity": "dot", "max_norm": 5.0}),
])
def test_unsupported_checkpoint_capabilities_raise(where, change, tmp_path, rng):
    tl = TorchLSHRS(device="cpu", **BASE)
    X, _ = _data(rng, 50)
    tl.index(list(range(50)), X)
    tl.save_to_disk(tmp_path / "m")
    path = tmp_path / "m" / "metadata.json"
    meta = json.loads(path.read_text())
    meta[where].update(change)
    if change.get("hash_family") == "crosspolytope":
        meta["tpu_config"].update(engine="collision", enable_hamming=False)
    path.write_text(json.dumps(meta))
    if "multiprobe" in change:
        back = TorchLSHRS.load_from_disk(tmp_path / "m", device="cpu")
        assert back.stats()["multiprobe"] == 2
        assert back.query(X[3], top_k=1) == [3]
        return
    expected = {"structured": FileNotFoundError, "crosspolytope": ValueError}.get(
        change.get("hash_family"), NotImplementedError
    )
    with pytest.raises(expected):
        TorchLSHRS.load_from_disk(tmp_path / "m", device="cpu")


def test_load_from_a_missing_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TorchLSHRS.load_from_disk(tmp_path / "nothing", device="cpu")


def test_projections_layout_matches_the_reference(rng):
    kw = dict(num_bands=4, rows_per_band=6, dim=10, seed=2)
    jh, th = JaxHasher(**kw), TorchHasher(device="cpu", **kw)
    assert len(th.projections) == 4
    for a, b in zip(th.projections, jh.projections):
        np.testing.assert_array_equal(a, b)
    th.device_projection()
    new = [rng.standard_normal((6, 10)).astype(np.float32) for _ in range(4)]
    th.projections = new
    jh.projections = new
    assert th._proj_dev is None  # the cached device operand is dropped
    X = rng.standard_normal((40, 10)).astype(np.float32)
    np.testing.assert_array_equal(th.hash_batch_words_host(X), jh.hash_batch_words_host(X))
    np.testing.assert_array_equal(th.device_projection().numpy(), np.concatenate(new).T)
    with pytest.raises(ValueError, match="projections"):
        th.projections = new[:3]
    with pytest.raises(ValueError, match="projections"):
        th.projections = [m[:, :9] for m in new]
