"""The comparison that decides ``correct``: the reference held to a brute
force, its control (the reference in TF32) failing each cell's limit, and
runs whose timed path is broken underneath coming out not correct."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.data import make_data
from perfbench.reference import lsh as reference
from perfbench.tests.proposed import with_proposed

ROOT = Path(harness.__file__).resolve().parents[1]
SPEC = with_proposed(harness.load_spec(ROOT))
CELLS = [w["name"] for w in SPEC["workloads"]]
AUTO_SWITCH = 1 << 15
TINY_TRAIN = {"collision": 3000, "hamming": 20000}
# Sizes a test run holds at which the control still reads its cell's share
# of mismatches (collisions need enough stored rows to collide with).
CONTROL_TRAIN = {"collision": 20000, "hamming": 20000}


def tiny(cell):
    cell.config["train"] = TINY_TRAIN[cell.config["ranking"]]
    cell.config["test"] = 200
    if cell.mix.get("batch", 1) > 1:
        cell.mix["batch"] = 100
    if "readback" in cell.mix:
        cell.mix["readback"] = 64
    return cell


@pytest.fixture
def small_switch(monkeypatch):
    from lshrs_tpu_torch import LSHRS

    monkeypatch.setattr(LSHRS, "_AUTO_HAMMING_CAPACITY", AUTO_SWITCH)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _brute(index, data, queries, ranking, k):
    """Bit by bit in NumPy: float64 signs, per-band equality or XOR counts."""
    planes = reference.hyperplanes(index["seed"], index["num_perm"], index["dim"])
    planes = planes.astype(np.float64)
    db, qb = data.astype(np.float64) @ planes.T > 0, queries.astype(np.float64) @ planes.T > 0
    n, out = len(data), []
    for q in qb:
        if ranking == "collision":
            bands = index["num_bands"]
            score = (q.reshape(bands, -1) == db.reshape(n, bands, -1)).all(-1).sum(-1)
            order = sorted(range(n), key=lambda i: (-score[i], i))[:k]
            out.append([i if score[i] > 0 else -1 for i in order])
        else:
            dist = (q != db).sum(-1)
            out.append(sorted(range(n), key=lambda i: (dist[i], i))[:k])
    return np.array(out)


@pytest.mark.parametrize("ranking", ["collision", "hamming"])
def test_reference_answers_equal_a_brute_force(ranking):
    index = {"dim": 24, "num_perm": 32, "num_bands": 8, "rows_per_band": 4, "seed": 5}
    config = {"train": 400, "test": 30, "dim": 24,
              "data": {"centers": 16, "noise": 0.35}}
    train, test = make_data(config, 1234, "cpu")
    got = reference.answers(index, train, test, ranking=ranking, k=7, precision="float64",
                            device="cpu", block=8)
    assert np.array_equal(got, _brute(index, train, test, ranking, 7))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0 - 2**-12, 0.1])
    r = reference._round_tf32(x)
    assert r.tolist()[:3] == [1.0 + 2**-10, 1.0 + 2**-10, -3.0]
    assert abs(r[3].item() - 0.1) <= 0.1 * 2**-11


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_cell_limit(name):
    """The reference in TF32 (its rounding of the inputs, on the CPU) in the
    program's place reads more mismatches than the cell's limit allows."""
    cell = harness.resolve(SPEC, name, ROOT)
    ranking, index = cell.config["ranking"], cell.config["index"]
    cell.config.update(train=CONTROL_TRAIN[ranking], test=1000)
    for seed in (101, 202, 303):
        train, test = make_data(cell.config, seed, "cpu")
        queries = test if cell.mix["client"] == "queries" else train[:1000]
        kw = dict(ranking=ranking, k=cell.mix["top_k"], device="cpu")
        truth = reference.answers(index, train, queries, precision="float64", **kw)
        control = reference.answers(index, train, queries, precision="tf32", **kw)
        assert reference.mismatch(control, truth) > cell.limits["mismatch"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cell_size_on_the_card(name, card):
    """On the card at the cell's own size, three seeds: the program passes
    its check and the TF32 control in its place does not."""
    for seed in (2_900_000_017, 2_900_007_936, 2_900_015_855):
        cell = harness.resolve(SPEC, name, ROOT)
        result = harness.run(cell, seed=seed, seconds=1.0, trace=False, device=card,
                             control=True)
        assert result["correct"], result["checks"]
        assert result["control_mismatch"] > cell.limits["mismatch"]


def _alter_answers(monkeypatch):
    """An answer altered where it is produced: the store's serving closure
    returns each query's first id moved to another slot."""
    from lshrs_tpu_torch.storage import device as store

    real = store.DeviceStore.snapshot_query_fn

    def broken(self, *args, **kwargs):
        serve = real(self, *args, **kwargs)

        def altered(q):
            ids = serve(q).clone()
            ids[:, 0] = torch.where(ids[:, 0] < 0, 0, ids[:, 0] + 1)
            return ids

        return altered

    monkeypatch.setattr(store.DeviceStore, "snapshot_query_fn", broken)


def _run_broken(name):
    cell = tiny(harness.resolve(SPEC, name, ROOT))
    return harness.run(cell, seed=77, seconds=0.3, trace=False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_is_not_correct(name, small_switch, monkeypatch):
    _alter_answers(monkeypatch)
    result = _run_broken(name)
    assert not result["correct"]
    assert result["checks"]["mismatch"]["value"] > result["checks"]["mismatch"]["limit"]


def test_half_of_each_build_left_out_is_not_correct(small_switch, monkeypatch):
    from lshrs_tpu_torch.storage import device as store

    real = store.DeviceStore.add_vectors_batch

    def half(self, indices, vectors, *args, **kwargs):
        keep = len(indices) // 2
        return real(self, indices[:keep], vectors[:keep], *args, **kwargs)

    monkeypatch.setattr(store.DeviceStore, "add_vectors_batch", half)
    result = _run_broken("glove100.build")
    assert not result["correct"] and result["failed"] == 0
    assert result["checks"]["mismatch"]["value"] > result["checks"]["mismatch"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_an_index_left_unchanged_by_its_build_is_not_correct(name, small_switch, monkeypatch):
    """A build that returns the index unchanged stores nothing: the index
    refuses to serve it, so the run stops in its set-up and prints no
    result line."""
    from lshrs_tpu_torch import LSHRS

    monkeypatch.setattr(LSHRS, "index", lambda self, indices, vectors=None: None)
    with pytest.raises(RuntimeError, match="non-empty"):
        _run_broken(name)
