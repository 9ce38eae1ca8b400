"""``benchmarks/torch_recall_bench.py`` against ``benchmarks/recall_bench.py`` on the CPU.

Both scripts' ``run_threshold`` receive the same base vectors, queries and
ground truth (the reference's ``exact_topk_device`` on the CPU). Both
packages hash on the host in NumPy from the same projections, so every
recall column must be equal, at every parametrised flag set: the three
hash families, ``--rerank``, ``--multiprobe 2``, ``--similarity dot``,
``--payload-dtype int8``, ``--retrain 5`` and the forced bandings 64 x 4,
8 x 32 and 4 x 64. The reranked columns may differ only by boundary swaps
of neighbours whose scores lie within 1e-5 (the top-p contract). The
script's own truth must equal a float64 NumPy brute force, the script
must import neither ``jax`` nor ``lshrs_tpu``, and a launch counter that
does not move fails its run. The ``cuda`` case runs ``--smoke`` on a GPU
and skips elsewhere.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


bench = _load("torch_recall_bench")

N, DIM, NQ, K = 4000, 64, 64, 10


@pytest.fixture(scope="module")
def ref():
    """The reference script (the tests' conftest keeps JAX on the CPU)."""
    pytest.importorskip("jax")
    return _load("recall_bench")


def _data(similarity: str):
    """The reference's ``main`` data flow at a small size."""
    rng = np.random.default_rng(7)
    base = bench.make_clustered(N, DIM, n_clusters=max(1000, N // 1000), rng=rng)
    if similarity == "dot":
        base *= rng.uniform(0.5, 1.5, (N, 1)).astype(np.float32)
    q_idx = rng.permutation(N)[:NQ]
    queries = base[q_idx] + 0.05 * rng.standard_normal((NQ, DIM)).astype(np.float32)
    return base, queries


@pytest.fixture(scope="module")
def data(ref):
    out = {}
    for similarity in ("cosine", "dot"):
        base, queries = _data(similarity)
        gt = ref.exact_topk_device(base, queries, K, metric=similarity)
        out[similarity] = (base, queries, gt)
    return out


def _args(**kw) -> argparse.Namespace:
    a = dict(n=N, dim=DIM, queries=NQ, k=K, num_perm=256, bands=None, rows=None,
             payload_dtype="float32", rerank=False, multiprobe=1, similarity="cosine",
             hash_family="gaussian", retrain=0, device="cpu")
    a.update(kw)
    return argparse.Namespace(**a)


CASES = {  # name -> (threshold, flags)
    "gaussian": (0.8, {}),
    "structured": (0.8, dict(hash_family="structured", multiprobe=2)),
    "crosspolytope": (0.6, dict(hash_family="crosspolytope", rerank=True, multiprobe=2)),
    "rerank": (0.8, dict(rerank=True)),
    "multiprobe2": (0.6, dict(multiprobe=2, rerank=True)),
    "dot": (0.8, dict(similarity="dot", rerank=True)),
    "int8": (0.8, dict(payload_dtype="int8", rerank=True)),
    "retrain5": (0.6, dict(retrain=5)),
    "bands64x4": (0.8, dict(bands=64, rows=4)),
    "bands8x32": (0.8, dict(bands=8, rows=32)),
    "bands4x64": (0.8, dict(bands=4, rows=64)),
}


def _capture(monkeypatch, module, lsh_cls, store_cls) -> dict:
    """Record what ``module.run_threshold`` scores: every ``recall`` call's
    rows, and every top-p answer (ids and scores) of the rerank columns."""
    seen = {"recall": [], "topp": []}
    real_recall = module.recall

    def recall(rows, gt, k):
        rows = [list(map(int, r)) for r in rows]
        seen["recall"].append(rows)
        return real_recall(rows, gt, k)

    real_batch, real_store = lsh_cls.get_above_p_batch, store_cls.query_topp_batch

    def get_above_p_batch(self, *a, **kw):
        out = real_batch(self, *a, **kw)
        seen["topp"].append(([[i for i, _ in r] for r in out], [[s for _, s in r] for r in out]))
        return out

    def query_topp_batch(self, *a, **kw):
        ids, sims, n = real_store(self, *a, **kw)
        ids, sims = np.asarray(ids), np.asarray(sims)
        seen["topp"].append(([r[r >= 0].tolist() for r in ids],
                             [s[r >= 0].tolist() for r, s in zip(ids, sims)]))
        return ids, sims, n

    monkeypatch.setattr(module, "recall", recall)
    monkeypatch.setattr(lsh_cls, "get_above_p_batch", get_above_p_batch)
    monkeypatch.setattr(store_cls, "query_topp_batch", query_topp_batch)
    return seen


def _boundary_swaps_only(ref_topp, got_topp) -> None:
    """Per query: the same count, scores equal within 1e-5 (relative past
    1) rank by rank, and an id served by one package only scores within
    1e-5 of the row's last score."""
    for (ri, rs), (gi, gs) in zip(zip(*ref_topp), zip(*got_topp)):
        assert len(ri) == len(gi)
        if ri == gi:
            continue
        rs, gs = np.asarray(rs, np.float64), np.asarray(gs, np.float64)
        tol = 1e-5 * max(1.0, float(np.abs(rs).max()))
        np.testing.assert_allclose(gs, rs, rtol=0, atol=tol)
        score = dict(zip(ri, rs)) | dict(zip(gi, gs))
        for i in set(ri) ^ set(gi):
            assert abs(score[i] - rs[-1]) <= tol, (i, score[i], rs[-1])


@pytest.mark.parametrize("case", list(CASES))
def test_recall_rows_equal_the_reference(data, ref, case, monkeypatch):
    import lshrs_tpu
    import lshrs_tpu.storage.device as jdevice
    import lshrs_tpu_torch
    import lshrs_tpu_torch.storage.device as tdevice

    threshold, flags = CASES[case]
    args = _args(**flags)
    base, queries, gt = data[args.similarity]
    if args.similarity == "dot":
        args._max_norm = float(np.linalg.norm(base, axis=1).max()) * 1.001
    seen_ref = _capture(monkeypatch, ref, lshrs_tpu.LSHRS, jdevice.DeviceStore)
    want = ref.run_threshold(base, queries, gt, threshold, args)
    seen = _capture(monkeypatch, bench, lshrs_tpu_torch.LSHRS, tdevice.DeviceStore)
    got = bench.run_threshold(base, queries, gt, threshold, args)

    columns = [key for key in want if key.startswith("recall@")]
    assert columns == [key for key in got if key.startswith("recall@")]
    assert len(seen["recall"]) == len(seen_ref["recall"]) == len(columns)
    assert len(seen["topp"]) == len(seen_ref["topp"])
    for key in ("threshold", "family", "bands"):
        assert got[key] == want[key], key
    for key in ("signature_mb", "hamming_extra_mb"):
        if key in want:
            assert round(got[key], 1) == want[key], key
    if "itq" in want:
        assert {k: got["itq"][k] for k in ("fitted_bits", "padded_bits")} == {
            k: want["itq"][k] for k in ("fitted_bits", "padded_bits")}
        assert got["itq"]["bit_bias"] == pytest.approx(want["itq"]["bit_bias"], abs=1e-6)
    topp = iter(zip(seen_ref["topp"], seen["topp"]))
    for key, rows_ref, rows in zip(columns, seen_ref["recall"], seen["recall"]):
        if "reranked" in key:
            _boundary_swaps_only(*next(topp))
            continue
        assert rows == rows_ref, key
        assert round(got[key], 4) == want[key], key
    assert got["rerank_engine"] == ("full" if args.rerank else None)
    assert got["launches"] is None  # the plain versions run on the CPU: nothing counted


def test_data_generators_equal_the_reference(ref):
    for name in ("make_clustered", "make_heavy_tailed"):
        a = getattr(bench, name)(500, 32, 20, np.random.default_rng(7))
        b = getattr(ref, name)(500, 32, 20, np.random.default_rng(7))
        np.testing.assert_array_equal(a, b)
    assert bench.recall([[1, 2, -1]], np.array([[2, 3, 4]]), 3) == ref.recall(
        [[1, 2, -1]], np.array([[2, 3, 4]]), 3)


@pytest.mark.parametrize("metric", ["cosine", "dot"])
def test_exact_topk_equals_float64_brute_force(metric, monkeypatch):
    rng = np.random.default_rng(5)
    base = rng.standard_normal((700, 48)).astype(np.float32)
    base *= rng.uniform(0.5, 1.5, (700, 1)).astype(np.float32)
    queries = rng.standard_normal((37, 48)).astype(np.float32)
    queries[:4] = base[:4]
    monkeypatch.setattr(bench, "TRUTH_BLOCK_ELEMENTS", 700 * 8)  # 8-query blocks: 5 of them
    got = bench.exact_topk_device(base, queries, K, metric=metric, device="cpu")
    b, q = base.astype(np.float64), queries.astype(np.float64)
    if metric == "cosine":
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = q @ b.T
    want = np.argsort(-s, axis=1, kind="stable")[:, :K]
    rows = np.arange(len(q))[:, None]
    assert got.shape == want.shape == (37, K)
    assert np.all((got == want) | (np.abs(s[rows, got] - s[rows, want]) < 1e-6))
    if metric == "cosine":
        assert (got[:4, 0] == np.arange(4)).all()


def test_scripts_and_the_port_import_neither_jax_nor_the_reference():
    code = (
        "import importlib, importlib.util, pkgutil, sys; "
        "import lshrs_tpu_torch; "
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
        "lshrs_tpu_torch.__path__, 'lshrs_tpu_torch.')]; "
        "[importlib.util.spec_from_file_location(n, f'benchmarks/{n}.py').loader.exec_module("
        "importlib.util.module_from_spec(importlib.util.spec_from_file_location(n, "
        "f'benchmarks/{n}.py'))) for n in ('torch_recall_bench', 'torch_capacity_bench')]; "
        "bad = [m for m in sys.modules if m in ('jax', 'lshrs_tpu') "
        "or m.startswith(('jax.', 'lshrs_tpu.'))]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=180)


def _counting(monkeypatch, name: str) -> None:
    """Replace kernel wrapper ``name`` (in ``ops.group_max`` and every
    module that calls it) by one that counts its calls as launches."""
    from lshrs_tpu_torch.ops import asymmetric, group_max, hamming, rerank, scan

    real = getattr(group_max, name)

    def wrapper(*a, **kw):
        wrapper.launches += 1
        return real(*a, **kw)

    wrapper.launches = 0
    for module in (group_max, scan, hamming, asymmetric, rerank):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, wrapper)


SMALL = ["--device", "cpu", "--n", "3000", "--dim", "32", "--queries", "16",
         "--thresholds", "0.4", "0.95", "--multiprobe", "2"]


@pytest.mark.parametrize("counted", [False, True])
def test_a_launch_counter_that_does_not_move_fails_the_run(monkeypatch, capsys, counted):
    """Where launches are counted, a collision column whose B1 counter does
    not move fails the run (exit 1, nothing on stdout); with the calls
    counted as launches every row prints, with its launches."""
    monkeypatch.setattr(bench, "counts_launches", lambda device: True)
    if counted:
        for name in (bench.B1, bench.B2, bench.B3):
            _counting(monkeypatch, name)
    rc = bench.main(SMALL)
    out, err = capsys.readouterr()
    if not counted:
        assert rc == 1 and out == ""
        assert json.loads(err.strip().splitlines()[-1])["check_failed"] == "collision_launches_group_max_keys"
        return
    assert rc == 0
    rows = [json.loads(line) for line in out.splitlines()]
    assert [r["bands"] for r in rows] == ["64x4", "4x64"]
    for r in rows:
        assert r["launches"]["collision"]["group_max_keys"] >= 1
        assert r["launches"]["collision_mp2"]["group_max_keys"] >= 1
        assert r["launches"]["hamming"]["hamming_group_max_keys"] >= 1
        assert r["launches"]["asymmetric"]["hamming_group_max_keys"] >= 1
        assert r["device"] == {"name": "cpu", "power_limit": None}


@pytest.mark.cuda
def test_smoke_on_the_card():
    """``--smoke`` on the GPU: every row printed, B1 at each banding's band
    words, B2 on the Hamming and asymmetric columns, the card named."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (kernels B1/B2 have no CPU build)")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--smoke"])
    assert rc == 0
    rows = [json.loads(line) for line in out.getvalue().splitlines()]
    assert [r["bands"] for r in rows] == ["64x4", "32x8", "16x16", "8x32", "4x64"]
    for r in rows:
        assert r["device"]["name"] == torch.cuda.get_device_name(0)
        assert r["launches"]["collision"]["group_max_keys"] >= 1
        assert r["launches"]["hamming"]["hamming_group_max_keys"] >= 1
