"""The port's stage profiles at a small size on the CPU.

``benchmarks/torch_{kernel,hamming,cascade,ingest}_profile.py`` and
``benchmarks/torch_gather_rerank_bench.py`` run with ``--device cpu``
(the kernels' plain versions) and one timed call a row. Each exits 0 and
prints its keys; each profile's ``full`` answer (ids and counts or
distances) equals the reference's core on the same words
(``lshrs_tpu.ops.scan.collision_topk_grouped_core``,
``lshrs_tpu.ops.hamming.hamming_topk_core`` and ``hamming_topk_cascade_core``
with ``use_pallas=False``; the cascade's pool covers the store, where its
contract is exact); ``served`` equals ``full`` (the scripts also hold the
stage-by-stage composition to ``full`` and exit 1 otherwise); the ingest
builds equal a ``lshrs_tpu.DeviceStore`` fed the same structured-family
words; the gather and full top-p ids and candidate counts equal the
reference store's ``snapshot_topp_fn`` on the port store's own words and
payload. A stage patched to return wrong ids, or a launch counter that
does not move where the script needs it to, ends the run with exit 1.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
NAMES = ("torch_kernel_profile", "torch_hamming_profile", "torch_cascade_profile",
         "torch_ingest_profile", "torch_gather_rerank_bench")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MOD = {name: _load(name) for name in NAMES}
RUNS = {
    "torch_kernel_profile": ["--cap", "2048", "--q", "32", "--trials", "1"],
    "torch_hamming_profile": ["--cap", "4096", "--q", "64", "--trials", "1"],
    # refine 16,384 slots: the pool covers the 2**14-slot store
    "torch_cascade_profile": ["--slots", "16384", "--q", "64", "--refine", "16384",
                              "--trials", "1", "--exact-select"],
    "torch_ingest_profile": ["--n", "8192", "--chunk", "2048"],
    "torch_gather_rerank_bench": ["--caps", "4096", "--query-batch", "64", "--dispatches", "1",
                                  "--trials", "1"],
}
# 64 bits a signature: most queries collide with more rows than the
# 256-candidate budget, so the gather engine truncates.
TRUNCATING = ["--caps", "4096", "--query-batch", "64", "--num-perm", "64",
              "--max-candidates", "256", "--dispatches", "1", "--trials", "1"]


def _main(name, argv, mp=None):
    """Run a script on the CPU with one timed call a row: exit code, the
    JSON lines it printed, its answers."""
    module, answers, out = MOD[name], {}, io.StringIO()
    with contextlib.ExitStack() as stack:
        mp = mp or stack.enter_context(pytest.MonkeyPatch.context())
        if hasattr(module, "N_ITER"):
            mp.setattr(module, "N_ITER", 1)
        stack.enter_context(contextlib.redirect_stdout(out))
        rc = module.main([*argv, "--device", "cpu"], answers=answers)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()], answers


@pytest.fixture(scope="module")
def runs():
    return {name: _main(name, argv) for name, argv in RUNS.items()}


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    import lshrs_tpu

    return jnp, lshrs_tpu


def _rows(lines, metric):
    return [line for line in lines if line.get("metric") == metric]


@pytest.mark.parametrize("name,metric,labels", [
    ("torch_kernel_profile", "kernel_profile",
     ["gmax kernel only", "kernel+select+refine", "kernel+select+row-refine", "kernel+topk",
      "device hash Q=32", "select", "gather", "recount", "final top-k", "served"]),
    ("torch_hamming_profile", "hamming_profile",
     ["unpack qbits", "gmax kernel only (planes)", "full: unpack+kernel+select+refine",
      "hierarchical top-groups only", "select+refine tail only", "gather", "popcount",
      "final top-k", "served"]),
    ("torch_cascade_profile", "cascade_profile",
     ["unpack", "coarse", "select", "gather", "popcount", "topk", "full", "served"]),
])
def test_profile_rows_and_summary(runs, name, metric, labels):
    rc, lines, _ = runs[name]
    assert rc == 0
    rows = _rows(lines, metric)
    assert [r["label"] for r in rows] == labels
    for r in rows:
        assert {"ms", "issue_ms", "wall_ms", "qps", "n_iter", "trials", "launches",
                "device"} <= set(r)
        assert r["device"] == {"name": "cpu", "power_limit": None} and r["launches"] is None
    summary = lines[-1]
    assert summary["device"] == {"name": "cpu", "power_limit": None}
    if name == "torch_cascade_profile":
        for key in ("slots", "capacity", "q", "cascade", "refine", "refine_groups", "group",
                    "tie_shift", "key_scale", "coarse_ms", "select_ms", "select_exact_ms",
                    "narrow_r", "refine_words_per_slot", "gather_ms", "popcount_ms", "topk_ms",
                    "full_cascade_ms", "slices", "unpack_ms", "stage_sum_ms", "served_ms",
                    "served_wall_ms"):
            assert key in summary, key
        assert summary["pool_set_recall_vs_exact"] == 1.0
        assert summary["slices"] == 1 and summary["refine_groups"] == 256
        stages = ("coarse", "select", "gather", "popcount", "topk")
        assert summary["stage_sum_ms"] == pytest.approx(sum(summary[f"{s}_ms"] for s in stages))
    else:
        assert summary["metric"] == f"{metric}_summary"
        stage_rows = {r["stage"]: r["ms"] for r in rows if r["stage"] not in (None, "full",
                                                                            "served")}
        assert summary["stages_ms"] == stage_rows
        assert summary["stage_sum_ms"] == pytest.approx(sum(stage_rows.values()))
        assert summary["full_ms"] == next(r["ms"] for r in rows if r["stage"] == "full")


def test_kernel_profile_full_equals_the_reference_core(runs, ref):
    jnp, lshrs_tpu = ref
    from lshrs_tpu.ops import scan as jscan

    a = runs["torch_kernel_profile"][2]
    words = a["words"].view(np.uint32)
    ids = jnp.arange(a["capacity"], dtype=jnp.int32)
    tie = jscan.compute_global_tie(ids)
    counts, got = jscan.collision_topk_grouped_core(
        jnp.asarray(np.ascontiguousarray(words.T)), ids, tie,
        jnp.asarray(a["qwords"].view(np.uint32)), num_bands=16, k=10, group=a["group"],
        pallas_chunk=a["capacity"], q_tile=8, use_pallas=False)
    np.testing.assert_array_equal(a["counts"], np.asarray(counts))
    np.testing.assert_array_equal(a["ids"], np.asarray(got))
    np.testing.assert_array_equal(a["served"], a["ids"])
    assert (a["counts"][:, 0] == 16).all()  # each query's own row, all 16 bands


def test_hamming_profile_full_equals_the_reference_core(runs, ref):
    jnp, lshrs_tpu = ref
    from lshrs_tpu.ops import hamming as jham
    from lshrs_tpu.ops import scan as jscan

    a = runs["torch_hamming_profile"][2]
    words, qw = jnp.asarray(a["words"]), jnp.asarray(a["qwords"].view(np.uint32))
    ids = jnp.arange(a["capacity"], dtype=jnp.int32)
    kw = dict(num_bands=16, rows_per_band=16)
    dist, got = jham.hamming_topk_core(
        jham.unpack_bitplanes(words, **kw), jnp.asarray(np.ascontiguousarray(a["words"].T)),
        ids, jscan.compute_global_tie(ids), jham.unpack_bitplanes(qw, **kw), qw,
        k=10, chunk=a["group"] * 8, group=a["group"], use_pallas=False)
    np.testing.assert_array_equal(a["hamming"], np.asarray(dist))
    np.testing.assert_array_equal(a["ids"], np.asarray(got))
    np.testing.assert_array_equal(a["served"], a["ids"])


def test_cascade_profile_full_equals_the_reference_core(runs, ref):
    jnp, lshrs_tpu = ref
    from lshrs_tpu.ops import hamming as jham
    from lshrs_tpu.ops import scan as jscan

    a = runs["torch_cascade_profile"][2]
    words, qw = jnp.asarray(a["words"]), jnp.asarray(a["qwords"].view(np.uint32))
    ids = jnp.arange(a["capacity"], dtype=jnp.int32)
    kw = dict(num_bands=16, rows_per_band=16)
    dist, got = jham.hamming_topk_cascade_core(
        jham.unpack_bitplanes(words, **kw)[:, :64],
        jnp.asarray(np.ascontiguousarray(a["words"].T)), ids, jscan.compute_global_tie(ids),
        jham.unpack_bitplanes(qw, **kw)[:, :64], qw, num_perm=256, k=10,
        refine_groups=a["refine_groups"], chunk=a["group"] * 8, group=a["group"],
        use_pallas=False)
    np.testing.assert_array_equal(a["hamming"], np.asarray(dist))
    np.testing.assert_array_equal(a["ids"], np.asarray(got))
    np.testing.assert_array_equal(a["served"], a["ids"])


def test_ingest_builds_equal_the_reference_store(runs, ref):
    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    rc, lines, a = runs["torch_ingest_profile"]
    assert rc == 0 and len(lines) == 1
    line = lines[0]
    assert set(line["stages_s"]) == {"hash", "upload_blocking", "append_dispatch",
                                      "final_barrier"}
    for key in ("serial", "chunked_async", "monolithic", "hash_only"):
        assert line[f"{key}_vectors_per_s"] > 0
    assert (line["n"], line["chunk"], line["chunks"], line["self_match"]) == (8192, 2048, 4, 1.0)
    hasher = LSHHasher(num_bands=16, rows_per_band=16, dim=768, seed=42,
                       hash_family="structured")
    store = DeviceStore(num_bands=16, rows_per_band=16, dim=768, initial_capacity=8192,
                        dedupe=False)
    for lo in range(0, 8192, 2048):
        store.add_signature_batch(a["ids"][lo:lo + 2048],
                                  hasher.hash_batch_dense_host(a["x"][lo:lo + 2048]))
    want = store.state_arrays()
    for state in a["states"]:
        np.testing.assert_array_equal(state["ids"], np.asarray(want["ids"]))
        np.testing.assert_array_equal(state["sig"], np.asarray(want["sig"]))


@pytest.fixture(scope="module")
def truncating():
    return _main("torch_gather_rerank_bench", TRUNCATING)


@pytest.mark.parametrize("run", ["default", "truncating"])
def test_gather_rerank_equals_the_reference_store(runs, truncating, ref, run):
    _, lshrs_tpu = ref
    from lshrs_tpu.storage.device import DeviceStore

    rc, lines, answers = runs["torch_gather_rerank_bench"] if run == "default" else truncating
    assert rc == 0
    row, summary = lines[0], lines[-1]
    assert summary["metric"] == "gather_rerank_sweep_summary"
    assert summary["rows"] == [{k: v for k, v in row.items()
                                if k not in ("metric", "launches", "device")}]
    for key in ("full_ms_per_batch", "gather_ms_per_batch", "full_qps_device",
                "gather_qps_device", "mean_candidates", "truncated_frac", "speedup"):
        assert key in row, key
    mc, rows_per_band = (1024, 16) if run == "default" else (256, 4)
    a = answers[4096]
    store = DeviceStore(num_bands=16, rows_per_band=rows_per_band, dim=768, store_vectors=True,
                        initial_capacity=4096, dedupe=False, chunk_size=2048)
    store.add_signature_batch(a["ids"], a["words"], vectors=a["payload"])
    for engine in ("full", "gather"):
        serve = store.snapshot_topp_fn(10, wire="words", engine=engine, max_candidates=mc)
        ids, _, n = (np.asarray(x) for x in serve(a["qwords"].view(np.uint32), a["qx"]))
        np.testing.assert_array_equal(a["served"][engine][0], ids)
        np.testing.assert_array_equal(a["served"][engine][1], n)
        p_ids, _, p_n = (np.asarray(x) for x in serve(a["probe_words"].view(np.uint32),
                                                      a["probe_x"]))
        np.testing.assert_array_equal(a["probe_ids"][engine][0], p_ids)
        np.testing.assert_array_equal(a["probe_ids"][engine][1], p_n)
        if engine == "gather":
            assert row["mean_candidates"] == float(n.mean())
            assert row["truncated_frac"] == float((n >= mc).mean())
    if run == "default":
        assert row["truncated_frac"] == 0.0 and row["probe_exact_queries"] == 64
    else:
        assert row["truncated_frac"] > 0.5


@pytest.mark.parametrize("name,stage", [
    ("torch_kernel_profile", "collision_final_topk"),
    ("torch_hamming_profile", "hamming_final_topk"),
    ("torch_cascade_profile", "hamming_final_topk"),
])
def test_a_wrong_stage_fails_the_run(name, stage):
    real = getattr(MOD[name], stage)

    def wrong(*args, **kw):
        out, ids = real(*args, **kw)
        return out, torch.where(ids >= 0, ids + 1, ids)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MOD[name], stage, wrong)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, _, _ = _main(name, RUNS[name], mp)
    assert rc == 1
    assert json.loads(err.getvalue())["check_failed"] == "stages_equal_full"


def test_a_wrong_gather_engine_fails_the_run():
    import lshrs_tpu_torch.storage.device as tdevice

    real = tdevice.rerank_topp_gather_core

    def wrong(*args, **kw):
        ids, sims, n, exact = real(*args, **kw)
        return ids.flip(1), sims, n, exact

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdevice, "rerank_topp_gather_core", wrong)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, _, _ = _main("torch_gather_rerank_bench", RUNS["torch_gather_rerank_bench"], mp)
    assert rc == 1
    assert json.loads(err.getvalue())["check_failed"] == "self_match_gather_4096"


@pytest.mark.parametrize("name", ["torch_kernel_profile", "torch_gather_rerank_bench"])
def test_a_kernel_that_does_not_launch_fails_the_run(name):
    """With launch counting forced on, the plain versions on the CPU move
    no counter: the first row that needs B1 fails its check."""
    timing = MOD[name].st
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timing, "counts_launches", lambda device: True)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc, _, _ = _main(name, RUNS[name], mp)
    assert rc == 1
    failed = json.loads(err.getvalue())
    assert failed["check_failed"].endswith("launches") and "group_max_keys" in failed["detail"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in NAMES:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert MOD[name].main(["--smoke"]) == 1
        assert out.getvalue() == "" and "no CUDA device" in err.getvalue()


@pytest.mark.cuda
@pytest.mark.parametrize("name", NAMES)
def test_smoke_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert MOD[name].main(["--smoke"]) == 0
    assert out.getvalue().strip()
