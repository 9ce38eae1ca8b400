"""The port's five serving benches at a small size on the CPU.

``benchmarks/torch_{asymmetric,scale,rerank,auto_engine,cp}_bench.py`` run
with ``--device cpu`` (the kernels' plain versions). Each exits 0 and
prints every field of its reference script (the scale bench's ``pallas``
replaced by ``route``); the ids it served for its probe and its timed
batches (through ``answers``) equal those of a ``lshrs_tpu`` store fed the
port store's own words, on the wire the script served: the asymmetric
coordinates, the dense wire or the words; the top-p ids, candidate
counts and cosines (within 1e-5) equal the reference store's
``snapshot_topp_fn`` and ``get_above_p_batch``; the cross-polytope words
equal ``lshrs_tpu``'s hash of the same rows (that family is bit-exact
across packages); the scale bench's Parquet build equals its arrays
build. Wrong ids, a launch counter that does not move where a kernel
must launch (or moves where none may), ``--device cuda`` without a card
and ``--parquet`` without ``pyarrow`` each end the run with exit 1. The
``cuda`` cases run each script's ``--smoke`` on a GPU and skip elsewhere.
"""

from __future__ import annotations

import builtins
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
NAMES = ("torch_asymmetric_bench", "torch_scale_bench", "torch_rerank_bench",
         "torch_auto_engine_bench", "torch_cp_bench")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MOD = {name: _load(name) for name in NAMES}
st = MOD["torch_scale_bench"].st

SCALE = ["--n", "4096", "--batch", "1024", "--query-batch", "128", "--n-batches", "2",
         "--trials", "1"]
CP_N, CP_Q = 256, 32  # the cross-polytope hash is the slowest part on a CPU
AUTO = ["--n", "4096", "--query-batch", "128", "--n-batches", "2", "--trials", "1"]
RUNS = {
    "asymmetric": ("torch_asymmetric_bench",
                   ["--n", "2048", "--query-batch", "128", "--n-batches", "2", "--trials", "2"]),
    "scale_scan": ("torch_scale_bench", SCALE),
    "scale_hamming": ("torch_scale_bench", SCALE + ["--mode", "hamming"]),
    "scale_bucket": ("torch_scale_bench", SCALE + ["--mode", "bucket"]),
    "scale_parquet": ("torch_scale_bench", SCALE + ["--parquet"]),
    "scale_device_hash": ("torch_scale_bench", SCALE + ["--hash-mode", "device"]),
    "rerank": ("torch_rerank_bench",
               ["--n", "4096", "--query-batch", "128", "--n-batches", "2", "--trials", "1"]),
    "rerank_bf16": ("torch_rerank_bench", ["--n", "4096", "--query-batch", "128", "--n-batches",
                                           "1", "--trials", "1", "--wire-dtype", "bfloat16"]),
    # auto takes Hamming at this capacity: the threshold is lowered to it
    "auto": ("torch_auto_engine_bench", AUTO),
    "auto_collision": ("torch_auto_engine_bench", AUTO + ["--engine", "collision"]),
    "auto_structured": ("torch_auto_engine_bench", AUTO + ["--hash-family", "structured"]),
    "cp": ("torch_cp_bench", ["--n", str(CP_N), "--query-batch", str(CP_Q), "--n-batches", "2",
                              "--trials", "1"]),
}
# Every field the reference script prints (the scale bench's ``pallas``
# is replaced by ``route``), and the fields each port row adds.
REFERENCE_FIELDS = {
    "torch_asymmetric_bench": ["metric", "qps_best", "qps_median", "self_match_rate",
                               "wire_bytes_per_query", "build_s", "query_batch", "pipeline"],
    "torch_scale_bench": ["n_indexed", "dim", "via", "mode", "hash_mode", "build_s",
                          "build_vectors_per_s", "build_cold_s", "query_qps", "platform",
                          "capacity", "signature_mb"],
    "torch_rerank_bench": ["metric", "wire_dtype", "n", "dim", "p", "top_k", "query_batch", "qps",
                           "latency_ms_per_batch", "self_match_rate", "platform"],
    "torch_auto_engine_bench": ["metric", "engine", "ranking", "n", "dim", "num_perm", "qps",
                                "qps_median", "build_s", "build_vectors_per_s",
                                "self_match_rate", "hamming_extra_bytes", "platform"],
    "torch_cp_bench": ["metric", "n", "dim", "banding", "payload_dtype",
                       "index_build_vectors_per_s", "index_build_dispatch_rate_best_chunk",
                       "platform", "self_match_rate", "collision_qps_e2e",
                       "collision_qps_e2e_median", "collision_qps_engine",
                       "collision_qps_engine_median", "collision_qps_device",
                       "collision_ms_device", "topp_self_match_rate", "rerank_engine",
                       "topp_qps", "topp_qps_median", "topp_qps_device", "topp_ms_device",
                       "topp_engine_resolved", "fused_build_vectors_per_s",
                       "fused_build_vectors_per_s_median", "fused_build_self_match",
                       "host_hash_vectors_per_s"],
}
ADDED = ["launches", "seconds", "peak_device_bytes", "device"]


def _main(name, argv, answers=None):
    """Run a script on the CPU: exit code, its JSON lines, its stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = MOD[name].main([*argv, "--device", "cpu"], answers=answers)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()], err.getvalue()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The scripts call torch from several threads at once (the hasher, the
    dispatch and the reader thread, or three submitting threads), and each
    calling thread gets its own team of intra-op threads: beside the
    suite's other workers on a loaded CPU that costs orders of magnitude.
    One intra-op thread keeps each run near its serial cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Each run: exit code, printed rows, the answers the script recorded."""
    from lshrs_tpu_torch import LSHRS

    done = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LSHRS, "_AUTO_HAMMING_CAPACITY", 4096)
        for key, (name, argv) in RUNS.items():
            answers = {}
            rc, rows, _ = _main(name, argv, answers)
            done[key] = (rc, rows, answers)
    return done


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import lshrs_tpu

    return lshrs_tpu


def _u32(words) -> np.ndarray:
    return np.ascontiguousarray(words).view(np.uint32)


@pytest.mark.parametrize("key", list(RUNS))
def test_rows_carry_the_reference_fields(runs, key):
    rc, rows, _ = runs[key]
    assert rc == 0 and len(rows) == 1
    row = rows[0]
    for field in REFERENCE_FIELDS[RUNS[key][0]] + ADDED:
        assert field in row, field
    assert row["device"] == {"name": "cpu", "power_limit": None}
    assert row["peak_device_bytes"] is None and row["seconds"] > 0
    if "platform" in row:
        assert row["platform"] == "cpu"
    launches = row["launches"]
    assert launches is None or all(v is None for v in launches.values())  # CPU: not counted
    if "self_match_rate" in row:
        assert row["self_match_rate"] == 1.0
    if not key.startswith("cp"):  # the card's ms a batch beside the wall clock's
        assert row["device_ms_per_batch"] > 0


def test_asymmetric_ids_equal_the_reference_store(runs, ref):
    from lshrs_tpu.storage.device import DeviceStore

    rc, (row,), a = runs["asymmetric"]
    assert rc == 0 and row["b2_packing"] == [256, 256 * 127, 0]
    store = DeviceStore(num_bands=16, rows_per_band=16, chunk_size=2048, initial_capacity=2048,
                        enable_hamming=True, dedupe=False)
    store.add_signature_batch(np.arange(2048), _u32(a["words"]))
    serve = store.snapshot_query_fn(10, mode="asymmetric")
    np.testing.assert_array_equal(np.asarray(serve(a["probe_coords"])), a["probe_ids"])
    assert (a["probe_ids"][:, 0] == np.arange(128)).all()
    assert len(a["ids"]) == 2
    for coords, ids in zip(a["coords"], a["ids"]):
        assert coords.dtype == np.int8 and coords.shape == (128, 256)
        np.testing.assert_array_equal(np.asarray(serve(coords)), ids)


@pytest.mark.parametrize("key", ["scale_scan", "scale_hamming", "scale_bucket",
                                 "scale_device_hash"])
def test_scale_ids_equal_the_reference_store(runs, ref, key):
    from lshrs_tpu.storage.device import DeviceStore

    rc, (row,), a = runs[key]
    mode = row["mode"]
    assert rc == 0 and row["n_indexed"] == 4096 and row["capacity"] == 4096
    assert row["route"] == {"scan": "group_max_keys", "hamming": "hamming_group_max_keys",
                            "bucket": "none"}[mode]
    assert row["build_cold_s"] > 0
    store = DeviceStore(num_bands=16, rows_per_band=16, dim=256, initial_capacity=4096,
                        query_mode=mode if mode != "hamming" else "scan", bucket_cap=128,
                        enable_hamming=mode == "hamming", dedupe=False)
    store.add_signature_batch(a["ids"], _u32(a["words"]))
    if mode == "bucket":
        def serve(wire):
            return store.query_topk_ids(_u32(wire), 10)
    else:
        wire = "dense" if row["hash_mode"] == "host" else "words"
        closure = store.snapshot_query_fn(
            10, wire=wire, mode="hamming" if mode == "hamming" else "collision")

        def serve(q):
            return closure(q if wire == "dense" else _u32(q))
    assert len(a["served"]) == 2
    for wire_batch, ids in zip(a["wire"], a["served"]):
        np.testing.assert_array_equal(np.asarray(serve(wire_batch)), ids)


def test_scale_parquet_build_equals_the_arrays_build(runs):
    (rc_p, (row_p,), p), (rc_a, (row_a,), a) = runs["scale_parquet"], runs["scale_scan"]
    assert rc_p == rc_a == 0
    assert (row_p["via"], row_a["via"]) == ("parquet", "arrays")
    assert row_p["build_cold_s"] is None and row_p["n_indexed"] == 4096
    np.testing.assert_array_equal(p["ids"], a["ids"])
    np.testing.assert_array_equal(p["words"], a["words"])
    for x, y in zip(p["served"], a["served"]):
        np.testing.assert_array_equal(x, y)


def test_scale_parquet_without_pyarrow_exits_1(monkeypatch):
    real = builtins.__import__

    def no_pyarrow(name, *a, **kw):
        if name.split(".")[0] == "pyarrow":
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    rc, rows, err = _main("torch_scale_bench", SCALE + ["--parquet"])
    assert rc == 1 and rows == [] and "pyarrow" in err


@pytest.mark.parametrize("key", ["rerank", "rerank_bf16"])
def test_rerank_topp_equals_the_reference_store(runs, ref, key):
    import ml_dtypes

    from lshrs_tpu.storage.device import DeviceStore

    rc, (row,), a = runs[key]
    assert rc == 0 and row["rerank_engine"] == a["engine"] == "full"
    store = DeviceStore(num_bands=16, rows_per_band=16, dim=768, store_vectors=True,
                        initial_capacity=a["capacity"], dedupe=False)
    store.add_signature_batch(a["ids"], _u32(a["words"]), vectors=a["payload"])
    assert store._resolve_rerank_engine(None, None)[0] == a["engine"]
    serve = store.snapshot_topp_fn(10, wire="dense")
    bf16 = row["wire_dtype"] == "bfloat16"
    for raw, wire, (ids, sims, n) in zip(a["raw"], a["wire"], a["served"]):
        want = [np.asarray(x) for x in serve(wire, raw.astype(ml_dtypes.bfloat16) if bf16 else raw)]
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_allclose(sims, want[1], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(n, want[2])
    # the probe: get_above_p_batch of the reference fed the port's words
    lsh = ref.LSHRS(dim=768, num_perm=256, num_bands=16, rows_per_band=16, storage=store)
    lsh._hash_query_words = lambda arr: _u32(a["probe_words"])
    want = lsh.get_above_p_batch(a["probe_x"], p=0.2, top_k=10, wire_dtype=row["wire_dtype"])
    assert len(want) == len(a["probe"]) == 128
    for got_q, want_q in zip(a["probe"], want):
        assert [i for i, _ in got_q] == [i for i, _ in want_q]
        np.testing.assert_allclose([s for _, s in got_q], [s for _, s in want_q], atol=1e-5)


@pytest.mark.parametrize("key", ["auto", "auto_collision", "auto_structured"])
def test_auto_engine_ids_equal_the_reference_store(runs, ref, key):
    from lshrs_tpu.storage.device import DeviceStore

    rc, (row,), a = runs[key]
    ranking = "collision" if key == "auto_collision" else "hamming"
    assert rc == 0 and row["ranking"] == a["ranking"] == ranking
    store = DeviceStore(num_bands=16, rows_per_band=16, dim=768, initial_capacity=4096,
                        dedupe=False, enable_hamming=True)
    store.add_signature_batch(a["ids"], _u32(a["words"]))
    serve = store.snapshot_query_fn(10, wire="dense", mode=ranking)
    np.testing.assert_array_equal(np.asarray(serve(a["probe_wire"])), a["probe_ids"])
    for wire, ids in zip(a["wire"], a["served"]):
        np.testing.assert_array_equal(np.asarray(serve(wire)), ids)
    # the bitplanes' bytes, counted as the reference counts them
    want = store.stats()["hamming_plane_bytes"] if ranking == "hamming" else 0
    assert row["hamming_extra_bytes"] == want == (4096 * 256 if ranking == "hamming" else 0)


def test_cp_words_and_ids_equal_the_reference(runs, ref):
    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore

    rc, (row,), a = runs["cp"]
    assert rc == 0 and row["banding"] == "32x8" and (a["bands"], a["rows"]) == (32, 8)
    X = np.random.default_rng(0).standard_normal((CP_N, 768)).astype(np.float32)
    np.testing.assert_array_equal(X[:CP_Q], a["X_keep"])
    hasher = LSHHasher(num_bands=32, rows_per_band=8, dim=768, seed=42,
                       hash_family="crosspolytope")
    # every row the script hashed (the reference's host FWHT path)
    want = hasher.hash_batch_words_host(np.concatenate([X, *a["raw"], a["fused_x"]]))
    words, raw_words, fused_words = np.split(want, [CP_N, CP_N + 2 * CP_Q])
    np.testing.assert_array_equal(_u32(a["words"]), words)
    np.testing.assert_array_equal(_u32(np.concatenate(a["raw_words"])), raw_words)
    np.testing.assert_array_equal(_u32(a["fused_words"]), fused_words)
    np.testing.assert_array_equal(_u32(a["fused_host_words"]), _u32(a["fused_words"])[:CP_N])

    store = DeviceStore(num_bands=32, rows_per_band=8, dim=768, store_vectors=True,
                        payload_dtype="int8", initial_capacity=CP_N, dedupe=False)
    store.add_signature_batch(a["ids"], words, vectors=X)
    np.testing.assert_array_equal(np.asarray(store.state_arrays()["payload"]), a["payload"])
    serve = store.snapshot_query_fn(10, wire="words")
    np.testing.assert_array_equal(np.asarray(serve(words[:CP_Q])), a["probe_ids"])
    for raw_words, ids in zip(a["raw_words"], a["served"]):
        np.testing.assert_array_equal(np.asarray(serve(_u32(raw_words))), ids)
    engine = store._resolve_rerank_engine(None, None, q=CP_Q)[0]
    assert engine == a["engine"] == row["topp_engine_resolved"]
    topp = store.snapshot_topp_fn(10, wire="words", batch_hint=CP_Q)
    for (q_words, qx), got in (((words[:CP_Q], a["X_keep"]), a["topp_probe"]),
                              ((_u32(a["raw_words"][0]), a["raw"][0]), a["topp_device"])):
        want = [np.asarray(x) for x in topp(q_words, qx)]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(got[2], want[2])


# The first check each script fails when its closure serves wrong ids.
WRONG = {
    "torch_asymmetric_bench": (RUNS["asymmetric"][1], "self_match"),
    "torch_scale_bench": (SCALE, "warm_range"),
    "torch_auto_engine_bench": (AUTO + ["--engine", "collision"], "self_match"),
    "torch_cp_bench": (RUNS["cp"][1], "self_match"),
}


@pytest.mark.parametrize("name", list(WRONG))
def test_wrong_ids_fail_the_run(monkeypatch, name):
    from lshrs_tpu_torch import DeviceStore

    real = DeviceStore.snapshot_query_fn

    def wrong(self, *a, **kw):
        serve = real(self, *a, **kw)
        if name == "torch_scale_bench":  # out of range
            return lambda q: serve(q) + self._size
        return lambda q: (serve(q) + 1) % self._size

    monkeypatch.setattr(DeviceStore, "snapshot_query_fn", wrong)
    argv, check = WRONG[name]
    rc, rows, err = _main(name, argv)
    assert rc == 1 and rows == []
    assert json.loads(err.strip().splitlines()[-1])["check_failed"] == check


def test_wrong_topp_ids_fail_the_rerank_run(monkeypatch):
    from lshrs_tpu_torch import DeviceStore

    real = DeviceStore.query_topp_batch

    def wrong(self, *a, **kw):
        ids, sims, n = real(self, *a, **kw)
        return ids[:, ::-1].copy(), sims, n

    monkeypatch.setattr(DeviceStore, "query_topp_batch", wrong)
    rc, rows, err = _main(*RUNS["rerank"])
    assert rc == 1 and rows == []
    assert json.loads(err.strip().splitlines()[-1])["check_failed"] == "self_match"


@pytest.mark.parametrize("key,check", [
    ("asymmetric", "timed_launches"),
    ("scale_scan", "scan_timed_launches"),
    ("scale_hamming", "hamming_timed_launches"),
    ("auto_collision", "collision_timed_launches"),
    ("cp", "collision_e2e_launches"),
])
def test_a_kernel_that_does_not_launch_fails_the_run(monkeypatch, key, check):
    """With launch counting forced on, the plain versions on the CPU move no
    counter: the first timed stage that needs a kernel fails its check."""
    monkeypatch.setattr(st, "counts_launches", lambda device: True)
    rc, rows, err = _main(*RUNS[key])
    assert rc == 1 and rows == []
    failed = json.loads(err.strip().splitlines()[-1])
    assert failed["check_failed"] == check and "group_max_keys" in failed["detail"]


@pytest.mark.parametrize("key", ["scale_bucket", "rerank"])
def test_a_launch_where_none_may_fails_the_run(monkeypatch, key):
    """The bucket engine and the full top-p engine launch no kernel: counted
    with none moving the run passes; a counter that moves fails it."""
    monkeypatch.setattr(st, "counts_launches", lambda device: True)
    rc, (row,), _ = _main(*RUNS[key])
    assert rc == 0 and row["launches"][st.B1] == row["launches"][st.B2] == 0
    calls = iter(range(1 << 20))  # B1's counter moves between every two reads
    monkeypatch.setattr(st, "launch_counts", lambda: {
        st.B1: next(calls), st.B2: 0, st.B3: 0, "by_packing": {}})
    rc, rows, err = _main(*RUNS[key])
    assert rc == 1 and rows == []
    assert json.loads(err.strip().splitlines()[-1])["check_failed"].endswith("timed_launches")


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
        pytest.skip("needs an NVIDIA GPU with CUDA (kernels B1 and B2 have no CPU build)")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert MOD[name].main(["--smoke"]) == 0
    (row,) = [json.loads(line) for line in out.getvalue().splitlines()]
    assert row["device"]["name"] == torch.cuda.get_device_name(0)
    assert row["peak_device_bytes"] > 0
