"""The port's four maintenance benches at a small size on the CPU.

``benchmarks/torch_{rehash_bench,ingest_bench,sharded_build_bench,ab_serving}.py``
run with ``--device cpu`` (the kernels' plain versions). Each exits 0 and
prints every field of its reference script. Then each is held to
``lshrs_tpu`` on the same words: the rehashed words equal a fresh build
under the final hasher (float32), and the self-match ids equal a
``lshrs_tpu`` store fed the port store's words, at every payload dtype;
the ingested words, ids and tie column equal a ``lshrs_tpu`` store fed the
same dense wire; the single and the 8-shard stores' spot check equals
``lshrs_tpu``'s sharded store on its 8 virtual CPU devices; both selection
variants of the A/B serve ``lshrs_tpu``'s ``snapshot_query_fn(10,
wire="dense")`` ids, and the torch ``topk_wide`` and hierarchy equal the
reference's functions in values and positions. Wrong ids or words, a
launch counter that does not move where a kernel must launch (or moves
where none may), and ``--device cuda`` without a card each end the run
with exit 1. The ``cuda`` cases run each script's ``--smoke`` on a GPU and
skip elsewhere.
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
NAMES = ("torch_rehash_bench", "torch_ingest_bench", "torch_sharded_build_bench",
         "torch_ab_serving")


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "benchmarks" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


MOD = {name: _load(name) for name in NAMES}
st = MOD["torch_rehash_bench"].st
AB = MOD["torch_ab_serving"]

REHASH_N, INGEST_N, SHARDED_N, AB_N, AB_Q = 4096, 8192, 16384, 4096, 32
BATCH = 2048
REHASH = ["--n", str(REHASH_N), "--trials", "3"]
INGEST = ["--n", str(INGEST_N), "--batch", str(BATCH), "--trials", "1"]
SHARDED = ["--n", str(SHARDED_N), "--batch", str(BATCH)]
AB_ARGS = ["--n", str(AB_N), "--q", str(AB_Q), "--trials", "2", "--batches", "2"]
RUNS = {
    "rehash_float32": ("torch_rehash_bench", REHASH),
    "rehash_bfloat16": ("torch_rehash_bench", REHASH + ["--payload-dtype", "bfloat16"]),
    "rehash_int8": ("torch_rehash_bench", REHASH + ["--payload-dtype", "int8"]),
    "ingest": ("torch_ingest_bench", INGEST),
    "sharded": ("torch_sharded_build_bench", SHARDED),
    "ab": ("torch_ab_serving", AB_ARGS),
}
# Every field the reference script prints, and the fields each port row adds.
REFERENCE_FIELDS = {
    "torch_rehash_bench": ["n", "dim", "payload_dtype", "initial_build_s", "rehash_s_best",
                           "rehash_s_median", "rehash_rows_per_s", "self_match", "platform"],
    "torch_ingest_bench": ["metric", "n", "num_perm", "batch", "build_s", "vectors_per_s",
                           "wire_bytes_per_vector", "platform"],
    "torch_sharded_build_bench": ["n", "single_build_s", "sharded8_build_s", "ratio", "platform",
                                  "note"],
    "torch_ab_serving": ["metric", "n", "q_batch", "trials", "flat_qps_best", "flat_qps_median",
                         "wide_qps_best", "wide_qps_median", "wide_over_flat_best",
                         "wide_over_flat_median", "platform"],
}
ADDED = ["launches", "seconds", "peak_device_bytes", "device"]


def _main(name, argv, answers=None):
    """Run a script on the CPU: exit code, its JSON lines, its stderr."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = MOD[name].main([*argv, "--device", "cpu"], answers=answers)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()], err.getvalue()


def _failed(err: str) -> dict:
    return json.loads(err.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The A/B calls torch from three threads at once (the hasher, the
    dispatch and the reader thread), and each calling thread gets its own
    team of intra-op threads: beside the suite's other workers on a loaded
    CPU that costs orders of magnitude. One intra-op thread keeps each run
    near its serial cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """Each run: exit code, printed rows, the answers the script recorded."""
    done = {}
    with pytest.MonkeyPatch.context() as mp:
        # the A/B's device timing is the host's clock here: one call a trial
        mp.setattr(AB, "DEVICE_N_ITER", 1)
        mp.setattr(AB, "DEVICE_TRIALS", 1)
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
    launches = row["launches"]  # the CPU counts nothing
    assert launches is None or all(v is None for v in launches.values())
    assert row["platform"].startswith("cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_rehash_ids_equal_the_reference_store(runs, ref, dtype):
    from lshrs_tpu.storage.device import DeviceStore

    rc, (row,), a = runs[f"rehash_{dtype}"]
    assert rc == 0 and row["payload_dtype"] == dtype
    assert row["banding"] == "32x8" and a["bands"] == (32, 8)  # 3 trials end at 32 x 8
    assert len(row["rehash_s"]) == 3 and row["rehash_s_best"] == min(row["rehash_s"])
    rebuild = row["rebuild_after_rehash"]
    for name in ("first_query", "repeat_query", "warm_first_query", "warm_repeat_query"):
        assert rebuild[f"{name}_s"] > 0
    assert rebuild["rebuild_s"] == rebuild["warm_first_query_s"] - rebuild["warm_repeat_query_s"]
    store = DeviceStore(num_bands=32, rows_per_band=8, initial_capacity=REHASH_N, dedupe=False)
    store.add_signature_batch(np.arange(REHASH_N), _u32(a["words"]))
    _, ids = store.query_topk(_u32(a["qwords"]), 1)
    np.testing.assert_array_equal(np.asarray(ids), a["ids"])
    assert row["self_match"] == float((np.asarray(ids)[:, 0] == np.arange(1024)).mean())
    if dtype == "float32":
        assert row["self_match"] == 1.0


def test_rehash_words_equal_a_fresh_build(runs):
    from lshrs_tpu_torch import DeviceStore
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    rc, _, a = runs["rehash_float32"]
    assert rc == 0
    X = np.random.default_rng(0).standard_normal((REHASH_N, 256)).astype(np.float32)
    h = LSHHasher(num_bands=32, rows_per_band=8, dim=256, seed=2, device="cpu")
    fresh = DeviceStore(num_bands=32, rows_per_band=8, dim=256, store_vectors=True,
                        dedupe=False, initial_capacity=REHASH_N, device="cpu")
    fresh.add_vectors_batch(np.arange(REHASH_N), X, h.device_projection())
    np.testing.assert_array_equal(fresh.state_arrays()["sig"], a["words"])
    np.testing.assert_array_equal(_u32(a["qwords"]), h.hash_batch_words_host(X[:1024]))


def test_ingest_store_equals_the_reference_store(runs, ref):
    from lshrs_tpu.storage.device import DeviceStore

    rc, (row,), a = runs["ingest"]
    assert rc == 0 and row["wire_bytes_per_vector"] == 32 and len(row["trials_s"]) == 2
    assert a["wire"].shape == (INGEST_N, 32) and a["wire"].dtype == np.uint8
    store = DeviceStore(num_bands=16, rows_per_band=16, initial_capacity=INGEST_N, dedupe=False)
    for start in range(0, INGEST_N, BATCH):
        store.add_signature_batch(np.arange(start, start + BATCH), a["wire"][start:start + BATCH])
    assert store._capacity == a["capacity"] == INGEST_N
    want = store.state_arrays()
    np.testing.assert_array_equal(_u32(a["words"]), want["sig"])
    np.testing.assert_array_equal(a["ids"], want["ids"])
    store._ensure_ranks()
    np.testing.assert_array_equal(a["tie"], np.asarray(store._tie)[:INGEST_N])


def test_host_decode_equals_the_host_words():
    """The ingest check's NumPy decode of the wire gives the words the host
    hash packs from the same sign bits."""
    from lshrs_tpu_torch.hash.hasher import LSHHasher

    for rows in (16, 8, 12):
        h = LSHHasher(num_bands=4, rows_per_band=rows, dim=32, seed=3, device="cpu")
        X = np.random.default_rng(rows).standard_normal((64, 32)).astype(np.float32)
        got = MOD["torch_ingest_bench"].decode_dense_np(
            h.hash_batch_dense_host(X), num_bands=4, rows_per_band=rows)
        np.testing.assert_array_equal(got, h.hash_batch_words_host(X))


def test_sharded_spot_check_equals_the_reference_sharded_store(runs, ref):
    from lshrs_tpu.parallel import ShardedDeviceStore, make_mesh
    from lshrs_tpu.storage.device import DeviceStore

    rc, (row,), a = runs["sharded"]
    assert rc == 0 and row["capacity"] == {"single": SHARDED_N, "sharded": SHARDED_N,
                                           "rows_per_shard": SHARDED_N // 8}
    np.testing.assert_array_equal(a["ids"], a["single_ids"])
    assert row["single_warm_build_s"] > 0 and row["ratio_to_warm_single"] > 0
    kw = dict(num_bands=16, rows_per_band=16, initial_capacity=SHARDED_N, dedupe=False)
    for store in (ShardedDeviceStore(mesh=make_mesh(8), **kw), DeviceStore(**kw)):
        for start in range(0, SHARDED_N, BATCH):
            store.add_signature_batch(np.arange(start, start + BATCH),
                                      _u32(a["words"][start:start + BATCH]))
        assert store._capacity == a["capacity"]
        counts, ids = store.query_topk(_u32(a["qwords"]), 5)
        np.testing.assert_array_equal(np.asarray(ids), a["ids"])
        np.testing.assert_array_equal(np.asarray(counts), a["counts"])
    assert (a["ids"][:, 0] == np.arange(4)).all()


def test_ab_ids_equal_the_reference_store(runs, ref):
    from lshrs_tpu.storage.device import DeviceStore

    rc, (row,), a = runs["ab"]
    assert rc == 0 and row["group_columns"] == 2048 and a["capacity"] == 1 << 17
    assert row["wide_route"].startswith("hierarchy: 16 superchunks of 128 -> top 10")
    store = DeviceStore(num_bands=16, rows_per_band=16, dim=768, chunk_size=2048,
                        initial_capacity=1 << 17, dedupe=False)
    store.add_signature_batch(np.arange(AB_N), _u32(a["words"]))
    serve = store.snapshot_query_fn(10, wire="dense")
    np.testing.assert_array_equal(np.asarray(serve(a["wires"][0])), a["warm"])
    assert len(a["ids"]) == 2
    for wire, ids in zip(a["wires"], a["ids"]):
        np.testing.assert_array_equal(np.asarray(serve(wire)), ids)
    probe = np.asarray(serve(a["probe_wire"]))
    assert (probe[:, 0] == np.arange(AB_Q)).all()


def _distinct_keys(q: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(np.arange(-(1 << 31), (1 << 31) - 1, 4099, dtype=np.int64),
                                width, replace=False) for _ in range(q)]).astype(np.int32)


WIDTHS, MS = (100, 1024, 2048, 5000), (1, 10, 64)


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("width", WIDTHS)
def test_topk_wide_equals_the_reference(ref, width, m):
    import jax.numpy as jnp

    from lshrs_tpu.ops.scan import topk_wide

    key = _distinct_keys(3, width, width + m)
    want_v, want_p = topk_wide(jnp.asarray(key), m)
    got_v, got_p = AB.topk_wide(torch.from_numpy(key), m)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("width", WIDTHS)
def test_hierarchy_equals_the_reference(ref, width, m):
    import jax.numpy as jnp

    from lshrs_tpu.ops.scan import _hierarchical_top_groups

    key = _distinct_keys(3, width, 7 * width + m)
    want = _hierarchical_top_groups(jnp.asarray(key), m=m, ngc=None)
    got = AB.hierarchical_top_groups(torch.from_numpy(key), m=m)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_topk_wide_ties_inside_a_block(ref):
    """Equal keys inside each 256-column block (blocks distinct from each
    other): the lower position wins, as the reference's does."""
    import jax.numpy as jnp

    from lshrs_tpu.ops.scan import topk_wide

    rng = np.random.default_rng(5)
    width = 2048
    block_of = np.arange(width) // 256
    key = (rng.permutation(8)[block_of] * 100 + rng.integers(0, 3, (4, width))).astype(np.int32)
    for m in (1, 10, 64):
        want_v, want_p = topk_wide(jnp.asarray(key), m)
        got_v, got_p = AB.topk_wide(torch.from_numpy(key), m)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))


def test_wide_selection_is_swapped_in_only_inside_the_block():
    import lshrs_tpu_torch.ops.scan as scan_mod

    real, calls = scan_mod.select_top_groups, []
    gmax = torch.from_numpy(_distinct_keys(2, 2048, 1))
    with AB.wide_selection(calls):
        got = scan_mod.select_top_groups(gmax, 10)
    assert scan_mod.select_top_groups is real and calls == [(2, 2048)]
    np.testing.assert_array_equal(got.numpy(), real(gmax, 10).numpy())


def _wrong_query_topk(mp, cls):
    real = cls.query_topk

    def wrong(self, *a, **kw):
        counts, ids = real(self, *a, **kw)
        return counts, np.where(ids >= 0, (ids + 1) % self._size, ids)

    mp.setattr(cls, "query_topk", wrong)


def _wrong_snapshot(mp):
    from lshrs_tpu_torch import DeviceStore

    real = DeviceStore.snapshot_query_fn

    def wrong(self, *a, **kw):
        serve = real(self, *a, **kw)
        return lambda q: (serve(q) + 1) % self._size

    mp.setattr(DeviceStore, "snapshot_query_fn", wrong)


def _wrong_words(mp):
    from lshrs_tpu_torch import DeviceStore

    real = DeviceStore._decode_words
    mp.setattr(DeviceStore, "_decode_words", lambda self, w, n: real(self, w, n) ^ 1)


def _wrong_wide(mp):
    mp.setattr(AB, "hierarchical_top_groups", lambda gmax, *, m: torch.zeros(
        (gmax.shape[0], m), dtype=torch.int64))


def _wrong_sharded(mp):
    from lshrs_tpu_torch.parallel import ShardedDeviceStore

    _wrong_query_topk(mp, ShardedDeviceStore)


def _wrong_rehash(mp):
    from lshrs_tpu_torch import DeviceStore

    _wrong_query_topk(mp, DeviceStore)


# What each case breaks, the script it runs, and the first check that fails.
WRONG = {
    "rehash_ids": (_wrong_rehash, "rehash_float32", "self_match"),
    "ingest_words": (_wrong_words, "ingest", "stored_words"),
    "sharded_ids": (_wrong_sharded, "sharded", "spot_check"),
    "ab_ids": (_wrong_snapshot, "ab", "flat_self_match"),
    "ab_wide_groups": (_wrong_wide, "ab", "warm_equal"),
}


@pytest.mark.parametrize("case", list(WRONG))
def test_wrong_answers_fail_the_run(monkeypatch, case):
    patch, key, check = WRONG[case]
    patch(monkeypatch)
    rc, rows, err = _main(*RUNS[key])
    assert rc == 1 and rows == []
    assert _failed(err)["check_failed"] == check


@pytest.mark.parametrize("key,check", [
    ("rehash_int8", "first_query_launches"),
    ("sharded", "single_spot_launches"),
    ("ab", "flat_timed_launches"),
])
def test_a_kernel_that_does_not_launch_fails_the_run(monkeypatch, key, check):
    """With launch counting forced on, the plain versions on the CPU move no
    counter: the first stage that needs B1 fails its check (the stages
    before it, which may launch nothing, pass)."""
    monkeypatch.setattr(st, "counts_launches", lambda device: True)
    rc, rows, err = _main(*RUNS[key])
    assert rc == 1 and rows == []
    failed = _failed(err)
    assert failed["check_failed"] == check and "group_max_keys" in failed["detail"]


@pytest.mark.parametrize("key,check", [
    ("rehash_float32", "build_launches"),
    ("ingest", "trial_launches"),
    ("sharded", "single_build_launches"),
])
def test_a_launch_where_none_may_fails_the_run(monkeypatch, key, check):
    """The builds, the rehashes and the ingest launch no kernel: a counter
    that moves there fails the run."""
    monkeypatch.setattr(st, "counts_launches", lambda device: True)
    calls = iter(range(1 << 20))  # B1's counter moves between every two reads
    monkeypatch.setattr(st, "launch_counts", lambda: {
        st.B1: next(calls), st.B2: 0, st.B3: 0, "by_packing": {}})
    rc, rows, err = _main(*RUNS[key])
    assert rc == 1 and rows == []
    assert _failed(err)["check_failed"] == check


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
        pytest.skip("needs an NVIDIA GPU with CUDA (kernel B1 has no CPU build)")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert MOD[name].main(["--smoke"]) == 0
    (row,) = [json.loads(line) for line in out.getvalue().splitlines()]
    assert row["device"]["name"] == torch.cuda.get_device_name(0)
    assert row["peak_device_bytes"] > 0
