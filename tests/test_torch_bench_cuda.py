"""``bench_cuda.py``, the port's benchmark, at its smoke size on the CPU.

The script's one stdout line carries every metric by name with its unit;
the ids it serves at smoke size equal ``lshrs_tpu``'s on the same inputs
(the structured host hash is bit-exact across the packages, so the top-k
rows rebuild the reference from the same vectors; the 4M rows' gaussian
device hash is not, so the reference gets the same words); its quality
functions computed from the reference's ids give the values it printed;
and a failed check (wrong ids, a kernel that did not launch) ends the run
with exit code 1. The ``cuda`` case runs the smoke size on a GPU and
skips elsewhere.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import bench_cuda  # noqa: E402
from lshrs_tpu_torch import DeviceStore  # noqa: E402
from lshrs_tpu_torch.ops import group_max as gm  # noqa: E402
from lshrs_tpu_torch.ops import hamming as tham  # noqa: E402
from lshrs_tpu_torch.ops import rerank as trerank  # noqa: E402
from lshrs_tpu_torch.ops import scan as tscan  # noqa: E402

S = bench_cuda.SMOKE
# Every metric of the line, with its unit: bench.py's names and the added rows'.
METRICS = {
    "query_qps_100k_d768_p256_top10": "qps",
    "query_qps_100k_best": "qps",
    "latency_ms_per_batch": "ms",
    "self_match_rate": "fraction",
    "wire_100k": "label",
    "build_vectors_per_s": "vectors/s",
    "build_vectors_per_s_best": "vectors/s",
    "build_self_match_rate": "fraction",
    "build_stream_vectors_per_s": "vectors/s",
    "build_stream_vectors_per_s_best": "vectors/s",
    "build_1m_vectors_per_s": "vectors/s",
    "qps_1m": "qps",
    "qps_1m_best": "qps",
    "recall10_1m": "fraction",
    "planted_recall_1m": "fraction",
    "self_match_rate_1m": "fraction",
    "ranking_1m": "label",
    "qps_4m": "qps",
    "qps_4m_best": "qps",
    "self_match_rate_4m": "fraction",
    "planted_recall_4m": "fraction",
    "build_4m_s": "s",
    "cascade_4m": "label",
    "qps_4m_packed": "qps",
    "qps_4m_packed_best": "qps",
    "qps_4m_planes": "qps",
    "qps_4m_planes_best": "qps",
    "planted_recall_4m_packed": "fraction",
    "qps_1m_reranked": "qps",
    "qps_1m_reranked_best": "qps",
    "recall10_1m_reranked": "fraction",
    "rerank_engine_1m": "label",
}


def run_main(argv, answers=None) -> tuple[int, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_cuda.main(argv, answers=answers)
    return rc, out.getvalue().splitlines()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The script calls torch from three threads at once (the serving
    pipeline's hasher, dispatch and reader threads, or three submitting
    threads), and each calling thread gets its own team of intra-op
    threads: beside the suite's other workers on a loaded CPU that costs
    orders of magnitude. One intra-op thread keeps each run near its
    serial cost."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    """One smoke run of every configuration on the CPU: its exit code,
    its stdout lines and the ids it served for its checked inputs."""
    answers: dict = {}
    rc, lines = run_main(["--smoke", "--device", "cpu"], answers)
    return rc, lines, answers


@pytest.fixture(scope="module")
def extras(smoke):
    rc, lines, _ = smoke
    assert rc == 0
    return json.loads(lines[0])["extras"]


@pytest.fixture(scope="module")
def ref():
    """The reference package (the tests' conftest keeps JAX on the CPU)."""
    pytest.importorskip("lshrs_tpu")
    from lshrs_tpu import LSHRS
    from lshrs_tpu.hash.hasher import LSHHasher
    from lshrs_tpu.storage.device import DeviceStore as JaxStore

    return {"LSHRS": LSHRS, "LSHHasher": LSHHasher, "DeviceStore": JaxStore}


def test_smoke_prints_one_line_with_every_metric(smoke):
    rc, lines, _ = smoke
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extras"}
    assert line["metric"] == "query_qps_100k_d768_p256_top10" and line["unit"] == "qps"
    ex = line["extras"]
    assert line["value"] == ex[line["metric"]]
    assert line["vs_baseline"] == pytest.approx(line["value"] / 100_000.0)
    for name, unit in METRICS.items():
        assert name in ex, name
        assert ex["units"][name] == unit, name
    for name in ex["units"]:
        if ex["units"][name] in ("qps", "vectors/s"):
            assert ex["trials"][name] >= 1, name
    for config in bench_cuda.CONFIGS:
        assert f"peak_device_bytes_{config}" in ex and ex[f"seconds_{config}"] > 0
    assert ex["seed"] == 0 and ex["smoke"] is True and 0 <= ex["setup_s"] < ex["run_s"]
    assert ex["device"] == {"name": "cpu", "power_limit": None}
    assert ex["native_fwht"].startswith("loaded")
    for name in ("self_match_rate", "build_self_match_rate", "self_match_rate_1m",
                 "self_match_rate_4m", "self_match_rate_4m_packed"):
        assert ex[name] == 1.0, name
    assert ex["ranking_1m"] == "hamming" and ex["wire_100k"] == "dense"
    assert ex["cascade_4m"] == f"cascade128:{S.refine_4m}"
    # At smoke size the auto rerank engine takes the full engine (no B1).
    assert ex["rerank_engine_1m"] == "full" and ex["b1_launches_topp_1m"] is None


def _same_ids(answers: dict, serve, key: str) -> None:
    assert answers
    for name, a in answers.items():
        np.testing.assert_array_equal(np.asarray(serve(a[key])), a["ids"], err_msg=name)


def test_topk_100k_ids_equal_the_reference(smoke, ref):
    _, X = bench_cuda.gaussian_rows(0, S.n_100k)
    hasher = ref["LSHHasher"](16, 16, 768, seed=42, hash_family="structured")
    store = ref["DeviceStore"](num_bands=16, rows_per_band=16, dim=768, chunk_size=2048,
                               initial_capacity=S.capacity_100k, dedupe=False)
    store.add_signature_batch(np.arange(S.n_100k), hasher.hash_batch_dense_host(X))
    serve = store.snapshot_query_fn(10, wire="dense")
    _same_ids(smoke[2]["topk_100k"], lambda q: serve(hasher.hash_batch_dense_host(q)), "queries")


def test_topk_1m_ids_and_quality_equal_the_reference(smoke, extras, ref):
    _, _, chunks = bench_cuda.clustered(0, S.n_1m, S.step_1m)
    lsh = ref["LSHRS"](dim=768, num_perm=256, num_bands=16, rows_per_band=16, hash_mode="host",
                       hash_family="structured", initial_capacity=S.n_1m, dedupe=False,
                       buffer_size=1 << 30, engine="hamming")
    for i, x in enumerate(chunks):
        lsh.index(np.arange(i * S.step_1m, (i + 1) * S.step_1m), x)
    assert lsh.stats()["ranking"] == "hamming"
    serve = lsh.serving_fn(top_k=10)
    answers = smoke[2]["topk_1m"]
    _same_ids(answers, serve, "queries")
    planted = answers["planted"]
    np.testing.assert_array_equal(planted["queries"], bench_cuda.planted_queries(chunks[0][: S.planted_1m]))
    got = np.asarray(serve(planted["queries"]))
    assert bench_cuda.recall_at_10(got, planted["truth"]) == extras["recall10_1m"]
    assert bench_cuda.planted_recall(got) == extras["planted_recall_1m"]


def _words_4m() -> np.ndarray:
    """The 4M rows' store words at smoke size, as the bench hashes them."""
    hasher = bench_cuda.gaussian_hasher(torch.device("cpu"))
    return np.concatenate([
        hasher.hash_batch_words(x).numpy()
        for _, x in bench_cuda.draw_4m(0, S.n_4m, S.draw_4m, torch.device("cpu"))
    ]).view(np.uint32)


@pytest.mark.parametrize("config,store_kw,planted", [
    ("cascade_4m", dict(hamming_cascade=128, hamming_cascade_refine=S.refine_4m), "planted_recall_4m"),
    ("packed_4m", dict(hamming_storage="packed"), "planted_recall_4m_packed"),
    ("packed_4m", dict(), "planted_recall_4m_packed"),  # the planes twin serves the same ids
])
def test_4m_ids_and_planted_recall_equal_the_reference(smoke, extras, ref, config, store_kw, planted):
    store = ref["DeviceStore"](num_bands=16, rows_per_band=16, dim=768, initial_capacity=S.n_4m,
                               dedupe=False, enable_hamming=True, **store_kw)
    store.add_signature_batch(np.arange(S.n_4m), _words_4m())
    serve = store.snapshot_query_fn(10, mode="hamming", wire="words")
    answers = smoke[2][config]
    _same_ids(answers, lambda w: serve(w.view(np.uint32)), "words")
    got = np.asarray(serve(answers["planted"]["words"].view(np.uint32)))
    assert bench_cuda.planted_recall(got) == extras[planted]


def test_topp_recall_is_computed_from_the_served_ids(smoke, extras):
    a = smoke[2]["topp_1m_int8"]["clustered"]
    _, _, chunks = bench_cuda.clustered(0, S.n_1m, S.step_1m)
    np.testing.assert_array_equal(a["truth"], bench_cuda.exact_top10(a["queries"], chunks, torch.device("cpu")))
    assert bench_cuda.recall_at_10(a["ids"], a["truth"]) == extras["recall10_1m_reranked"]


def test_exact_top10_equals_float64_brute_force():
    rng = np.random.default_rng(3)
    chunks = [rng.standard_normal((n, 768), dtype=np.float32) for n in (50, 7, 64)]
    q = rng.standard_normal((16, 768), dtype=np.float32)
    q[:3] = chunks[0][:3]  # exact self-matches
    got = bench_cuda.exact_top10(q, chunks, torch.device("cpu"))
    x = np.concatenate(chunks).astype(np.float64)
    q64 = q.astype(np.float64)
    s = (q64 / np.linalg.norm(q64, axis=1, keepdims=True)) @ (x / np.linalg.norm(x, axis=1, keepdims=True)).T
    want = np.argsort(-s, axis=1, kind="stable")[:, :10]
    assert got.shape == want.shape == (16, 10)
    rows = np.arange(16)[:, None]
    assert np.all((got == want) | (np.abs(s[rows, got] - s[rows, want]) < 1e-6))
    assert (got[:3, 0] == np.arange(3)).all()


def test_quality_functions():
    ids = np.array([[0, 5, -1], [3, 4, 2]], dtype=np.int32)
    assert bench_cuda.planted_recall(ids) == 0.5
    assert bench_cuda.self_match(ids, np.array([0, 1])) == 0.5
    truth = np.array([[5, 0, 9, 10, 11, 12, 13, 14, 15, 16], [1, 2, 3, 4, 6, 7, 8, 9, 10, 11]])
    assert bench_cuda.recall_at_10(ids, truth) == pytest.approx((2 + 3) / 20)


def test_import_leaves_jax_and_the_reference_out():
    code = (
        "import sys, bench_cuda; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'lshrs_tpu.'))"
        " or m == 'lshrs_tpu']; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("config,check", [
    ("topk_100k", "self_match_rate"),
    ("topk_1m", "self_match_rate_1m"),
    ("cascade_4m", "self_match_rate_4m"),
    ("packed_4m", "self_match_rate_4m_packed"),
])
def test_wrong_ids_fail_the_run(monkeypatch, capsys, config, check):
    """A serving closure that returns wrong ids makes the run exit 1,
    naming the check; nothing is printed on stdout."""
    real = DeviceStore.snapshot_query_fn

    def wrong(self, *a, **kw):
        serve = real(self, *a, **kw)
        return lambda q: (serve(q) + 1) % self._size

    monkeypatch.setattr(DeviceStore, "snapshot_query_fn", wrong)
    rc = bench_cuda.main(["--smoke", "--device", "cpu", "--config", config])
    out, err = capsys.readouterr()
    assert rc == 1 and out == ""
    assert json.loads(err.strip().splitlines()[-1])["check_failed"] == check


def _counting(monkeypatch, name: str, key=None) -> None:
    """Replace kernel wrapper ``name`` (in ``ops.group_max`` and every
    module that calls it) by one that counts its calls as launches, the
    way the CUDA wrappers count theirs."""
    real = getattr(gm, name)

    def wrapper(*a, **kw):
        wrapper.launches += 1
        if key is not None:
            wrapper.launches_by_packing[key(*a, **kw)] += 1
        return real(*a, **kw)

    wrapper.launches = 0
    wrapper.launches_by_packing = collections.Counter()
    for module in (gm, tscan, tham, trerank):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, wrapper)


def _b2_packing(planes, tie, qbits, *, offset=None, shift=1, num_perm=None, **_):
    width = planes.shape[1]
    return width, gm._hamming_offset(width, offset, num_perm), shift


@pytest.mark.parametrize("config,check", [
    ("topk_100k", "topk_100k_group_max_keys_launched"),
    ("topk_1m", "topk_1m_hamming_group_max_keys_launched"),
    ("cascade_4m", "cascade_4m_cascade_coarse_launched"),
    ("packed_4m", "packed_4m_packed_hamming_packed_group_max_keys_launched"),
])
@pytest.mark.parametrize("counted", [False, True])
def test_a_launch_counter_that_does_not_move_fails_the_run(monkeypatch, capsys, config, check, counted):
    """Where launches are counted, a kernel whose counter does not move
    fails the run; with the calls counted as launches it passes."""
    monkeypatch.setattr(bench_cuda, "counts_launches", lambda device: True)
    if counted:
        _counting(monkeypatch, "group_max_keys")
        _counting(monkeypatch, "hamming_group_max_keys", _b2_packing)
        _counting(monkeypatch, "hamming_packed_group_max_keys")
    rc = bench_cuda.main(["--smoke", "--device", "cpu", "--config", config])
    out, err = capsys.readouterr()
    if counted:
        assert rc == 0 and len(out.splitlines()) == 1
        launches = json.loads(out)["extras"][f"launches_{config}"]
        assert all(n >= 1 for n in launches.values()), launches
    else:
        assert rc == 1 and out == ""
        assert json.loads(err.strip().splitlines()[-1])["check_failed"] == check


@pytest.mark.cuda
def test_smoke_on_the_card():
    """Every configuration at smoke size on the GPU: exit 0, every kernel
    of each top-k row launched, the card named."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (kernels B1/B2/B3 have no CPU build)")
    rc, lines = run_main(["--smoke"])
    assert rc == 0 and len(lines) == 1
    ex = json.loads(lines[0])["extras"]
    assert ex["device"]["name"] == torch.cuda.get_device_name(0)
    assert ex["launches_topk_100k"]["group_max_keys"] >= S.batches_100k * S.trials_100k
    assert ex["launches_topk_1m"]["hamming_group_max_keys"] >= S.batches * S.trials
    assert ex["launches_cascade_4m"]["cascade_coarse"] >= S.batches * S.trials
    assert ex["launches_packed_4m"]["packed"] >= S.batches * S.trials
    assert all(ex[f"peak_device_bytes_{c}"] > 0 for c in bench_cuda.CONFIGS)
