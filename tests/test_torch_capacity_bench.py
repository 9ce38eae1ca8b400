"""``benchmarks/torch_capacity_bench.py`` at a small size on the CPU.

For every engine — the grouped exact engine, the chunked exact engine
(forced by replacing ``supports_hamming_grouped`` in both packages'
``storage.device``, as ``tests/test_torch_chunked.py`` does), cascade128
and cascade64 — the ids the script served for its self-match probe, its
planted probe and its timed batches equal those of a ``lshrs_tpu``
``DeviceStore`` with the same cascade, refine pool, group and capacity,
built from the port store's own words. Self-match is 1.0; planted recall
and agreement recomputed from the ids equal the printed values; the
per-chunk draws depend on ``(seed, offset)`` alone; and wrong ids or a
launch counter that does not move end the run with exit code 1. The
``cuda`` case runs ``--smoke`` on a GPU and skips elsewhere.
"""

from __future__ import annotations

import collections
import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "torch_capacity_bench", REPO / "benchmarks" / "torch_capacity_bench.py")
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

import lshrs_tpu_torch.storage.device as tdevice  # noqa: E402
from lshrs_tpu_torch import DeviceStore  # noqa: E402

SLOTS = 4096
RUN = ["--smoke", "--device", "cpu", "--slots", str(SLOTS), "--q", "64", "--trials", "1"]
# The chunked run serves in ragged 100-query slices of the 256-row probe.
CHUNKED = ["--engines", "exact", "--dev-batch", "100"]


def _main(argv, answers=None) -> tuple[int, list[dict]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv, answers=answers)
    return rc, [json.loads(line) for line in out.getvalue().splitlines()]


def _force_chunked(mp, *modules) -> None:
    for module in modules:
        mp.setattr(module, "supports_hamming_grouped", lambda *a: False)


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
def runs():
    """The grouped run (every engine) and the forced chunked run: exit
    code, printed rows and the answers recorded per (slots, engine)."""
    grouped_answers, chunked_answers = {}, {}
    grouped = _main(RUN, grouped_answers)
    with pytest.MonkeyPatch.context() as mp:
        _force_chunked(mp, tdevice)
        chunked = _main(RUN + CHUNKED, chunked_answers)
    return {"grouped": (*grouped, grouped_answers), "chunked": (*chunked, chunked_answers)}


def test_rows_and_summary(runs):
    for name, (rc, lines, _) in runs.items():
        assert rc == 0, name
        rows, summary = lines[:-1], lines[-1]
        assert summary == {"summary": rows}
        for row in rows:
            for key in ("slots", "engine", "group", "dev_batch", "capacity", "qps", "qps_median",
                        "ms_per_batch", "self_match", "planted_recall_at_10", "build_s",
                        "plane_bytes", "route", "launches", "device"):
                assert key in row, key
            assert row["self_match"] == 1.0 and row["capacity"] == 1 << 17
            assert row["device"] == {"name": "cpu", "power_limit": None}
            assert row["launches"] is None  # nothing is counted on the CPU
    rows = runs["grouped"][1][:-1]
    assert [(r["engine"], r["route"]) for r in rows] == [
        ("exact", "grouped"), ("cascade128:8192", "cascade"), ("cascade64:8192", "cascade")]
    assert [r["plane_bytes"] for r in rows] == [(1 << 17) * 256, (1 << 17) * 128, (1 << 17) * 64]
    chunked = runs["chunked"][1][0]
    assert (chunked["route"], chunked["dev_batch"]) == ("chunked", 100)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    import lshrs_tpu.storage.device as jdevice

    return jdevice


@pytest.mark.parametrize("run,engine", [
    ("grouped", "exact"), ("chunked", "exact"),
    ("grouped", "cascade128:8192"), ("grouped", "cascade64:8192"),
])
def test_served_ids_equal_the_reference_store(runs, ref, run, engine):
    _, lines, answers = runs[run]
    a = answers[SLOTS, engine]
    row = next(r for r in lines[:-1] if r["engine"] == engine)
    with pytest.MonkeyPatch.context() as mp:
        if run == "chunked":
            _force_chunked(mp, ref)
        store = ref.DeviceStore(
            num_bands=16, rows_per_band=16, dim=768, enable_hamming=True,
            hamming_cascade=a["cascade"], hamming_cascade_refine=a["refine"],
            group_size=a["group"], initial_capacity=a["capacity"], dedupe=False)
        store.add_signature_batch(np.arange(SLOTS), a["words"])
        assert store._capacity == a["capacity"]
        serve = store.snapshot_query_fn(10, mode="hamming", wire="words", dev_batch=row["dev_batch"])

        def served(words):
            return np.asarray(serve(np.asarray(words).view(np.uint32)))

        np.testing.assert_array_equal(served(a["self_words"]), a["self_ids"])
        np.testing.assert_array_equal(served(a["probe_words"]), a["probe_ids"])
        for words, ids in zip(a["raw"], a["raw_ids"]):
            np.testing.assert_array_equal(served(words), ids)
    assert (a["self_ids"][:, 0] == np.arange(len(a["self_ids"]))).all()
    planted = float((a["probe_ids"] == np.arange(len(a["probe_ids"]))[:, None]).any(axis=1).mean())
    assert planted == row["planted_recall_at_10"]
    if engine != "exact":
        exact = answers[SLOTS, "exact"]["probe_ids"]
        agree = np.mean([len(set(exact[i]) & set(a["probe_ids"][i])) / 10 for i in range(len(exact))])
        assert float(agree) == row["agreement_at_10_vs_exact"]


def test_draws_depend_on_seed_and_offset_only():
    cpu = torch.device("cpu")
    a = bench.draw_chunk(7, 1 << 19, 64, cpu)
    bench.draw_chunk(7, 0, 999, cpu)  # another chunk in between changes nothing
    assert torch.equal(a, bench.draw_chunk(7, 1 << 19, 64, cpu))
    assert torch.equal(a[:10], bench.draw_chunk(7, 1 << 19, 10, cpu))
    assert not torch.equal(a, bench.draw_chunk(7, 0, 64, cpu))
    assert not torch.equal(a, bench.draw_chunk(8, 1 << 19, 64, cpu))
    assert a.dtype == torch.float32 and a.shape == (64, bench.DIM)


def test_capacity_and_engine_parsing():
    assert bench.capacity_of(100) == 1 << 17
    assert bench.capacity_of(1 << 22) == 1 << 22
    assert bench.capacity_of(12_500_000) == 1 << 24
    assert bench.parse_engine("exact") == (0, 2048)
    assert bench.parse_engine("cascade128") == (128, 2048)
    assert bench.parse_engine("cascade64:8192") == (64, 8192)
    with pytest.raises(ValueError):
        bench.parse_engine("approx")


SMALL = ["--smoke", "--device", "cpu", "--slots", "2048", "--q", "32", "--batches", "1", "--trials", "1"]


@pytest.mark.parametrize("engine", ["exact", "cascade128:8192"])
def test_wrong_ids_fail_the_run(monkeypatch, capsys, engine):
    real = DeviceStore.snapshot_query_fn

    def wrong(self, *a, **kw):
        serve = real(self, *a, **kw)
        return lambda q: (serve(q) + 1) % self._size

    monkeypatch.setattr(DeviceStore, "snapshot_query_fn", wrong)
    rc = bench.main(SMALL + ["--engines", engine])
    out, err = capsys.readouterr()
    assert rc == 1 and "summary" not in out
    assert json.loads(err.strip().splitlines()[-1])["check_failed"].startswith("self_match_")


def _counting(monkeypatch, name: str) -> None:
    """Replace kernel wrapper ``name`` (in ``ops.group_max`` and every
    module that calls it) by one that counts its calls as launches, B2's
    also by key packing."""
    from lshrs_tpu_torch.ops import group_max as gm
    from lshrs_tpu_torch.ops import hamming as tham

    real = getattr(gm, name)

    def wrapper(*a, **kw):
        wrapper.launches += 1
        if name == bench.B2:
            planes = a[0]
            width = planes.shape[1]
            wrapper.launches_by_packing[
                width, gm._hamming_offset(width, kw.get("offset"), kw.get("num_perm")),
                kw.get("shift", 1)] += 1
        return real(*a, **kw)

    wrapper.launches = 0
    wrapper.launches_by_packing = collections.Counter()
    for module in (gm, tham):
        if hasattr(module, name):
            monkeypatch.setattr(module, name, wrapper)


@pytest.mark.parametrize("engine,check", [
    ("exact", "grouped_exact_launches_b2"),
    ("cascade128:8192", "cascade128_launches_b2_coarse"),
    ("cascade64:8192", "cascade64_launches_b2_coarse"),
])
@pytest.mark.parametrize("counted", [False, True])
def test_a_launch_counter_that_does_not_move_fails_the_run(monkeypatch, capsys, engine, check,
                                                           counted):
    monkeypatch.setattr(bench, "counts_launches", lambda device: True)
    if counted:
        for name in (bench.B1, bench.B2, bench.B3):
            _counting(monkeypatch, name)
    rc = bench.main(SMALL + ["--engines", engine])
    out, err = capsys.readouterr()
    if counted:
        assert rc == 0
        row = json.loads(out.splitlines()[0])
        assert row["launches"][bench.B2] >= 1
        if engine != "exact":
            assert row["launches"]["cascade_coarse"] >= 1
    else:
        assert rc == 1 and out == ""
        assert json.loads(err.strip().splitlines()[-1])["check_failed"] == check


def test_a_launch_on_the_chunked_route_fails_the_run(monkeypatch, capsys):
    """The chunked exact engine launches no kernel: one counted there fails
    the run; none counted passes."""
    monkeypatch.setattr(bench, "counts_launches", lambda device: True)
    _force_chunked(monkeypatch, tdevice)
    rc = bench.main(SMALL + ["--engines", "exact"])
    out, _ = capsys.readouterr()
    assert rc == 0 and json.loads(out.splitlines()[0])["launches"][bench.B2] == 0
    calls = iter(range(1 << 20))  # B2's counter moves between every two reads
    monkeypatch.setattr(bench, "kernel_launches", lambda: {
        bench.B1: 0, bench.B2: next(calls), bench.B3: 0, "by_packing": {}})
    rc = bench.main(SMALL + ["--engines", "exact"])
    _, err = capsys.readouterr()
    assert rc == 1
    assert json.loads(err.strip().splitlines()[-1])["check_failed"] == "chunked_exact_launches_no_kernel"


@pytest.mark.cuda
def test_smoke_on_the_card():
    """``--smoke`` on the GPU: every engine at 2**14 and 2**23 slots, B2 on
    the grouped, the blocked and the cascade routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (kernel B2 has no CPU build)")
    rc, lines = _main(["--smoke"])
    assert rc == 0
    rows = lines[:-1]
    assert [(r["slots"], r["route"]) for r in rows] == [
        (1 << 14, "grouped"), (1 << 14, "cascade"), (1 << 14, "cascade"),
        (1 << 23, "blocked"), (1 << 23, "cascade"), (1 << 23, "cascade")]
    for r in rows:
        assert r["self_match"] == 1.0
        assert r["device"]["name"] == torch.cuda.get_device_name(0)
