"""CPU tests of the span split (`perfbench.spans`) and its five readers, on
made-up events; and of `devtrace.summarize` on the same events, pinned."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import devtrace, harness, spans
from perfbench.harness import Run

ROOT = Path(harness.__file__).resolve().parents[1]
SPEC = harness.load_spec(ROOT)

B2 = "void hamming_group_max_kernel<64, false>(CUtensorMap_st, CUtensorMap_st)"
UP = "Memcpy HtoD (Pageable -> Device)"
DOWN = "Memcpy DtoH (Device -> Pageable)"

WINDOW = (0, 1000)
# One request: the program's spans on the window's thread.
SPANS = [(100, 900, "lshrs.serve"), (120, 300, "lshrs.hash"), (320, 800, "lshrs.engine"),
         (330, 400, "lshrs.b2"), (420, 500, "lshrs.select"), (810, 890, "lshrs.download")]
# Runtime calls: (start, end, name, correlation id).
LAUNCHES = [(130, 135, "cudaMemcpyAsync", 1), (200, 205, "cudaLaunchKernel", 2),
            (340, 345, "cuLaunchKernel", 3), (450, 455, "cudaLaunchKernel", 4),
            (600, 605, "cudaLaunchKernel", 5), (820, 825, "cudaMemcpyAsync", 6),
            (50, 55, "cudaLaunchKernel", 7)]
# Device operations: (start, end, name, correlation id); 99 has no launch.
DEVICE = [(140, 180, UP, 1), (200, 260, "mm", 2), (350, 500, B2, 3), (500, 560, "radix", 4),
          (610, 650, "elementwise", 5), (830, 860, DOWN, 6), (60, 90, "harness", 7),
          (900, 950, "mystery", 99)]


def _split() -> spans.SpanTrace:
    return spans.attribute(DEVICE, {c: s for s, _, _, c in LAUNCHES}, SPANS, WINDOW)


def _ns(row: spans.Row) -> tuple:
    return (round(row.device_s * 1e9), round(row.copy_s * 1e9), row.ops, round(row.idle_s * 1e9))


def test_the_split_by_span_of_a_made_up_request():
    t = _split()
    assert t.names == {n for _, _, n in SPANS}
    # Gaps, divided among the spans they overlap: 0-60 (outside 60),
    # 90-140 (outside 10, serve 20, hash 20), 180-200 (hash 20), 260-350
    # (hash 40, serve 20, engine 10, b2 20), 560-610 (engine 50), 650-830
    # (engine 150, serve 10, download 20), 860-900 (download 30, serve 10),
    # 950-1000 (outside 50).
    assert {k: _ns(v) for k, v in t.inner.items()} == {
        "lshrs.hash": (100, 40, 2, 80),
        "lshrs.b2": (150, 0, 1, 20),
        "lshrs.select": (60, 0, 1, 0),
        "lshrs.engine": (40, 0, 1, 210),
        "lshrs.download": (30, 30, 1, 50),
        "lshrs.serve": (0, 0, 0, 60),
        spans.OUTSIDE: (30, 0, 1, 120),
        spans.UNATTRIBUTED: (50, 0, 1, 0),
    }
    total = {k: _ns(v) for k, v in t.total.items()}
    assert total["lshrs.serve"] == (380, 70, 6, 420)
    assert total["lshrs.engine"] == (250, 0, 3, 230)
    # The host's time in each span: its own, and all of it.
    assert {k: round(v.host_s * 1e9) for k, v in t.inner.items() if v.host_s} == {
        "lshrs.serve": 20 + 20 + 10 + 10, "lshrs.hash": 180, "lshrs.engine": 480 - 70 - 80,
        "lshrs.b2": 70, "lshrs.select": 80, "lshrs.download": 80}
    assert round(t.total["lshrs.serve"].host_s * 1e9) == 800
    assert total["lshrs.hash"] == _ns(t.inner["lshrs.hash"])  # no span inside it
    # Every operation and every idle nanosecond lands in exactly one inner row.
    assert sum(r.device_s for r in t.inner.values()) == pytest.approx(460e-9)
    assert sum(r.idle_s for r in t.inner.values()) == pytest.approx(540e-9)


def test_operations_before_the_window_are_clipped_as_summarize_clips_them():
    t = spans.attribute([(-50, 20, "early", 1)], {1: -60}, [(-100, 40, "lshrs.serve")], (0, 100))
    assert _ns(t.inner["lshrs.serve"]) == (20, 0, 1, 20)
    assert _ns(t.inner[spans.OUTSIDE]) == (0, 0, 0, 60)
    assert t.inner["lshrs.serve"].host_s == pytest.approx(40e-9)


def test_a_gap_across_a_request_boundary_is_divided_by_overlap():
    # One gap, 100-200: the end of one request's download, the harness, the
    # start of the next request's hash. Moving the boundary by a little
    # moves the idle time by as little (a midpoint rule would hand all of
    # it to one side).
    for cut in (140, 160):
        spans_ = [(0, 130, "lshrs.serve"), (50, 130, "lshrs.download"),
                  (cut, 300, "lshrs.serve"), (cut, 250, "lshrs.hash")]
        t = spans.attribute([(0, 100, "k", 1), (200, 300, "k", 2)], {1: 10, 2: 250}, spans_,
                            (0, 300))
        idle = {k: round(v.idle_s * 1e9) for k, v in t.inner.items() if v.idle_s}
        assert idle == {"lshrs.download": 30, spans.OUTSIDE: cut - 130, "lshrs.hash": 200 - cut}
        assert round(t.total["lshrs.serve"].idle_s * 1e9) == 30 + 200 - cut


def test_summarize_of_the_same_events_is_unchanged():
    """`devtrace.summarize` reads these events as it did before the split
    existed: the values are pinned."""
    device = [(s, e, n) for s, e, n, _ in DEVICE]
    host = [(60, 1000, "request")] + SPANS + [(s, e, n) for s, e, n, _ in LAUNCHES]
    t = devtrace.summarize(device, host, WINDOW)
    assert t.window_s == pytest.approx(1000e-9) and t.busy_s == pytest.approx(460e-9)
    assert {k: (round(s * 1e9), n) for k, (s, n) in t.ops.items()} == {
        UP: (40, 1), "mm": (60, 1), B2: (150, 1), "radix": (60, 1), "elementwise": (40, 1),
        DOWN: (30, 1), "harness": (30, 1), "mystery": (50, 1)}
    assert {k: round(v * 1e9) for k, v in t.gaps.items()} == {
        "(no host event)": 60, "lshrs.serve": 140, "lshrs.hash": 20, "lshrs.engine": 230,
        "lshrs.download": 40, "request": 50}
    bd = t.breakdown()
    assert [n for n, _ in bd["device_ops"]][:4] == [B2, "mm", "radix", "mystery"]
    assert bd["idle_gaps"][0] == ["lshrs.engine", pytest.approx(230e-9)]


NEW = ["hash_ms.batch", "select_ms.batch", "refine_ms.batch", "topk_ms.batch",
       "serve_idle_ms.batch"]


def _run(split, ops=None) -> Run:
    r = Run(cell=harness.resolve(SPEC, "glove100.batch", ROOT), counts={"requests": 2})
    r.trace = devtrace.DeviceTrace(window_s=1.0, busy_s=0.5, ops={B2: [0.1, 2]} if ops is None
                                   else ops)
    r.spans = split
    return r


def _read(metric: str, run: Run):
    return harness.reader(ROOT, metric).read(run)


def test_the_five_readers():
    t = _split()
    t.names.add("lshrs.refine")
    t.total["lshrs.refine"] = spans.Row(device_s=0.008, copy_s=0.001, ops=9, idle_s=0.5)
    r = _run(t)
    assert _read("hash_ms.batch", r) == pytest.approx((100 - 40) * 1e-6 / 2)
    assert _read("select_ms.batch", r) == pytest.approx(60 * 1e-6 / 2)
    assert _read("refine_ms.batch", r) == pytest.approx(3.5)
    assert _read("serve_idle_ms.batch", r) == pytest.approx(420 * 1e-6 / 2)
    # A span the window holds that launched nothing reads 0; one it lacks
    # (lshrs.topk here) reads nothing.
    assert _read("topk_ms.batch", r) is None
    t.names.add("lshrs.topk")
    assert _read("topk_ms.batch", r) == 0.0


def test_the_five_readers_read_nothing_without_spans_or_a_trace():
    for split in (None, spans.SpanTrace()):
        r = _run(split)
        assert all(_read(m, r) is None for m in NEW)
    r = _run(_split())
    r.trace = None
    assert all(_read(m, r) is None for m in NEW)
    r = _run(_split(), ops={})  # no device operation: nothing to split
    assert all(_read(m, r) is None for m in NEW)


def test_the_new_metrics_are_listed_for_the_batch_cell():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "device_trace" and m["moves"] == "qps"
        assert m["workloads"] == ["glove100.batch"] and m["unit"] == "ms"
    cell = harness.resolve(SPEC, "glove100.batch", ROOT)
    assert set(NEW) <= {m["name"] for m in cell.layer_metrics}


def test_the_profiler_is_found_in_the_frame_that_holds_the_run():
    from torch.profiler import profile

    record = _run(None)
    del record.spans
    assert spans._profiler_of(record) is None
    prof = profile()  # noqa: F841  a local of this frame, as in the harness's run
    assert spans._profiler_of(record) is prof


def test_a_cpu_trace_of_the_program_holds_its_spans():
    from lshrs_tpu_torch import LSHRS
    from torch.profiler import record_function

    x = np.random.default_rng(1).standard_normal((500, 16)).astype(np.float32)
    lsh = LSHRS(dim=16, num_perm=64, num_bands=8, rows_per_band=8, engine="hamming",
                device="cpu")
    lsh.index(np.arange(500), x)
    serve = lsh.serving_fn(top_k=5)
    with devtrace.profiler() as prof:
        with record_function(devtrace.WINDOW):
            serve(x[:20])
            serve(x[20:40])
    t = spans.read(prof)
    assert {"lshrs.serve", "lshrs.hash", "lshrs.engine", "lshrs.b2", "lshrs.select",
            "lshrs.refine", "lshrs.topk", "lshrs.download"} <= t.names
    # No device operation on the CPU: the window is one idle gap.
    assert sum(r.ops for r in t.inner.values()) == 0
    assert sum(r.idle_s for r in t.inner.values()) > 0
    assert torch.autograd._profiler_enabled() is False


def test_the_harness_hands_the_five_readers_its_traced_window(monkeypatch):
    """Through `harness.run` itself: each reader finds the window's profiler
    on the harness's stack. The CPU runs no device operation, and without
    one the readers read nothing, so the harness's `DeviceTrace` is given
    one made-up operation."""
    from lshrs_tpu_torch import LSHRS
    from perfbench.tests.test_perfbench_harness import AUTO_SWITCH, tiny

    monkeypatch.setattr(LSHRS, "_AUTO_HAMMING_CAPACITY", AUTO_SWITCH)
    real = devtrace.read

    def read(prof):
        t = real(prof)
        t.ops = {B2: [1e-3, 1]}
        return t

    monkeypatch.setattr(devtrace, "read", read)
    cell = tiny(harness.resolve(SPEC, "glove100.batch", ROOT))
    result = harness.run(cell, seed=2**31 + 11, seconds=0.3, trace=True, device="cpu")
    got = {m: result["metrics"].get(m, {}).get("value") for m in NEW}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["serve_idle_ms.batch"] > 0 and got["refine_ms.batch"] == 0.0


def test_the_split_script_on_the_cpu(monkeypatch, capsys):
    from lshrs_tpu_torch import LSHRS
    from perfbench import split
    from perfbench.tests.proposed import with_proposed
    from perfbench.tests.test_perfbench_harness import AUTO_SWITCH, tiny

    monkeypatch.setattr(LSHRS, "_AUTO_HAMMING_CAPACITY", AUTO_SWITCH)
    cell = tiny(harness.resolve(with_proposed(SPEC), "glove100.build", ROOT))
    out = split.split(cell, seed=5, seconds=0.2, device="cpu")
    assert out["requests"] >= 1 and set(out["inner"]) <= set(out["total"])
    total = out["total"]
    for name in ("lshrs.index", "lshrs.store.append", "lshrs.serve", "lshrs.hash"):
        assert total[name]["host_ms"] > 0 and total[name]["ops"] == 0
    assert total["lshrs.index"]["host_ms"] >= total["lshrs.store.append"]["host_ms"]
    # The idle window (no device operation on the CPU) is all accounted for.
    idle = sum(r["idle_ms"] for r in out["inner"].values()) * out["requests"] / 1e3
    assert idle == pytest.approx(out["window_s"], rel=0.05)
