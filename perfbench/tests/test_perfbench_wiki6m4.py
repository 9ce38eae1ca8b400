"""CPU tests of the ``wiki6m4.batch`` cell: its configuration, its five
per-layer metrics and the ``merge_ms`` reader of the span ``lshrs.merge``,
on made-up events."""

from __future__ import annotations

from pathlib import Path

import pytest

from perfbench import devtrace, harness, spans
from perfbench.harness import Run
from perfbench.roofline import kernel_bound

ROOT = Path(harness.__file__).resolve().parents[1]
SPEC = harness.load_spec(ROOT)
CELL = "wiki6m4.batch"
LAYER = ["b2_roofline.wiki6m4", "select_ms.wiki6m4", "refine_ms.wiki6m4", "merge_ms.wiki6m4",
         "idle_pct.wiki6m4"]
B2 = "void hamming_group_max_kernel<64, false>(CUtensorMap_st, CUtensorMap_st)"


def test_the_configuration_is_the_upstream_deployment_at_full_scale():
    cell = harness.resolve(SPEC, CELL, ROOT)
    cfg = cell.config
    assert (cfg["train"], cfg["test"], cfg["dim"], cfg["k"]) == (6_400_000, 10_000, 768, 10)
    assert cfg["ranking"] == "hamming" and cfg["index"]["dim"] == cfg["dim"]
    glove = harness.resolve(SPEC, "glove100.batch", ROOT).config
    assert {k: v for k, v in cfg["index"].items() if k != "dim"} == {
        k: v for k, v in glove["index"].items() if k != "dim"}
    assert cfg["data"] == glove["data"]
    entry = next(c for c in SPEC["configs"] if c["name"] == "wiki_6m4")
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    # 2^23 slots: past one B2 launch's int32 key, two blocks of 2^22.
    cap = 1 << (cfg["train"] - 1).bit_length()
    assert cap == 1 << 23 and (cfg["index"]["num_perm"] + 2) * cap >= 2**31
    assert cell.mix == harness.resolve(SPEC, "glove100.batch", ROOT).mix


def test_the_cell_reports_its_metrics():
    cell = harness.resolve(SPEC, CELL, ROOT)
    assert [m["name"] for m in cell.metrics] == ["qps", "p95_ms", "setup_s"]
    assert [m["name"] for m in cell.layer_metrics] == LAYER
    glove = harness.resolve(SPEC, "glove100.batch", ROOT)
    assert not {m["name"] for m in glove.layer_metrics} & set(LAYER)
    assert 0 < cell.limits["mismatch"] < 1


def _run(split) -> Run:
    r = Run(cell=harness.resolve(SPEC, CELL, ROOT), counts={"requests": 4})
    r.trace = devtrace.DeviceTrace(window_s=1.0, busy_s=0.9, ops={B2: [0.2, 8]})
    r.spans = split
    return r


def _read(metric: str, run: Run):
    return harness.reader(ROOT, metric).read(run)


def test_the_merge_reader_and_the_family_readers():
    t = spans.SpanTrace(names={"lshrs.merge", "lshrs.select", "lshrs.refine"})
    t.total["lshrs.merge"] = spans.Row(device_s=0.002, ops=12)
    t.total["lshrs.select"] = spans.Row(device_s=0.05, ops=40)
    t.total["lshrs.refine"] = spans.Row(device_s=0.04, copy_s=0.004, ops=60)
    r = _run(t)
    assert _read("merge_ms.wiki6m4", r) == pytest.approx(0.5)
    assert _read("select_ms.wiki6m4", r) == pytest.approx(12.5)
    assert _read("refine_ms.wiki6m4", r) == pytest.approx(9.0)
    assert _read("idle_pct.wiki6m4", r) == pytest.approx(10.0)
    bound_ms, _ = kernel_bound("hamming_group_max_keys",
                               {"C": 6_400_000, "Q": 10_000, "P": 256, "group": 64})
    # B2's time summed over both blocks' launches, per request.
    assert _read("b2_roofline.wiki6m4", r) == pytest.approx(100 * bound_ms / 50.0)


def test_the_merge_reader_reads_nothing_where_the_program_has_no_merge():
    # A program without the span (a store of one block, or the chunked route).
    t = spans.SpanTrace(names={"lshrs.select"})
    assert _read("merge_ms.wiki6m4", _run(t)) is None
    assert _read("merge_ms.wiki6m4", _run(None)) is None
    r = _run(t)
    r.trace = None
    for m in LAYER:
        assert _read(m, r) is None
