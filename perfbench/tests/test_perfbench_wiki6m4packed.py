"""CPU tests of the ``wiki6m4packed.batch`` cell: its configuration (the
``wiki6m4.batch`` deployment on packed words), its per-layer metrics, the
index budget's arithmetic and the ``b3_roofline`` reader on made-up
events."""

from __future__ import annotations

from pathlib import Path

import pytest

from perfbench import devtrace, harness, spans
from perfbench.harness import Run
from perfbench.roofline import kernel_bound

ROOT = Path(harness.__file__).resolve().parents[1]
SPEC = harness.load_spec(ROOT)
CELL = "wiki6m4packed.batch"
LAYER = ["b3_roofline.wiki6m4packed", "select_ms.wiki6m4packed", "merge_ms.wiki6m4packed",
         "idle_pct.wiki6m4packed"]
B2 = "void hamming_group_max_kernel<64, false>(CUtensorMap_st, CUtensorMap_st, Params)"
B3 = "void hamming_group_max_kernel<64, true>(CUtensorMap_st, CUtensorMap_st, Params)"
BUDGET = 2 * 1024**3  # requirements.md:76, "hash tables < 2 GB"


def test_the_configuration_is_wiki_6m4_on_packed_words():
    cfg = harness.resolve(SPEC, CELL, ROOT).config
    wiki = harness.resolve(SPEC, "wiki6m4.batch", ROOT).config
    assert cfg["index"] == {**wiki["index"], "hamming_storage": "packed",
                            "device_budget_bytes": BUDGET}
    assert f"{BUDGET:,}" in cfg["guarantees"]
    for key in ("train", "test", "dim", "k", "distance", "ranking", "precision", "data"):
        assert cfg[key] == wiki[key], key
    entry = next(c for c in SPEC["configs"] if c["name"] == "wiki_6m4_packed")
    assert entry["reduced"] == [] and entry["source"] == cfg["source"]
    assert "2 GB" in cfg["guarantees"] and "(:76)" in entry["source"]
    cell = next(w for w in SPEC["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("wiki_6m4_packed", "batch", 1)


def test_the_cell_reports_its_metrics():
    cell = harness.resolve(SPEC, CELL, ROOT)
    assert [m["name"] for m in cell.metrics] == ["qps", "p95_ms", "setup_s"]
    assert [m["name"] for m in cell.layer_metrics] == LAYER
    for other in ("glove100.batch", "wiki6m4.batch"):
        assert not {m["name"] for m in harness.resolve(SPEC, other, ROOT).layer_metrics} & set(LAYER)
    assert cell.mix == harness.resolve(SPEC, "wiki6m4.batch", ROOT).mix
    assert 0 < cell.limits["mismatch"] < 1


def test_the_resident_index_fits_the_budget_at_2_23_slots():
    """The packed store at the cell's capacity: words and their row twin
    (16 words a slot each), ids, ties and block ties, and the refine
    table of 8 narrow words, the tie and the id a slot (16 x 16 bits at
    narrow r = 16); the bitplanes a planes store adds put it past the
    budget."""
    cfg = harness.resolve(SPEC, CELL, ROOT).config
    cap = 1 << (cfg["train"] - 1).bit_length()
    bw = cfg["index"]["num_bands"]
    packed = cap * (4 * bw + 4 * bw + 3 * 4 + 4 * (bw // 2 + 2))
    assert cap == 1 << 23 and packed == 1_509_949_440 and packed <= BUDGET
    planes = packed + cap * cfg["index"]["num_perm"]
    assert planes > BUDGET


def _run(split, ops) -> Run:
    r = Run(cell=harness.resolve(SPEC, CELL, ROOT), counts={"requests": 4})
    r.trace = devtrace.DeviceTrace(window_s=1.0, busy_s=0.9, ops=ops)
    r.spans = split
    return r


def _read(metric: str, run: Run):
    return harness.reader(ROOT, metric).read(run)


def test_b3_roofline_reads_the_packed_instantiation_only():
    t = spans.SpanTrace(names={"lshrs.merge", "lshrs.select"})
    t.total["lshrs.merge"] = spans.Row(device_s=0.002, ops=12)
    t.total["lshrs.select"] = spans.Row(device_s=0.05, ops=40)
    r = _run(t, {B3: [0.16, 8], B2: [9.0, 8]})
    bound_ms, by = kernel_bound("hamming_packed_group_max_keys", {
        "C": 6_400_000, "Q": 10_000, "BW": 16, "word_bits": 16, "group": 64})
    # B3's time summed over both blocks' launches, per request; B2's left out.
    assert by == "operations"
    assert _read("b3_roofline.wiki6m4packed", r) == pytest.approx(100 * bound_ms / 40.0)
    assert _read("select_ms.wiki6m4packed", r) == pytest.approx(12.5)
    assert _read("merge_ms.wiki6m4packed", r) == pytest.approx(0.5)
    assert _read("idle_pct.wiki6m4packed", r) == pytest.approx(10.0)
    assert _read("b3_roofline.wiki6m4packed", _run(t, {B2: [9.0, 8]})) is None


@pytest.mark.parametrize("name,b3", [
    ("void hamming_group_max_kernel<64, true>(CUtensorMap_st, CUtensorMap_st, Params)", True),
    ("void hamming_group_max_kernel<64, (bool)1>(CUtensorMap_st, CUtensorMap_st, Params)", True),
    ("void hamming_group_max_kernel<128, true>(CUtensorMap_st)", True),
    ("void hamming_group_max_kernel<64, false>(CUtensorMap_st, CUtensorMap_st, Params)", False),
    ("void hamming_group_max_kernel<64, (bool)0>(CUtensorMap_st, CUtensorMap_st, Params)", False),
    ("void collision_group_max_kernel<16, 1, 1>(Params)", False),
    ("Memcpy HtoD (Pageable -> Device)", False),
])
def test_the_b3_name_test(name, b3):
    reader = harness.reader(ROOT, "b3_roofline.wiki6m4packed")
    assert reader.is_b3(name) is b3
    assert devtrace.is_b2(name) is (not b3 and "hamming_group_max_kernel" in name)


def test_the_readers_read_nothing_without_a_trace():
    r = _run(spans.SpanTrace(names=set()), {})
    r.trace = None
    for m in LAYER:
        assert _read(m, r) is None
