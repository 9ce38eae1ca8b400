"""CPU tests of the harness: the spec, each cell's client and readers at
tiny sizes on the kernels' plain versions, picking up new files by name,
the result line, and what the harness may import."""

from __future__ import annotations

import ast
import copy
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from perfbench import devtrace, harness
from perfbench.harness import Reservoir, Run
from perfbench.tests.proposed import with_proposed

ROOT = Path(harness.__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
SPEC = harness.load_spec(ROOT)


FULL = with_proposed(SPEC)
CELLS = [w["name"] for w in FULL["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# Tiny sizes: the collision cells' capacity (the index's initial 2^14)
# stays below the auto engine's switch, lowered to 2^15, and the Hamming
# cells' (2^15) reach it.
TINY_TRAIN = {"collision": 3000, "hamming": 20000}
AUTO_SWITCH = 1 << 15


def tiny(cell: harness.Cell) -> harness.Cell:
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


def test_spec_is_well_formed():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "perfbench/run.py"] and SPEC["paths"] == ["perfbench"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["reduced"] == []
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
    pairs = {(w["config"], w["traffic"]) for w in FULL["workloads"]}
    assert len(pairs) == len(FULL["workloads"])
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [w["name"] for w in SPEC["workloads"]])
    layers = {m["layer"] for m in SPEC["per_layer"]}
    perf = (ROOT / "PERF.md").read_text()
    assert all(f"`{layer}`" in perf for layer in layers), "each layer is named in PERF.md"


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.resolve(FULL, name, ROOT)
    assert (BENCH / "clients" / f"{cell.mix['client']}.py").is_file()
    assert cell.metrics and any(m["name"] == "setup_s" for m in cell.metrics)
    assert len(cell.metrics) >= 2 and cell.layer_metrics
    for m in cell.metrics + cell.layer_metrics:
        assert callable(harness.reader(ROOT, m["name"]).read)
    assert 0 < cell.limits["mismatch"] < 1


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_and_checks_on_the_cpu(name, small_switch):
    cell = tiny(harness.resolve(FULL, name, ROOT))
    result = harness.run(cell, seed=2**31 + 7, seconds=0.3, trace=False, device="cpu")
    assert result["correct"], result
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.metrics}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert result["checks"]["mismatch"]["value"] <= result["checks"]["mismatch"]["limit"]


def test_a_traced_run_on_the_cpu_reports_nothing_it_cannot_read(small_switch):
    cell = tiny(harness.resolve(SPEC, "glove100.batch", ROOT))
    result = harness.run(cell, seed=11, seconds=0.3, trace=True, device="cpu")
    # No device operation on the CPU: every per-layer reader returns nothing.
    assert result["metrics"] == {} and result["device"]["busy_s"] == 0
    assert result["breakdown"]["device_ops"] == [] and result["correct"]


def test_result_line_and_check_lines(capsys):
    result = {"correct": True, "attempted": 3, "failed": 0, "metrics": {},
              "device": {"platform": "gpu"}, "compared": 30,
              "checks": {"mismatch": {"value": 0.0, "limit": 0.01},
                         "failed": {"value": 0, "limit": 0}}}
    harness.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-2:] == ["check mismatch 0.0 limit 0.01",
                                            "check failed 0 limit 0"]


def _tree_digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode() + p.read_bytes())
    return h.hexdigest()


def test_a_new_cell_config_and_metric_are_found_by_name(tmp_path, small_switch):
    """A later PR adds a configuration, a traffic mix, a cell's limit and a
    metric reader as new files and entries; no file that is there changes."""
    before = _tree_digest(BENCH)
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = copy.deepcopy(SPEC)
    cfg = json.loads((BENCH / "configs" / "coco_i2i_512.json").read_text())
    cfg.update(dim=64, train=2500, test=120)
    cfg["index"] = dict(cfg["index"], dim=64)
    (tmp_path / "perfbench/configs/dummy_64.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench/traffic/dummy_mix.json").write_text(
        json.dumps({"client": "queries", "batch": 40, "top_k": 5, "keep": 2}))
    (tmp_path / "perfbench/checks/dummy.cell.json").write_text(
        json.dumps({"limits": {"mismatch": 0.01}}))
    (tmp_path / "perfbench/metrics/requests_done.py").write_text(
        "def read(run):\n    return run.counts['requests']\n")
    spec["configs"].append({"name": "dummy_64", "source": "test", "file":
                            "perfbench/configs/dummy_64.json", "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_64",
                              "traffic": "dummy_mix", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "qps":
            m["workloads"].append("dummy.cell")
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "bound": 0.01, "source": "host_clock",
                               "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.resolve(harness.load_spec(tmp_path), "dummy.cell", tmp_path)
    result = harness.run(cell, seed=3, seconds=0.3, trace=False, device="cpu")
    assert result["correct"]
    assert set(result["metrics"]) == {"qps", "setup_s", "requests_done"}
    assert result["metrics"]["requests_done"]["value"] == result["attempted"]
    assert _tree_digest(BENCH) == before


FORBIDDEN_IMPORTS = {"jax", "jaxlib", "flax", "lshrs_tpu", "bench", "bench_cuda",
                     "chip_smoke", "benchmarks"}


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_old_bench_scripts(path):
    assert not _imports(path) & FORBIDDEN_IMPORTS


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "contextlib", "numpy", "torch"}


def test_the_import_scan_compares_whole_top_level_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import lshrs_tpu_torch.ops\nfrom lshrs_tpu_torch import LSHRS\n")
    assert not _imports(p) & FORBIDDEN_IMPORTS
    p.write_text("import lshrs_tpu.core\n")
    assert _imports(p) & FORBIDDEN_IMPORTS == {"lshrs_tpu"}


def test_forbidden_modules_in_the_process(monkeypatch):
    import lshrs_tpu_torch  # noqa: F401

    assert harness.forbidden_modules() == [] or "lshrs_tpu" not in sys.modules
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
    assert "lshrs_tpu_torch" not in harness.forbidden_modules()


def test_the_command_refuses_to_run_without_a_card():
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def test_the_command_refuses_to_run_without_the_program(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "lshrs_tpu_torch" in proc.stderr


def test_reservoir_is_seeded_and_bounded():
    a, b, c = Reservoir(4, 9), Reservoir(4, 9), Reservoir(50, 9)
    for i in range(100):
        a.offer(i)
        b.offer(i)
    for i in range(30):
        c.offer(i)
    assert a.items == b.items and len(a.items) == 4 and len(set(a.items)) == 4
    assert a.items != [0, 1, 2, 3] and c.items == list(range(30))


# -- the trace's arithmetic and the per-layer readers, on made-up events ----

B1 = "void collision_group_max_kernel<16, 1, 1>(Args)"
B2 = "void hamming_group_max_kernel<64, false>(CUtensorMap_st, CUtensorMap_st)"
B3 = "void hamming_group_max_kernel<64, true>(CUtensorMap_st, CUtensorMap_st)"
UP = "Memcpy HtoD (Pageable -> Device)"
DOWN = "Memcpy DtoH (Device -> Pageable)"


def test_summarize_busy_ops_and_idle_gaps():
    device = [(100, 200, UP), (150, 300, B1), (400, 500, "topk"), (0, 50, "before window")]
    host = [(60, 1000, "request"), (320, 380, "aten::topk"), (330, 350, "cudaLaunchKernel")]
    t = devtrace.summarize(device, host, (60, 1000))
    assert t.busy_s == pytest.approx(300e-9)  # 100-300 and 400-500
    assert t.window_s == pytest.approx(940e-9)
    assert t.ops[B1] == [pytest.approx(150e-9), 1] and "before window" not in t.ops
    # gaps: 60-100 (request), 300-400 (mid 350: the launch), 500-1000 (request)
    assert t.gaps == {"request": pytest.approx(540e-9), "cudaLaunchKernel": pytest.approx(100e-9)}
    bd = t.breakdown()
    assert bd["device_ops"][0] == [B1, pytest.approx(150e-9)] and len(bd["idle_gaps"]) == 2


def test_kernel_names():
    assert devtrace.is_b1(B1) and not devtrace.is_b1(B2)
    assert devtrace.is_b2(B2) and not devtrace.is_b2(B3) and not devtrace.is_b2(B1)
    assert devtrace.is_copy(UP, "HtoD") and devtrace.is_copy(DOWN, "DtoH")
    assert not devtrace.is_kernel(UP) and devtrace.is_kernel(B3)


def _run(name: str, ops: dict, busy: float, requests: int = 4) -> Run:
    cell = harness.resolve(FULL, name, ROOT)
    r = Run(cell=cell, counts={"requests": requests})
    r.trace = devtrace.DeviceTrace(window_s=1.0, busy_s=busy, ops=ops)
    return r


def _read(metric: str, run: Run):
    return harness.reader(ROOT, metric).read(run)


def test_per_layer_readers():
    from perfbench.roofline import kernel_bound

    ops = {B1: [0.012, 4], B2: [0.02, 4], B3: [1.0, 1], UP: [0.004, 4], DOWN: [0.002, 4],
           "topk": [0.008, 40], "Memset (Device)": [0.001, 4]}
    r = _run("coco512.batch", ops, busy=0.8)
    cfg = r.cell.config
    b1_ms, _ = kernel_bound("group_max_keys", {"C": cfg["train"], "Q": 10000, "bands": 16,
                                               "probes": 1})
    assert _read("b1_roofline", r) == pytest.approx(100 * b1_ms / 3.0)
    assert _read("idle_pct.batch", r) == pytest.approx(20.0)
    assert _read("copy_ms.batch", r) == pytest.approx(1.5)
    assert _read("other_ms.batch", r) == pytest.approx((0.008 + 0.001 + 1.0) * 1e3 / 4)
    assert _read("launches.single", r) == pytest.approx((4 + 4 + 1 + 40) / 4)
    assert _read("copy_pct.build", r) == pytest.approx(100 * 0.004 / 0.8)
    g = _run("glove100.batch", ops, busy=0.8)
    b2_ms, _ = kernel_bound("hamming_group_max_keys", {"C": 1183514, "Q": 10000, "P": 256,
                                                       "group": 64})
    assert _read("b2_roofline", g) == pytest.approx(100 * b2_ms / 5.0)


def test_readers_return_nothing_without_their_events():
    r = _run("coco512.batch", {"topk": [0.01, 3]}, busy=0.01)
    for m in ("b1_roofline", "b2_roofline", "copy_ms.batch", "copy_pct.build"):
        assert _read(m, r) is None
    r.trace = None
    for m in [x["name"] for x in FULL["per_layer"]]:
        assert _read(m, r) is None


def test_end_to_end_readers():
    cell = harness.resolve(FULL, "coco512.batch", ROOT)
    r = Run(cell=cell, setup_s=7.5, window_s=2.0,
            latencies_s=list(np.linspace(0.01, 0.02, 101)), counts={"requests": 101,
                                                                    "queries": 1010000})
    assert _read("qps", r) == pytest.approx(505000)
    assert _read("p95_ms", r) == pytest.approx(19.5)
    assert _read("setup_s", r) == 7.5 and _read("build_vectors_per_s", r) is None
