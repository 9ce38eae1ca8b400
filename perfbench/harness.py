"""One run of one cell: make the data from the seed, let the cell's client
build and warm the index, measure its closed loop for the window, then hold
what the window answered to the plain reference and print one line.

Everything a cell needs is found by name under ``<root>/perfbench``; see
the package docstring.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from perfbench import devtrace
from perfbench.data import make_data
from perfbench.reference import lsh as reference

__all__ = ["Cell", "Reservoir", "Run", "forbidden_modules", "load_spec", "resolve", "run"]

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names that must not be loaded in a run's process.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "lshrs_tpu"})


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    metrics: list  # the end-to-end entries this cell reports
    layer_metrics: list  # the per-layer entries it reports
    root: Path


@dataclass
class Run:
    """What one run measured: what the metric readers read."""

    cell: Cell
    setup_s: float = 0.0
    window_s: float = 0.0
    latencies_s: list = field(default_factory=list)
    counts: dict = field(default_factory=dict)  # requests, queries, vectors
    trace: devtrace.DeviceTrace | None = None


class Reservoir:
    """A uniform sample of at most ``size`` of the items offered, drawn
    from ``seed``: the answers a run keeps for its check."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self._rng = np.random.default_rng(seed % (1 << 64))

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self._rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def resolve(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration, traffic mix,
    limits and metric entries."""
    try:
        w = next(w for w in spec["workloads"] if w["name"] == name)
    except StopIteration:
        raise SystemExit(f"unknown workload {name!r}") from None
    entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    bench = root / "perfbench"
    return Cell(name=name, chips=w["chips"], config=_json(root / entry["file"]),
                mix=_json(bench / "traffic" / f"{w['traffic']}.json"),
                limits=_json(bench / "checks" / f"{name}.json")["limits"],
                metrics=e2e, layer_metrics=layer, root=root)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(f"perfbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    """``metrics/<metric>.py``, else the family's ``metrics/<prefix>.py``
    (``idle_pct.batch`` -> ``idle_pct.py``)."""
    d = root / "perfbench" / "metrics"
    path = d / f"{metric}.py"
    if not path.exists():
        path = d / f"{metric.split('.')[0]}.py"
    return load_module(path)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _card(device) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        info["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        pass
    return info


def _check(cell: Cell, train, test, kept, device, *, control: bool) -> dict:
    """The window's answers against the reference's, by the share of
    queries whose ids differ (and, with ``control``, the TF32 control's).
    With nothing kept (no request answered) every answer is missing."""
    if kept is None:
        return {"mismatch": 1.0, "compared": 0, "control_mismatch": None}
    pool_name, idx, got = kept
    pool = {"train": train, "test": test}[pool_name]
    uniq, inv = np.unique(idx, return_inverse=True)
    kw = dict(ranking=cell.config["ranking"], k=cell.mix["top_k"], device=device)
    truth = reference.answers(cell.config["index"], train, pool[uniq], precision="float64", **kw)
    out = {"mismatch": reference.mismatch(got, truth[inv]), "compared": int(len(idx))}
    if control:
        ctrl = reference.answers(cell.config["index"], train, pool[uniq], precision="tf32", **kw)
        out["control_mismatch"] = reference.mismatch(ctrl[inv], truth[inv])
    return out


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device="cuda",
        t0: float | None = None, control: bool = False) -> dict:
    """One run of ``cell``; returns the result line as a dict."""
    import torch
    from torch.profiler import record_function

    t0 = time.perf_counter() if t0 is None else t0
    parts = [time.perf_counter()]
    client = load_module(cell.root / "perfbench" / "clients" / f"{cell.mix['client']}.py")
    train, test = make_data(cell.config, seed, device)
    parts.append(time.perf_counter())
    state = client.setup(cell, train, test, seed, device)
    parts.append(time.perf_counter())
    if trace:  # the profiler's first use starts the tracer: not in the window
        with devtrace.profiler():
            torch.ones(1, device=device).add_(1)
            _sync(device)
    _sync(device)
    gc.collect()
    record = Run(cell=cell, setup_s=time.perf_counter() - t0)
    print(f"setup {record.setup_s:.3f} s: before the run {parts[0] - t0:.3f}, data "
          f"{parts[1] - parts[0]:.3f}, index and warm-up {parts[2] - parts[1]:.3f}",
          file=sys.stderr, flush=True)
    counts = {"requests": 0}
    failed = 0
    prof = devtrace.profiler() if trace else nullcontext()
    with prof:
        with record_function(devtrace.WINDOW):
            start = time.perf_counter()
            while True:
                ts = time.perf_counter()
                try:
                    done = client.request(state, counts["requests"])
                except Exception:  # a request that fails counts, and the loop goes on
                    if not failed:
                        traceback.print_exc()
                    failed, done = failed + 1, {}
                te = time.perf_counter()
                counts["requests"] += 1
                for k, v in done.items():
                    counts[k] = counts.get(k, 0) + v
                if done:
                    record.latencies_s.append(te - ts)
                if te - start >= seconds:
                    break
        _sync(device)
    record.window_s, record.counts = te - start, counts
    card = _card(device)
    kept = client.answers(state)
    client.close(state)
    del state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checked = _check(cell, train, test, kept, device, control=control)
    metrics = {}
    if trace:
        record.trace = devtrace.read(prof)
        card.update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)
    for m in cell.layer_metrics if trace else cell.metrics:
        value = reader(cell.root, m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limit = cell.limits["mismatch"]
    checks = {"mismatch": {"value": checked["mismatch"], "limit": limit},
              "failed": {"value": failed, "limit": 0}}
    result = {
        "correct": failed == 0 and counts["requests"] > 0 and checked["mismatch"] <= limit,
        "attempted": counts["requests"], "failed": failed, "metrics": metrics, "device": card,
    }
    if trace:
        result["breakdown"] = record.trace.breakdown()
    if control:
        result["control_mismatch"] = checked["control_mismatch"]
    result["compared"] = checked["compared"]
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
