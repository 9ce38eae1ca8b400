"""Kernel B1's share of its roofline: the frozen ``kernel_bound`` of the
request's work, with C the slots that hold vectors (not the capacity),
over the profiler's B1 time per request."""

from perfbench.devtrace import is_b1
from perfbench.roofline import kernel_bound


def read(run):
    if run.trace is None:
        return None
    sec, calls = run.trace.time(is_b1)
    if not calls:
        return None
    cfg = run.cell.config
    idx = cfg["index"]
    bands = idx["num_bands"] * -(-idx["rows_per_band"] // 32)
    bound_ms, _ = kernel_bound("group_max_keys", {
        "C": cfg["train"], "Q": run.cell.mix["batch"], "bands": bands,
        "probes": idx.get("multiprobe", 1)})
    return 100.0 * bound_ms * 1e-3 * run.counts["requests"] / sec
