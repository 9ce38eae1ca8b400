"""Kernel B2's share of its roofline: the frozen ``kernel_bound`` of the
request's work, with C the slots that hold vectors (not the capacity),
over the profiler's B2 time per request (the planes instantiation only)."""

from perfbench.devtrace import is_b2
from perfbench.roofline import kernel_bound

GROUP = 64  # slots per group-max key: the index's default group_size


def read(run):
    if run.trace is None:
        return None
    sec, calls = run.trace.time(is_b2)
    if not calls:
        return None
    cfg = run.cell.config
    bound_ms, _ = kernel_bound("hamming_group_max_keys", {
        "C": cfg["train"], "Q": run.cell.mix["batch"], "P": cfg["index"]["num_perm"],
        "group": cfg["index"].get("group_size", GROUP)})
    return 100.0 * bound_ms * 1e-3 * run.counts["requests"] / sec
