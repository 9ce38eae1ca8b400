"""Kernel B3's share of its roofline: the frozen ``kernel_bound`` of the
request's work, with C the slots that hold vectors (not the capacity),
over the profiler's B3 time per request (the packed-words instantiation
only, every block's launch)."""

from perfbench.roofline import kernel_bound

GROUP = 64  # slots per group-max key: the index's default group_size


def is_b3(name: str) -> bool:
    """Kernel B3, ``csrc/hamming_packed_group_max.cu``: the packed
    instantiation of ``csrc/hamming_wgmma.cuh``'s kernel,
    ``hamming_group_max_kernel<G, true>`` (B2 is ``<G, false>``)."""
    head, sep, rest = name.partition("hamming_group_max_kernel<")
    args = rest.split(">")[0]
    return bool(sep) and ("true" in args or "(bool)1" in args)


def read(run):
    if run.trace is None:
        return None
    sec, calls = run.trace.time(is_b3)
    if not calls:
        return None
    cfg = run.cell.config
    index = cfg["index"]
    rows = index["rows_per_band"]
    # The store's words: one per band up to 32 rows, B3 expanding the low
    # min(rows, 32) bits of each.
    bound_ms, _ = kernel_bound("hamming_packed_group_max_keys", {
        "C": cfg["train"], "Q": run.cell.mix["batch"],
        "BW": index["num_bands"] * -(-rows // 32), "word_bits": min(rows, 32),
        "group": index.get("group_size", GROUP)})
    return 100.0 * bound_ms * 1e-3 * run.counts["requests"] / sec
