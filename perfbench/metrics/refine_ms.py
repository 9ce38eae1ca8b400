"""Device ms per request of the refine, the work launched inside the
program's span ``lshrs.refine`` (the selected groups' gather, then the
popcount or the recount against the queries)."""

from perfbench.spans import kernel_ms


def read(run):
    return kernel_ms(run, "lshrs.refine")
