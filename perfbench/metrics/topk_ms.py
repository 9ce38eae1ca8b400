"""Device ms per request of the final top-k, the work launched inside the
program's span ``lshrs.topk`` (the refined candidates' keys and their
exact top-k)."""

from perfbench.spans import kernel_ms


def read(run):
    return kernel_ms(run, "lshrs.topk")
