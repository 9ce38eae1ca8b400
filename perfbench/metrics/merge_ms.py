"""Device ms per request of the exact merge of per-block (or per-shard)
Hamming lists, the work launched inside the program's span
``lshrs.merge``."""

from perfbench.spans import kernel_ms


def read(run):
    return kernel_ms(run, "lshrs.merge")
