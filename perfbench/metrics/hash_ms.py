"""Device ms per request of the query hash, the work launched inside the
program's span ``lshrs.hash`` (the projection and the bitpack; the
query's upload is a host copy and left out)."""

from perfbench.spans import kernel_ms


def read(run):
    return kernel_ms(run, "lshrs.hash")
