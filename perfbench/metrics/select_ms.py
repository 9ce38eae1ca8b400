"""Device ms per request of the group selection, the work launched inside
the program's span ``lshrs.select`` (``torch.topk`` over the group maxima
of kernel B1 or B2)."""

from perfbench.spans import kernel_ms


def read(run):
    return kernel_ms(run, "lshrs.select")
