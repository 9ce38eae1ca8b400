"""Seconds from the process's start to the first timed request: imports,
the kernel build (or its cache), the data, the index build, the warm-up."""


def read(run):
    return run.setup_s
