"""Device kernels launched per request (copies and memsets not counted)."""

from perfbench.devtrace import is_kernel


def read(run):
    if run.trace is None:
        return None
    _, calls = run.trace.time(is_kernel)
    return calls / run.counts["requests"] if calls else None
