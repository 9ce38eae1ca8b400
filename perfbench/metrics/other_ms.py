"""Device ms per request of everything on the card that is neither kernel
B1 or B2 nor a host copy: the query hash, group selection, refine, final
top-k (and device-to-device copies and memsets)."""

from perfbench.devtrace import is_b1, is_b2, is_copy


def _other(name):
    return not (is_b1(name) or is_b2(name) or is_copy(name, "HtoD") or is_copy(name, "DtoH"))


def read(run):
    if run.trace is None:
        return None
    sec, calls = run.trace.time(_other)
    return sec * 1e3 / run.counts["requests"] if calls else None
