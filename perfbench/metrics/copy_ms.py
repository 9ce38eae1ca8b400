"""Device ms per request of host-to-device and device-to-host copies
(the query upload, the ids' download)."""

from perfbench.devtrace import is_copy


def read(run):
    if run.trace is None:
        return None
    sec, calls = run.trace.time(lambda n: is_copy(n, "HtoD") or is_copy(n, "DtoH"))
    return sec * 1e3 / run.counts["requests"] if calls else None
