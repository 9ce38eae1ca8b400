"""Share of the card's busy time spent in host-to-device copies."""

from perfbench.devtrace import is_copy


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    sec, calls = t.time(lambda n: is_copy(n, "HtoD"))
    return 100.0 * sec / t.busy_s if calls else None
