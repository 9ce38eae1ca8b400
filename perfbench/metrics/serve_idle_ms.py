"""Card-idle ms per request while the host was inside the program's
serving closure: the parts of the idle gaps that the span ``lshrs.serve``
covers (the rest of the idle time falls between requests)."""

from perfbench.spans import of


def read(run):
    t = of(run)
    if t is None or "lshrs.serve" not in t.names:
        return None
    row = t.total.get("lshrs.serve")
    return (row.idle_s if row else 0.0) * 1e3 / run.counts["requests"]
