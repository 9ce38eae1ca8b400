"""Share of the traced window in which no kernel, copy or memset runs on
the card."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
