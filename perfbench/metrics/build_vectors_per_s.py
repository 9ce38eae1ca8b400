"""Train vectors made servable in the window, per second of it."""


def read(run):
    v = run.counts.get("vectors")
    return v / run.window_s if v else None
