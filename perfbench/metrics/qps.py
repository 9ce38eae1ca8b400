"""Queries whose ids reached the host in the window, per second of it."""


def read(run):
    q = run.counts.get("queries")
    return q / run.window_s if q else None
