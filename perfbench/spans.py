"""The program's spans in a traced window: device time, device operations
and card-idle time by ``lshrs.*`` span (`lshrs_tpu_torch.utils.trace`).

A device operation belongs to the innermost ``lshrs.*`` span around the
CUDA API call that launched it (the two events share a
correlation id on the profiler's clock); one with no launch in the trace
goes to ``(unattributed)``, one launched outside every span to
``(outside)``. An idle gap of the card is divided among the innermost
spans it overlaps on the window's thread, each taking the part of the gap
it covers (``(outside)`` the part no span covers), and so is the host's
time in the spans.

Each span is counted twice: ``inner`` holds what lies in it and in none of
its child spans, ``total`` what lies anywhere inside it. The harness of
this version hands a metric reader the `Run` only, so `of` finds the
run's profiler on the harness's stack and reads it once a run.
"""

from __future__ import annotations

import bisect
import math
import sys
from dataclasses import dataclass, field

from perfbench.devtrace import WINDOW, is_copy

__all__ = ["PREFIX", "Row", "SpanTrace", "attribute", "kernel_ms", "of", "read"]

PREFIX = "lshrs."
UNATTRIBUTED = "(unattributed)"
OUTSIDE = "(outside)"


@dataclass
class Row:
    device_s: float = 0.0  # every device operation
    copy_s: float = 0.0  # of which host-to-device and device-to-host copies
    ops: int = 0
    idle_s: float = 0.0
    host_s: float = 0.0  # the window's time the host spent in the span


@dataclass
class SpanTrace:
    names: set[str] = field(default_factory=set)  # the spans the window holds
    inner: dict[str, Row] = field(default_factory=dict)
    total: dict[str, Row] = field(default_factory=dict)


def _row(d: dict, name: str) -> Row:
    row = d.get(name)
    if row is None:
        row = d[name] = Row()
    return row


def _segments(spans: list[tuple[int, int, str]]) -> list[tuple[int, int, list[str]]]:
    """The time the ``spans`` (of one thread, so nested) cover, cut into
    pieces ``(start, end, names)`` over which the spans covering it,
    outermost first, stay the same; in time order."""
    out: list[tuple[int, int, list[str]]] = []
    stack: list[tuple[int, int, str]] = []
    t = -math.inf
    for s0, s1, name in sorted(spans, key=lambda s: (s[0], -s[1])) + [(math.inf, 0, "")]:
        while stack and stack[-1][1] <= s0:
            if stack[-1][1] > t:
                out.append((t, stack[-1][1], [n for _, _, n in stack]))
                t = stack[-1][1]
            stack.pop()
        if stack and s0 > t:
            out.append((t, s0, [n for _, _, n in stack]))
        t = max(t, s0)
        stack.append((s0, s1, name))
    return out


def _add(trace: SpanTrace, names: list[str], sec: float, copy: bool) -> None:
    """One device operation of ``sec`` seconds launched inside ``names``."""
    for row in _rows(trace, names):
        row.device_s += sec
        row.copy_s += sec if copy else 0.0
        row.ops += 1


def _rows(trace: SpanTrace, names: list[str]) -> list[Row]:
    """The rows a point inside ``names`` (outermost first) counts in: the
    innermost's ``inner`` and each name's ``total`` once."""
    return [_row(trace.inner, names[-1])] + [_row(trace.total, n) for n in dict.fromkeys(names)]


def attribute(device: list[tuple[int, int, str, int]], launches: dict[int, int],
              spans: list[tuple[int, int, str]], window: tuple[int, int]) -> SpanTrace:
    """`SpanTrace` of ``device`` operations ``(start_ns, end_ns, name,
    correlation id)``, their ``launches`` (correlation id -> the runtime
    call's start on the window's thread) and the window thread's ``spans``
    ``(start_ns, end_ns, name)``, over ``window``: device time clipped to
    the window, and the idle gaps of the window (as `devtrace.summarize`)."""
    w0, w1 = window
    out = SpanTrace(names={name for _, _, name in spans})
    linked, busy = [], []
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        busy.append((s, e))
        copy = is_copy(name, "HtoD") or is_copy(name, "DtoH")
        at = launches.get(corr)
        if at is None:
            _add(out, [UNATTRIBUTED], (e - s) * 1e-9, copy)
        else:
            linked.append((at, (e - s) * 1e-9, copy))
    segments = _segments(spans)
    starts = [a for a, _, _ in segments]
    for at, sec, copy in linked:
        i = bisect.bisect_right(starts, at) - 1
        _add(out, segments[i][2] if i >= 0 and at <= segments[i][1] else [OUTSIDE], sec, copy)
    busy.sort()
    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    pieces = [(max(a, w0), min(b, w1), names) for a, b, names in segments
              if min(b, w1) > max(a, w0)]
    for a, b, names in pieces:
        for row in _rows(out, names):
            row.host_s += (b - a) * 1e-9
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        covered, k = 0, j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, names = pieces[k]
            part = min(b, g1) - max(a, g0)
            covered += part
            for row in _rows(out, names):
                row.idle_s += part * 1e-9
            k += 1
        if g1 - g0 > covered:
            for row in _rows(out, [OUTSIDE]):
                row.idle_s += (g1 - g0 - covered) * 1e-9
    return out


def _is_launch(name: str) -> bool:
    """A CUDA API call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...)."""
    return name.startswith("cu")


def read(prof) -> SpanTrace | None:
    """The `SpanTrace` of a finished profiler's ``window`` span; None
    when the program recorded no span there."""
    from torch.autograd import DeviceType

    device, launches, spans, host, window, tid = [], {}, [], [], None, None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append((ev.start_ns(), ev.end_ns(), name, ev.correlation_id()))
        elif ev.device_type() == DeviceType.CPU:
            if name == WINDOW:
                window, tid = (ev.start_ns(), ev.end_ns()), ev.start_thread_id()
            elif name.startswith(PREFIX) or _is_launch(name):
                host.append((ev.start_ns(), ev.end_ns(), name, ev.start_thread_id(),
                             ev.correlation_id()))
    if window is None:
        return None
    for s, e, name, t, corr in host:
        if t != tid:
            continue
        if name.startswith(PREFIX):
            spans.append((s, e, name))
        else:
            launches[corr] = s
    if not spans:
        return None
    return attribute(device, launches, spans, window)


def _profiler_of(run):
    """The profiler of the traced window that made ``run``: a local of the
    harness frame that holds ``run`` (None when there is none)."""
    from torch.profiler import profile

    frame = sys._getframe(1)
    while frame is not None:
        local = frame.f_locals
        if any(v is run for v in local.values()):
            for v in local.values():
                if isinstance(v, profile):
                    return v
        frame = frame.f_back
    return None


def of(run) -> SpanTrace | None:
    """The run's `SpanTrace`, read once and kept as ``run.spans``; None
    when the run was not traced, the card ran nothing, or the program
    recorded no span."""
    if run.trace is None or not run.trace.ops:
        return None
    if not hasattr(run, "spans"):
        prof = _profiler_of(run)
        run.spans = read(prof) if prof is not None else None
    return run.spans


def kernel_ms(run, span: str) -> float | None:
    """Device ms a request of the work launched anywhere inside ``span``,
    host-to-device and device-to-host copies left out (`copy_ms` holds
    those); None without the span."""
    t = of(run)
    if t is None or span not in t.names:
        return None
    row = t.total.get(span, Row())
    return (row.device_s - row.copy_s) * 1e3 / run.counts["requests"]
